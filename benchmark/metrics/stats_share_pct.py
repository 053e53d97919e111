"""stats_share_pct: the share of a sweep cell taken by its statistics (the
logit metrics' AUROCs, ODIN's and the Mahalanobis distance's, and the
host reads of the results): the stream time of the port's ``sweep.stats``
spans over that of their ``sweep.cell`` spans, over the traced stretch.
None without the port's spans."""

from harness import spans


def read(ctx):
    return spans.stream_share_pct(("sweep.stats",), "sweep.cell")
