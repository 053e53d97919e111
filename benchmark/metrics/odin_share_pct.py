"""odin_share_pct: ODIN's share of a sweep cell (its input-gradient
backward and perturbed forward, each batch): the stream time of the port's
``sweep.odin`` spans over that of their ``sweep.cell`` spans, over the
traced stretch. None without the port's spans."""

from harness import spans


def read(ctx):
    return spans.stream_share_pct(("sweep.odin",), "sweep.cell")
