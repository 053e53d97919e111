"""generator_share_pct: the corruption generators' share of a sweep cell:
the stream time of the port's ``sweep.generate`` spans over that of their
``sweep.cell`` spans, over the traced stretch. Stream time is the time
between CUDA events recorded at a span's entry and exit, idle included:
the time the phase holds the stream. None without the port's spans."""

from harness import spans


def read(ctx):
    return spans.stream_share_pct(("sweep.generate",), "sweep.cell")
