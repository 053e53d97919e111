"""host_reads_per_call: the port's device-to-host reads (``.cpu()``,
``float()`` through ``profiling.host_read``; each waits for the work
queued before it) a sweep cell or an ``apply_all_transformations`` call:
the reads counted under the root spans (``sweep.cell``,
``apply_all.call``) over the count of those spans, over the traced
stretch. A count: the tracer's slowdown does not move it. None without the
port's counter."""

from harness import spans


def read(ctx):
    kind = ctx["work"].get("kind")
    root = {"sweep": "sweep.cell", "transform": "apply_all.call"}.get(kind)
    return spans.reads_per_root(root) if root else None
