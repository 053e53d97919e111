"""What the port's own spans and host-read counter recorded in the traced
stretch (``imagetransformations_tpu_torch.utils.profiling``: spans and
reads record only while a profiler runs, so the stretch is all they hold),
for the per-layer readers of ``metrics/`` that read them.

Each function returns None where nothing was recorded: a CPU run (no
stream times), a cell whose entry has no such span, or a port whose
``profiling`` has no ``recorded()``."""

from __future__ import annotations


def recorded() -> dict | None:
    """The port's ``profiling.recorded()``, or None."""
    try:
        from imagetransformations_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "recorded", None)
    return read() if read is not None else None


def stream_share_pct(parts: tuple[str, ...], root: str) -> float | None:
    """100 x the stream time of the spans named in ``parts`` under roots
    named ``root``, over the stream time of those roots."""
    rec = recorded()
    if not rec:
        return None
    spans = rec["spans"]
    whole = [s["stream_ms"] for s in spans if s["name"] == root and s["parent"] is None]
    part = [s["stream_ms"] for s in spans if s["name"] in parts and s["root_name"] == root]
    if not whole or None in whole or None in part or not sum(whole):
        return None
    return 100.0 * sum(part) / sum(whole)


def reads_per_root(root: str) -> float | None:
    """Host reads made under roots named ``root``, over those roots."""
    rec = recorded()
    if not rec:
        return None
    roots = sum(1 for s in rec["spans"] if s["name"] == root and s["parent"] is None)
    if not roots:
        return None
    return sum(1 for r in rec["reads"] if r["root_name"] == root) / roots
