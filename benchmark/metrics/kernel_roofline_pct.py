"""kernel_roofline_pct: the traced transform calls' least time over the
time the card was busy with them. A call's least time is the larger of its
bytes (each input byte once, each output byte once) over 3.35 TB/s and the
operations its transform needs over 67 TFLOP/s (``harness.roofline``): the
transform's work, whatever kernels do it. The busy time is the union of
the device intervals of the traced stretch."""


def read(ctx):
    w, t = ctx["work"], ctx["trace"]
    if w.get("kind") != "transform" or not t.get("busy_s") or "least_s" not in w:
        return None
    return 100.0 * w["least_s"] / t["busy_s"]
