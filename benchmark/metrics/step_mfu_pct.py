"""step_mfu_pct: the whole traced stretch's share of the card's peak: the
transform calls' least time (the larger roof of each call, bytes over
3.35 TB/s or operations over 67 TFLOP/s, ``harness.roofline``) over the
stretch's length, idle time included. It is ``kernel_roofline_pct`` times
the busy share, and names no kernel: a change that takes a kernel off the
path still reads here."""


def read(ctx):
    w, t = ctx["work"], ctx["trace"]
    if w.get("kind") != "transform" or not t.get("window_s") or "least_s" not in w:
        return None
    return 100.0 * w["least_s"] / t["window_s"]
