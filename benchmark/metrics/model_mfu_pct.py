"""model_mfu_pct: the models' share of the card's f32 peak over the
sweep's traced cells. FLOPs = 2 a multiply-add (``macs_per_image`` of the
reference network at set-up) x the forwards an image takes (4 with ODIN:
the features forward, ODIN's forward, its input gradient counted as one
forward, its rescoring; else 1) x the images of the traced cells; divided
by the same cells' untraced time (``work["wall_s"]``; tracing adds host
time) and 67 TFLOP/s (true f32, no TF32). Read only where the stretch was
traced on the card."""

from harness.roofline import PEAK_F32_FLOPS


def read(ctx):
    w, t = ctx["work"], ctx["trace"]
    if w.get("kind") != "sweep" or not w.get("wall_s") or not t.get("busy_s"):
        return None
    flops = 2.0 * w["macs_per_image"] * w["passes"] * w["images_per_cell"] * w["cells"]
    return 100.0 * flops / (w["wall_s"] * PEAK_F32_FLOPS)
