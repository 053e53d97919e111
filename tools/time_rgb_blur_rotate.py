#!/usr/bin/env python3
"""Time the blur -> 3-shear rotation kernels on one NVIDIA GPU.

    python3 tools/time_rgb_blur_rotate.py [--tree DIR]

At 32x512x512x3 and 4096x32x32x3 it times, and checks against the plain
version (0 LSB): ``rgb_blur_rotate`` (``csrc/rgb_blur_rotate.cu``) strict
with grayscale and in stream mode at r 1.5 and 15 degrees, strict at r 0
and 15 degrees beside ``rotate_3shear`` (the same function by three row /
column launches, on the same batch), and with per-image angles (the
rotation grid cycled over the batch, strict, r 0: apply_all's rotation);
and the luma kernel (``csrc/luma_blur_rotate.cu``) at r 1.5, 15 degrees
and per-image angles (also at 128x224x224x3). ``ms`` is one wrapper
call (CUDA events around 20 calls after two warm-up calls, host overhead
included), ``device_ms`` the device time of its kernels alone
(torch.profiler, 20 calls). Each row carries its bound (``bound_ms``, from
``chip_smoke.py``). One JSON line a row, the card's name and power limit
first.

``--tree DIR`` imports the port's package from DIR instead (another
checkout, e.g. the parent commit unpacked with ``git archive``), for A/B
runs in turns within one call; a tree whose wrapper takes no ``slopes``
is called without it. Needs a CUDA device; exits 1 without one. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rows(torch, cs, mk, sh, shape, luma_only=False):
    """Print one JSON line a case at ``shape`` (n, h, w); the luma kernel's
    cases alone if ``luma_only``."""
    n, h, w = shape
    x = cs.images(torch, shape, cs.SEED + 300)
    dev = x.device
    takes_slopes = "slopes" in inspect.signature(mk.rgb_blur_rotate).parameters

    def rgb(radius, angle, strict, gray, traced):
        if traced:
            taps, p = mk._params(h, w, radius, 0.0, dev)[:2]
            k1, f1, k2, f2, ident = mk._traced_params(cs.cycled(cs.ROTATION_GRID, n), n, h, w,
                                                      25.0, dev)
            kw = {"slopes": mk.budget_slope_bound(25.0)} if takes_slopes else {}
        else:
            taps, p, k1, f1, k2, f2 = mk._params(h, w, radius, angle, dev)
            ident = angle == 0.0
            kw = {"slopes": mk.slope_bound(angle)} if takes_slopes else {}
        run = lambda: mk.rgb_blur_rotate(x, taps, p, k1, f1, k2, f2, 0, strict, gray, ident, **kw)
        plain = lambda: mk.rgb_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, 0, strict, gray,
                                                 ident)
        return run, plain, cs.bound(n, h, w, 3, 3, cs.ops_rgb(p, strict, gray, False))

    def luma(traced):
        if traced:
            taps, p = mk._params(h, w, cs.BLUR_RADIUS, 0.0, dev)[:2]
            k1, f1, k2, f2, _ = mk._traced_params(cs.traced_angles(n), n, h, w, 25.0, dev)
        else:
            taps, p, k1, f1, k2, f2 = mk._params(h, w, cs.BLUR_RADIUS, cs.ANGLE, dev)
        if hasattr(mk, "_images_per_block"):  # a tree before the band design
            ipb = mk._images_per_block(n, h)
            run = lambda: mk.luma_blur_rotate(x, taps, p, k1, f1, k2, f2, 0, ipb)
        else:
            run = lambda: mk.luma_blur_rotate(x, taps, p, k1, f1, k2, f2, 0)
        plain = lambda: mk.luma_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, 0)
        return run, plain, cs.bound(n, h, w, 3, 3, cs.ops_luma(p))

    a, r = cs.ANGLE, cs.BLUR_RADIUS
    cases = [
        ("rgb_blur_rotate", f"strict gray r {r} {a} deg", *rgb(r, a, True, True, False)),
        ("rgb_blur_rotate", f"stream r {r} {a} deg", *rgb(r, a, False, False, False)),
        ("rgb_blur_rotate", f"strict r 0 {a} deg", *rgb(0.0, a, True, False, False)),
        ("rotate_3shear", f"{a} deg (the same function)", lambda: sh.rotate_3shear(x, a),
         lambda: sh.rotate_3shear_plain(x, a), None),
        ("rgb_blur_rotate_traced", "strict r 0, rotation grid angles",
         *rgb(0.0, None, True, False, True)),
        ("luma_blur_rotate", f"stream gray r {r} {a} deg", *luma(False)),
        ("luma_blur_rotate_traced", f"stream gray r {r}, angles -22.5..22.5", *luma(True)),
    ]
    if luma_only:
        cases = [c for c in cases if c[0].startswith("luma")]
    for name, mode, run, plain, bnd in cases:
        got = run()
        torch.cuda.synchronize()
        if not torch.equal(got, plain()):
            raise RuntimeError(f"{name} ({mode}) differs from its plain version at {shape}")
        row = {"kernel": name, "shape": [*shape, 3], "mode": mode,
               "ms": cs.time_ms(torch, run, 20), "device_ms": cs.device_ms(torch, run, 20)}
        if bnd is not None:
            row["bound_ms"], row["bound_by"] = bnd
        print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None, help="import the port's package from this tree")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_rgb_blur_rotate: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # this tree's helpers and bounds

    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    from imagetransformations_tpu_torch.ops.hopper import megakernel as mk
    from imagetransformations_tpu_torch.ops.hopper import shear as sh

    print(json.dumps({"card": cs.nvidia_smi(), "package": os.path.dirname(mk.__file__)}),
          flush=True)
    for shape in (cs.SHAPE_512, cs.SHAPE_32):
        rows(torch, cs, mk, sh, shape)
    rows(torch, cs, mk, sh, cs.SHAPE_224, luma_only=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
