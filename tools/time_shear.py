#!/usr/bin/env python3
"""Time the row-shift library (``csrc/shear_rows.cu``) on one NVIDIA GPU.

    python3 tools/time_shear.py [--tree DIR]

At 32x512x512x3 and 4096x32x32x3 it times, and checks against the plain
version (0 LSB): ``shear_rows`` as pass 1 of
``rotate_3shear`` at 15 degrees and as its pass 3 with the grayscale flag;
``shear_rows_per_image`` on random +-30 px shifts with pad_px 20 and fill
255; ``shear_rows_logrouted`` on the fast sweep's shifts (shear grid 0..1
cycled over the batch); the column pass (pass 2 of ``rotate_3shear``); and
``rotate_3shear`` at 15 degrees. ``ms`` is one wrapper call (CUDA events
around 20 calls after two warm-up calls, as ``chip_smoke.py`` times
kernels: host overhead included), ``device_ms`` the device time of its
kernels alone (torch.profiler, 20 calls). Each row carries its bound
(``bound_ms``, from ``chip_smoke.py``). One JSON line a row, the card's
name and power limit first.

``--tree DIR`` imports the port's package from DIR instead (another
checkout, e.g. the parent commit unpacked with ``git archive``), for A/B
runs in turns within one call. A tree without the column pass times its
pass 2 as a row shift between two transposes, the way that tree runs it.
Needs a CUDA device; exits 1 without one. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rows(torch, cs, sh, batch, shape):
    """Print one JSON line a case at ``shape`` (n, h, w)."""
    n, h, w = shape
    x = cs.images(torch, shape, cs.SEED + 200)
    dev = x.device
    sx, bx, sy, by = sh._rotation_shifts(h, w, cs.ANGLE, dev)
    per_image = cs.per_image_row_shifts(torch, n, h, dev)
    v = torch.from_numpy(cs.cycled(cs.SHEAR_GRID, n)).to(dev)
    fast = batch.fast_shear_shifts(v, h, dev)
    fast_bound = batch.fast_shear_budget(max(cs.SHEAR_GRID), h)
    fast_b = min(fast_bound + 1, w + 2)
    if hasattr(sh, "_col_shift"):
        cols = lambda: sh._col_shift(x, sy, 0, by)
        col_route = "column pass"
    else:
        cols = lambda: sh._swap_hw(sh.shear_rows(sh._swap_hw(x), sy, 0, by))
        col_route = "transposes + row shift"
    col_plain = lambda: sh._swap_hw(sh.shear_rows_plain(sh._swap_hw(x), sy, 0, by))
    cases = [
        ("shear_rows", f"rotate_3shear pass 1 at {cs.ANGLE} deg, fill 0",
         lambda: sh.shear_rows(x, sx, 0, bx), lambda: sh.shear_rows_plain(x, sx, 0, bx),
         cs.bound_shear_rows(torch, x, sx.expand(n, h), bx)),
        ("shear_rows", "pass 3 with the grayscale flag",
         lambda: sh.shear_rows(x, sx, 0, bx, "grayscale"),
         lambda: sh.shear_rows_plain(x, sx, 0, bx, True),
         cs.bound_shear_rows(torch, x, sx.expand(n, h), bx)),
        ("shear_rows_per_image", f"random shifts +-30 px, pad_px {cs.PER_IMAGE_PAD}, fill 255",
         lambda: sh.shear_rows_per_image(x, per_image, 255, cs.PER_IMAGE_PAD),
         lambda: sh.shear_rows_plain(x, per_image, 255, cs.PER_IMAGE_PAD),
         cs.bound_shear_rows(torch, x, per_image, cs.PER_IMAGE_PAD)),
        ("shear_rows_logrouted", "fast sweep shifts, grid factors 0..1, fill 255",
         lambda: sh.shear_rows_logrouted(x, fast, 255, fast_bound),
         lambda: sh.shear_rows_plain(x, fast, 255, fast_b),
         cs.bound_shear_rows(torch, x, fast, fast_b)),
        ("shear_cols", f"rotate_3shear pass 2 at {cs.ANGLE} deg ({col_route}), fill 0",
         cols, col_plain, cs.bound_shear_cols(torch, x, sy, by)),
        ("rotate_3shear", f"{cs.ANGLE} deg, fill 0", lambda: sh.rotate_3shear(x, cs.ANGLE),
         lambda: sh.rotate_3shear_plain(x, cs.ANGLE), None),
    ]
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
        print("time_shear: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # this tree's helpers and bounds

    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    from imagetransformations_tpu_torch.ops.hopper import shear as sh
    from imagetransformations_tpu_torch.pipeline import batch

    print(json.dumps({"card": cs.nvidia_smi(), "package": os.path.dirname(sh.__file__)}),
          flush=True)
    for shape in (cs.SHAPE_512, cs.SHAPE_32):
        rows(torch, cs, sh, batch, shape)
    return 0


if __name__ == "__main__":
    sys.exit(main())
