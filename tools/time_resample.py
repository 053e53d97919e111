#!/usr/bin/env python3
"""Time the per-image resampling kernels on one NVIDIA GPU.

    python3 tools/time_resample.py [--tree DIR]

At 32x512x512x3 and 4096x32x32x3 it times, and checks against the plain
version (0 LSB): ``shear_bicubic`` (``csrc/shear_bicubic.cu``) on the shear
grid 0..1 cycled over the batch (apply_all's default shear), and
``zoom_bilinear`` (``csrc/zoom_bilinear.cu``) on the scale grid 0.9..1.4
cycled over the batch (the fast sweep's scale) and at 0.5 and 4.0 for
every image (the ends of random_zoom's kernel range). ``ms`` is one
wrapper call (CUDA events around 20 calls after two warm-up calls, host
overhead included), ``device_ms`` the device time of its kernel alone
(``chip_smoke.device_ms``: torch.profiler, 20 calls). Each row carries its bound (``bound_ms``, from ``chip_smoke.py``).
One JSON line a row, the card's name and power limit first.

``--tree DIR`` imports the port's package from DIR instead (another
checkout, e.g. the parent commit unpacked with ``git archive``), for A/B
runs in turns within one call. Needs a CUDA device; exits 1 without one.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rows(torch, cs, rs, shape):
    """Print one JSON line a case at ``shape`` (n, h, w)."""
    n, h, w = shape
    x = cs.images(torch, shape, cs.SEED + 400)
    dev = x.device
    shear = torch.from_numpy(cs.cycled(cs.SHEAR_GRID, n)).to(dev)
    scale = torch.from_numpy(cs.cycled(cs.SCALE_GRID, n)).to(dev)
    cases = [("shear_bicubic", "grid factors 0..1", shear),
             ("zoom_bilinear", "scale grid factors 0.9..1.4", scale)]
    for f in (0.5, 4.0):
        cases.append(("zoom_bilinear", f"factor {f} (random_zoom)",
                      torch.full((n,), f, dtype=torch.float32, device=dev)))
    for name, mode, f in cases:
        if name == "shear_bicubic":
            run = lambda: rs.shear_bicubic(x, f)
            want = rs.shear_bicubic_plain(x, f)
            bnd = cs.bound_shear_bicubic(torch, x, f)
        else:
            run = lambda: rs.zoom_bilinear(x, f)
            want = rs.zoom_bilinear_plain(x, f)
            bnd = cs.bound_zoom(torch, x, f)
        got = run()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise RuntimeError(f"{name} ({mode}) differs from its plain version at {shape}")
        row = {"kernel": name, "shape": [*shape, 3], "mode": mode,
               "ms": cs.time_ms(torch, run, 20), "device_ms": cs.device_ms(torch, run, 20),
               "bound_ms": bnd[0], "bound_by": bnd[1]}
        print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None, help="import the port's package from this tree")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_resample: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # this tree's helpers and bounds

    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    from imagetransformations_tpu_torch.ops.hopper import resample as rs

    print(json.dumps({"card": cs.nvidia_smi(), "package": os.path.dirname(rs.__file__)}),
          flush=True)
    for shape in (cs.SHAPE_512, cs.SHAPE_32):
        rows(torch, cs, rs, shape)
    return 0


if __name__ == "__main__":
    sys.exit(main())
