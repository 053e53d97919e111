#!/usr/bin/env python3
"""Time the NEAREST rotation kernel on one NVIDIA GPU.

    python3 tools/time_rotate.py [--tree DIR]

At 32x512x512x3 and 4096x32x32x3, with the rotation grid -22.5..22.5
cycled over the batch (the PIL-parity sweep's angles), it times the entry
point ``pil_rotate_nearest_batched(x, angles)`` (its signature is the same
in every tree): ``ms`` one call, the median of 7 runs of CUDA events
around 50 calls after two warm-up calls (host work included: the
coefficients or matrices and their copy; the host's clock spreads between
runs, so ``ms_runs`` lists all 7), ``device_ms`` its device time
(``chip_smoke.device_ms``: torch.profiler, 20 calls; the kernel and any
small kernels or copies the entry point issues), and ``kernel_device_ms``
the kernel alone on parameters made before the timing. The output is held against the same
entry point on a CPU copy of the batch (``max_lsb_vs_cpu``; the PIL-exact
port must give 0). Each row carries ``bound_ms`` from ``chip_smoke.py``
(null for a tree before Pillow's fixed point).
One JSON line a row, the card's name and power limit first.

``--tree DIR`` imports the port's package from DIR instead (another
checkout, e.g. the parent commit unpacked with ``git archive``), for A/B
runs in turns within one call; a tree whose ``rotate_gather`` has no
``pil_rotate_coeffs`` is the f32-matrix version (before Pillow's fixed
point). Needs a CUDA device; exits 1 without one. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rows(torch, cs, rg, shape, label):
    """Print one JSON line at ``shape`` (n, h, w)."""
    n, h, w = shape
    x = cs.images(torch, shape, cs.SEED + 500)
    angles = cs.cycled(cs.ROTATION_GRID, n)
    entry = lambda: rg.pil_rotate_nearest_batched(x, angles)
    if hasattr(rg, "pil_rotate_coeffs"):
        params = cs.rotate_coeffs(torch, angles, w, h, x.device)
    else:  # the f32-matrix version's parameters
        from imagetransformations_tpu_torch.ops.warp import rotation_matrix

        params = rotation_matrix(angles, w, h, device=x.device)
    kernel = lambda: rg.pil_rotate_nearest(x, params, 0)
    got = entry()
    torch.cuda.synchronize()
    err = cs.max_lsb(torch, got.cpu(), rg.pil_rotate_nearest_batched(x.cpu(), angles))
    if not torch.equal(kernel(), got):
        raise RuntimeError(f"the kernel and the entry point differ at {shape}")
    # the bound from Pillow's integers (not in a tree without them)
    bnd = cs.bound_rotate(torch, x, params) if hasattr(rg, "pil_rotate_coeffs") else (None, None)
    runs = [cs.time_ms(torch, entry, 50) for _ in range(7)]
    row = {"tree": label, "kernel": "pil_rotate_nearest", "shape": [*shape, 3],
           "mode": "rotation grid angles -22.5..22.5, fill 0", "max_lsb_vs_cpu": err,
           "ms": statistics.median(runs), "ms_runs": runs,
           "device_ms": cs.device_ms(torch, entry, 20),
           "kernel_device_ms": cs.device_ms(torch, kernel, 20),
           "bound_ms": bnd[0], "bound_by": bnd[1]}
    print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=None, help="import the port's package from this tree")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_rotate: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs  # this tree's helpers and bounds

    if args.tree:
        sys.path.insert(0, os.path.abspath(args.tree))
    from imagetransformations_tpu_torch.ops.hopper import rotate_gather as rg

    label = os.path.abspath(args.tree) if args.tree else ROOT
    print(json.dumps({"card": cs.nvidia_smi(), "package": os.path.dirname(rg.__file__)}),
          flush=True)
    for shape in (cs.SHAPE_512, cs.SHAPE_32):
        rows(torch, cs, rg, shape, label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
