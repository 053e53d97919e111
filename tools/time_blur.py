#!/usr/bin/env python3
"""Time the separable-blur kernel on one NVIDIA GPU.

    python3 tools/time_blur.py

Checks each call against its plain version (0 LSB) and prints its time
(CUDA events, 20 calls after two warm-up calls, as ``chip_smoke.py`` times
kernels): ``blur_separable`` at 32x512x512x3 with r 1.5 and 5 and at
4096x32x32x3 with r 1.5; ``blur_separable_batched`` (apply_all's per-image
blur) at both shapes with the blur grid's radii 0:0.5:5 cycled over the
batch, and with r 1.5 for every image (the per-image kernel against the
one-radius one): ``ms`` the kernel on tap rows made before the timing,
``entry_ms`` the entry point with its taps (PyTorch ops on the host's
clock, so host-bound). One JSON line a row, the card's name and power limit
first. For A/B runs, run the script of another tree (a variant of the
kernel) in the same call, in turns. Needs a CUDA device;
exits 1 without one. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import sys


def rows(torch, cs, st, bl):
    """Print one JSON line a case."""
    cases = [("blur_separable", cs.SHAPE_512, 1.5), ("blur_separable", cs.SHAPE_512, 5.0),
             ("blur_separable", cs.SHAPE_32, 1.5), ("blur_separable_batched", cs.SHAPE_512, None),
             ("blur_separable_batched", cs.SHAPE_32, None),
             ("blur_separable_batched", cs.SHAPE_512, "1.5 every image")]
    for name, shape, radius in cases:
        x = cs.images(torch, shape, cs.SEED)
        row = {"kernel": name, "shape": [*shape, 3],
               "radius": radius if radius is not None else "grid 0:0.5:5 cycled"}
        if name == "blur_separable_batched":
            grid = cs.BLUR_GRID if radius is None else [1.5]
            r = torch.from_numpy(cs.cycled(grid, shape[0])).to(x.device)
            taps = st.blur_taps_batched(r)
            run = lambda: bl._launch(x, taps, taps.shape[1], name)
            plain = lambda: st.blur_batched_plain(x, r)
            row["entry_ms"] = cs.time_ms(torch, lambda: bl.blur_separable_batched(x, r), 20)
        else:
            run = lambda: bl.blur_separable(x, radius)
            plain = lambda: st.gaussian_blur_plain(x, radius)
        got = run()
        torch.cuda.synchronize()
        if not torch.equal(got, plain()):
            raise RuntimeError(f"{name} differs from its plain version at {shape}")
        row["ms"] = cs.time_ms(torch, run, 20)
        print(json.dumps(row), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_blur: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs
    from imagetransformations_tpu_torch.ops import stencil as st
    from imagetransformations_tpu_torch.ops.hopper import blur as bl

    print(json.dumps({"card": cs.nvidia_smi()}), flush=True)
    rows(torch, cs, st, bl)
    return 0


if __name__ == "__main__":
    sys.exit(main())
