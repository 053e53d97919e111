#!/usr/bin/env python3
"""Time the separable-blur kernel on one NVIDIA GPU.

    python3 tools/time_blur.py

Checks ``blur_separable`` against its plain version (0 LSB) and prints its
time per call (CUDA events, 20 calls after two warm-up calls, as
``chip_smoke.py`` times kernels) at 32x512x512x3 with r 1.5 and 5 and at
4096x32x32x3 with r 1.5, with the card's name and power limit. For A/B
runs of kernel variants within one call. Needs a CUDA device; exits 1
without one. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import sys


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("time_blur: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke as cs
    from imagetransformations_tpu_torch.ops import stencil as st
    from imagetransformations_tpu_torch.ops.hopper import blur as bl

    rows = []
    for shape, radius in ((cs.SHAPE_512, 1.5), (cs.SHAPE_512, 5.0), (cs.SHAPE_32, 1.5)):
        x = cs.images(torch, shape, cs.SEED)
        out = bl.blur_separable(x, radius)
        torch.cuda.synchronize()
        if not torch.equal(out, st.gaussian_blur_plain(x, radius)):
            raise RuntimeError(f"blur_separable differs from its plain version at {shape}")
        rows.append({"shape": [*shape, 3], "radius": radius,
                     "ms": cs.time_ms(torch, lambda: bl.blur_separable(x, radius), 20)})
    print(json.dumps({"card": cs.nvidia_smi(), "blur_separable": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
