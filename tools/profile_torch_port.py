#!/usr/bin/env python3
"""Where the device time goes on the PyTorch port's main path (one NVIDIA GPU).

    python3 tools/profile_torch_port.py

For each main-path run of chip_smoke.py (its ``main_path_runs``: the blur ->
rotate -> grayscale chain at 32x512x512, 128x224x224 and 4096x32x32; the
non-gray chain and the strict fused call at 512x512; the per-image-angle
chain at 512x512; the apply_all sweep at 32x512x512 and 4096x32x32 with
both flag sets; the strict, rotation-60, affine-run and photometric chains,
``blur_separable``, ``rotate_3shear``, ``blur_rotate_fused`` and
``shear_rows_per_image`` at 32x512x512), runs CALLS calls under
``torch.profiler`` after a warm-up and prints one JSON line: device time by
CUDA kernel name (the luma kernel's row launch and column launch
apart, PyTorch's own kernels if any), the wall time of the window, and the device's
busy share (sum of kernel time over wall time). Needs a CUDA device; exits 1
without one. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import sys
import time

CALLS = 10


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_torch_port: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke

    smi = chip_smoke.nvidia_smi()
    for label, fn, shape, seed, *_ in chip_smoke.main_path_runs():
        x = chip_smoke.images(torch, shape, seed)
        fn(x)
        fn(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(CALLS):
                fn(x)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = {}
        for evt in prof.key_averages():
            # kernel records only: a CPU op's device time repeats its kernels'
            if not str(getattr(evt, "device_type", "")).endswith("CUDA"):
                continue
            dev_us = getattr(evt, "self_device_time_total", 0) or 0
            if dev_us > 0:
                kernels[evt.key] = {"us_per_call": dev_us / CALLS,
                                    "count_per_call": evt.count / CALLS}
        busy_us = sum(k["us_per_call"] for k in kernels.values()) * CALLS
        print(json.dumps({
            "run": label, "shape": [*shape, 3], "calls": CALLS, "card": smi,
            "wall_us_per_call": wall_us / CALLS,
            "device_busy_share": busy_us / wall_us if wall_us else None,
            "kernels": kernels,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
