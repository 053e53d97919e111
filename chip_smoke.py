#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``imagetransformations_tpu_torch/
csrc`` with nvcc, holds each against its plain PyTorch version on the card
at full size (0 LSB), drives the main path (``build_chain_fn`` and
``fused_blur_rotate_image``) at the benchmark shapes with the launch
counters reset just before and read just after, and times each kernel
beside its bound. Prints one JSON line per phase; the last line is
``{"ok": true, "device": {...}}``. Any failure raises: the exit code is then
non-zero and no result line is printed. Without a CUDA device it exits 1.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

SEED = 0
# published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and the f32
# rate outside the tensor cores, 67 TFLOP/s, which counts an FMA as two
# operations. The kernels are built without FMA, so each add, multiply or
# convert issues on its own: at most half that many a second. (Integer and
# convert instructions issue slower still, so the bound stays a lower bound.)
HBM_BYTES_PER_S = 3.35e12
UNFUSED_OPS_PER_S = 67e12 / 2
BLUR_RADIUS, ANGLE = 1.5, 15.0
# main-path batches: (n, h, w), the shapes bench.py grades
SHAPE_512, SHAPE_224, SHAPE_32 = (32, 512, 512), (128, 224, 224), (4096, 32, 32)

KERNELS = {
    "luma_blur_rotate": dict(
        source="imagetransformations_tpu_torch/csrc/luma_blur_rotate.cu",
        replaces="imagetransformations_tpu/ops/pallas/megakernel.py:435",
    ),
    "luma_blur_rotate_packed": dict(
        source="imagetransformations_tpu_torch/csrc/luma_blur_rotate.cu",
        replaces="imagetransformations_tpu/ops/pallas/megakernel.py:514",
    ),
    "rgb_blur_rotate": dict(
        source="imagetransformations_tpu_torch/csrc/rgb_blur_rotate.cu",
        replaces="imagetransformations_tpu/ops/pallas/megakernel.py:192",
    ),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def images(torch, shape, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, 256, (*shape, 3), generator=g, device="cuda", dtype=torch.uint8)


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of one fn() call: CUDA events around `reps` calls
    after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_lsb(torch, a, b) -> int:
    if a.shape != b.shape or a.dtype != b.dtype:
        fail(f"shape/dtype mismatch {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
    return int((a.to(torch.int16) - b.to(torch.int16)).abs().max().item())


def bound(n, h, w, c_in, c_out, ops_per_px):
    """(bound_ms, bound_by): each u8 input byte read once and each output
    byte written once over HBM bandwidth, against the operations (none
    fused) over the unfused issue rate."""
    px = n * h * w
    t_bytes = px * (c_in + c_out) / HBM_BYTES_PER_S
    t_ops = px * ops_per_px / UNFUSED_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def ops_luma(p: int) -> int:
    # luma (3 int mul, 2 int add, cvt, mul) + 2 blur passes (1 mul + 3 per
    # tap pair) + 3 lerps (sub, mul, add) + rounding (add, cvt)
    return 7 + 2 * (1 + 3 * p) + 9 + 2


def ops_rgb(p: int, strict: bool, gray: bool, identity: bool) -> int:
    # per channel: cvt + 2 blur passes [+ rint] [+ 3 lerps, + 3 truncs if
    # strict] + quantization; gray adds 3 mul, 2 add, mul, add, cvt per pixel
    per_ch = 1 + 2 * (1 + 3 * p) + int(strict) + (0 if identity else 9 + 3 * int(strict)) + 1
    return 3 * per_ch + (8 if gray else 0)


def nvidia_smi() -> str:
    """The first card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main_path_runs():
    """The main path as a user calls it, one entry per run:
    (label, fn, shape, seed of the matching parity case, gray, stream, reps).
    tools/profile_torch_port.py profiles the same runs."""
    from imagetransformations_tpu_torch import OpSpec, build_chain_fn, fused_blur_rotate_image

    chain_gray = [OpSpec("blur", {"radius": BLUR_RADIUS}), OpSpec("rotation", {"angle": ANGLE}),
                  OpSpec("grayscale")]
    fn_gray, fn_rgb = build_chain_fn(chain_gray), build_chain_fn(chain_gray[:2])

    def strict(x):
        return fused_blur_rotate_image(x, BLUR_RADIUS, ANGLE, grayscale_out=True, stream=False)

    return [
        ("chain blur>rotate>gray 512", fn_gray, SHAPE_512, SEED + 0, True, True, 20),
        ("chain blur>rotate>gray 224", fn_gray, SHAPE_224, SEED + 1, True, True, 20),
        ("chain blur>rotate>gray 32 (cifar)", fn_gray, SHAPE_32, SEED + 3, True, True, 20),
        ("chain blur>rotate 512", fn_rgb, SHAPE_512, SEED + 4, False, True, 10),
        ("fused_blur_rotate_image strict gray 512", strict, SHAPE_512, SEED + 5, True, False, 10),
    ]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from imagetransformations_tpu_torch import fused_blur_rotate_image
    from imagetransformations_tpu_torch.ops.hopper import _lib
    from imagetransformations_tpu_torch.ops.hopper import megakernel as mk

    # ---- device -------------------------------------------------------------
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # ---- build --------------------------------------------------------------
    t0 = time.perf_counter()
    reports = _lib.build_all()
    for name in _lib.SIGNATURES:
        _lib.load(name)
    ptxas = {
        name: [ln.strip() for ln in log.splitlines()
               if re.search(r"registers|spill|Compiling entry", ln)]
        for name, log in reports.items()
    }
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "ptxas": ptxas})

    # ---- parity: kernel vs plain version on the card, 0 LSB -----------------
    # each case: (kernel, shape, radius, angle, fill, gray, stream)
    cases = [
        ("luma_blur_rotate", SHAPE_512, BLUR_RADIUS, ANGLE, 0, True, True),
        ("luma_blur_rotate", SHAPE_224, BLUR_RADIUS, ANGLE, 0, True, True),
        ("luma_blur_rotate", SHAPE_224, 2.5, -30.0, 255, True, True),
        ("luma_blur_rotate_packed", SHAPE_32, BLUR_RADIUS, ANGLE, 0, True, True),
        ("rgb_blur_rotate", SHAPE_512, BLUR_RADIUS, ANGLE, 0, False, True),
        ("rgb_blur_rotate", SHAPE_512, BLUR_RADIUS, ANGLE, 0, True, False),
        ("rgb_blur_rotate", SHAPE_512, BLUR_RADIUS, 0.0, 0, False, True),
        ("rgb_blur_rotate", SHAPE_224, 0.0, -22.5, 128, False, False),
    ]
    errs = {k: 0 for k in KERNELS}
    refs = {}
    for i, (kernel, shape, radius, angle, fill, gray, stream) in enumerate(cases):
        x = images(torch, shape, SEED + i)
        n, h, w = shape
        before = dict(mk.LAUNCHES)
        out = fused_blur_rotate_image(x, radius, angle, fill=fill, grayscale_out=gray,
                                      stream=stream)
        if mk.LAUNCHES[kernel] != before[kernel] + 1:
            fail(f"case {i} did not route to {kernel}: {mk.LAUNCHES}")
        taps, p, k1, f1, k2, f2 = mk._params(h, w, radius, angle, x.device)
        if kernel.startswith("luma"):
            plain = mk.luma_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, fill)
        else:
            plain = mk.rgb_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, fill, not stream,
                                             gray, angle == 0.0)
        torch.cuda.synchronize()
        err = max_lsb(torch, out, plain)
        row = {"phase": "parity", "kernel": kernel, "shape": [*shape, 3], "radius": radius,
               "angle": angle, "fill": fill, "grayscale": gray, "stream": stream,
               "max_lsb": err}
        if kernel == "luma_blur_rotate_packed":
            unpacked = mk.luma_blur_rotate(x, taps, p, k1, f1, k2, f2, fill, images_per_block=1)
            row["max_lsb_vs_unpacked"] = max_lsb(torch, out, unpacked)
            err = max(err, row["max_lsb_vs_unpacked"])
        emit(row)
        if err != 0:
            fail(f"parity case {i} ({kernel}) differs by {err} LSB")
        errs[kernel] = max(errs[kernel], err)
        if fill == 0 and (radius, angle) == (BLUR_RADIUS, ANGLE):
            refs[(shape, gray, stream)] = plain
        del x, out, plain

    # ---- main path: the user-facing entry points, counters reset ----------
    runs = main_path_runs()
    inputs = {label: images(torch, shape, seed) for label, _, shape, seed, *_ in runs}
    torch.cuda.synchronize()
    for k in mk.LAUNCHES:
        mk.LAUNCHES[k] = 0
    results = []
    for label, fn, shape, _, gray, stream, reps in runs:
        x = inputs[label]
        out = fn(x)
        ms = time_ms(torch, lambda: fn(x), reps)
        n, h, w = shape
        if out.shape != x.shape or out.dtype != torch.uint8 or out.device != x.device:
            fail(f"{label}: bad output {tuple(out.shape)} {out.dtype} {out.device}")
        if gray and not (torch.equal(out[..., 0], out[..., 1])
                         and torch.equal(out[..., 0], out[..., 2])):
            fail(f"{label}: grayscale channels differ")
        # the same seed made the parity case's input: the output must equal
        # the plain version computed there
        lsb = max_lsb(torch, out, refs[(shape, gray, stream)])
        if lsb != 0:
            fail(f"{label}: differs from the plain version by {lsb} LSB")
        results.append({"run": label, "shape": [*shape, 3], "ms": ms,
                        "gpix_per_s": n * h * w / (ms * 1e-3) / 1e9, "max_lsb_vs_plain": lsb})
    torch.cuda.synchronize()
    launches = dict(mk.LAUNCHES)
    emit({"phase": "main_path", "runs": results, "launches": launches})
    for k, v in launches.items():
        if v <= 0:
            fail(f"kernel {k} was not launched on the main path")
    del inputs, refs

    # ---- kernels: each wrapper and its plain version at main-path shapes ---
    timed = {  # kernel: (shape, radius, angle, gray, stream)
        "luma_blur_rotate": (SHAPE_512, BLUR_RADIUS, ANGLE, True, True),
        "luma_blur_rotate_packed": (SHAPE_32, BLUR_RADIUS, ANGLE, True, True),
        "rgb_blur_rotate": (SHAPE_512, BLUR_RADIUS, ANGLE, True, False),
    }
    entries = []
    for kernel, (shape, radius, angle, gray, stream) in timed.items():
        n, h, w = shape
        x = images(torch, shape, SEED + 100)
        taps, p, k1, f1, k2, f2 = mk._params(h, w, radius, angle, x.device)
        if kernel.startswith("luma"):
            ipb = mk._images_per_block(n, h)
            run = lambda: mk.luma_blur_rotate(x, taps, p, k1, f1, k2, f2, 0, ipb)
            plain = lambda: mk.luma_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, 0)
            b_ms, b_by = bound(n, h, w, 3, 3, ops_luma(p))
        else:
            run = lambda: mk.rgb_blur_rotate(x, taps, p, k1, f1, k2, f2, 0, not stream, gray,
                                             False)
            plain = lambda: mk.rgb_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, 0, not stream,
                                                     gray, False)
            b_ms, b_by = bound(n, h, w, 3, 3, ops_rgb(p, not stream, gray, False))
        entries.append({
            "name": kernel, "route": "cuda", **KERNELS[kernel],
            "launches": launches[kernel], "max_abs_err": errs[kernel],
            "ms": time_ms(torch, run, 20), "plain_ms": time_ms(torch, plain, 5),
            "bound_ms": b_ms, "bound_by": b_by,
            # no single PyTorch call computes blur + 3-shear rotation
            "library_ms": None,
            "shape": [*shape, 3], "mode": ("stream" if stream else "strict")
            + (" gray" if gray else ""),
        })
        del x

    # ---- geometry: the luma kernel at 4096x32x32, by images a block ---------
    # Two rounds, the second in reverse order, so warm-up favours neither end.
    n, h, w = SHAPE_32
    x = images(torch, SHAPE_32, SEED + 101)
    taps, p, k1, f1, k2, f2 = mk._params(h, w, BLUR_RADIUS, ANGLE, x.device)
    geometries = (1, 2, 4, 8, 16)
    one = mk.luma_blur_rotate(x, taps, p, k1, f1, k2, f2, 0, images_per_block=1)
    rounds = []
    for order in (geometries, geometries[::-1]):
        ms = {}
        for ipb in order:
            run = lambda: mk.luma_blur_rotate(x, taps, p, k1, f1, k2, f2, 0, ipb)
            if max_lsb(torch, run(), one) != 0:
                fail(f"{ipb} images a block differ from one image a block")
            ms[ipb] = time_ms(torch, run, 20)
        rounds.append(ms)
    emit({"phase": "geometry", "kernel": "luma_blur_rotate", "shape": [*SHAPE_32, 3],
          "ms_by_images_per_block": [{str(k): r[k] for k in geometries} for r in rounds],
          "routed": mk._images_per_block(n, h)})
    del x, one
    emit({"kernels": entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
