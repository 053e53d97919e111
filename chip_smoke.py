#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``imagetransformations_tpu_torch/
csrc`` with nvcc, holds each against its plain PyTorch version on the card
at full size (0 LSB), drives the main path (``build_chain_fn`` with static
and per-image angles, ``fused_blur_rotate_image`` and the 8-type
``apply_all_transformations`` sweep) at the benchmark shapes with the
launch counters reset just before and read just after, times each sweep
type, and times each kernel beside its bound. Prints one JSON line per
phase; the last line is
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
# the reference's grids (core/grids.py): rotation -22.5:2.5:22.5, shear 0:0.1:1
ROTATION_GRID = [-22.5 + 2.5 * i for i in range(19)]
SHEAR_GRID = [round(0.1 * i, 1) for i in range(11)]
APPLY_ALL_BUDGET = 23.0  # max |grid angle| + 0.5, as pipeline/batch.py routes it

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
    "luma_blur_rotate_traced": dict(
        source="imagetransformations_tpu_torch/csrc/luma_blur_rotate.cu",
        replaces="imagetransformations_tpu/ops/pallas/megakernel.py:854",
    ),
    "rgb_blur_rotate_traced": dict(
        source="imagetransformations_tpu_torch/csrc/rgb_blur_rotate.cu",
        replaces="imagetransformations_tpu/ops/pallas/megakernel.py:920",
    ),
    "shear_bicubic": dict(
        source="imagetransformations_tpu_torch/csrc/shear_bicubic.cu",
        replaces="imagetransformations_tpu/ops/pallas/resample.py:185",
    ),
}
# why no single PyTorch call is timed beside a kernel (library_ms null)
NO_LIBRARY = {
    "shear_bicubic": "grid_sample(mode='bicubic') uses A=-0.75 and other borders; "
                     "PIL's cubic is A=-1 with white fill",
}
NO_LIBRARY_BLUR_ROTATE = "no single PyTorch call computes blur + 3-shear rotation"


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


def ops_shear_bicubic(c: int) -> int:
    # per pixel: xo, s*yo, two adds, -0.5, floor, sub (the source coordinate);
    # per value: 4 cvt, p2 (2), p3 (4), p4 (4), Horner (3 mul + 3 add), clip (3)
    return 7 + 23 * c


def traced_angles(n: int, zero_at=None):
    """n per-image angles spread over the grid's range, optionally one at 0."""
    import numpy as np

    a = np.linspace(-22.5, 22.5, n, dtype=np.float32)
    if zero_at is not None:
        a[zero_at] = 0.0
    return a


def cycled(values, n: int):
    """The grid values repeated over n images (every value occurs)."""
    import numpy as np

    return np.resize(np.asarray(values, np.float32), n)


def nvidia_smi() -> str:
    """The first card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def main_path_runs():
    """The main path as a user calls it, one entry per run:
    (label, fn, shape, seed, ref, reps). ``ref`` names the parity case whose
    plain output the run's output must equal (same seed, same inputs), or is
    "apply_all" for the sweeps, whose rotation and shear outputs are held
    against the plain versions on the values the sweep drew.
    tools/profile_torch_port.py profiles the same runs."""
    from imagetransformations_tpu_torch import (
        OpSpec,
        apply_all_transformations,
        build_chain_fn,
        fused_blur_rotate_image,
    )

    blur, gray = OpSpec("blur", {"radius": BLUR_RADIUS}), OpSpec("grayscale")
    rotation = OpSpec("rotation", {"angle": ANGLE})
    fn_gray, fn_rgb = build_chain_fn([blur, rotation, gray]), build_chain_fn([blur, rotation])
    # bench.py's traced-angle shape: one angle an image, linspace(-22.5, 22.5)
    fn_traced = build_chain_fn(
        [blur, OpSpec("rotation", {"angle": traced_angles(SHAPE_512[0])}), gray])

    def strict(x):
        return fused_blur_rotate_image(x, BLUR_RADIUS, ANGLE, grayscale_out=True, stream=False)

    def sweep(x):
        return apply_all_transformations(x, SEED)

    return [
        ("chain blur>rotate>gray 512", fn_gray, SHAPE_512, SEED + 0, (SHAPE_512, True, True), 20),
        ("chain blur>rotate>gray 224", fn_gray, SHAPE_224, SEED + 1, (SHAPE_224, True, True), 20),
        ("chain blur>rotate>gray 32 (cifar)", fn_gray, SHAPE_32, SEED + 3,
         (SHAPE_32, True, True), 20),
        ("chain blur>rotate 512", fn_rgb, SHAPE_512, SEED + 4, (SHAPE_512, False, True), 10),
        ("fused_blur_rotate_image strict gray 512", strict, SHAPE_512, SEED + 5,
         (SHAPE_512, True, False), 10),
        ("chain blur>rotate(per-image angles)>gray 512", fn_traced, SHAPE_512, SEED + 20,
         "traced gray 512", 20),
        ("apply_all_transformations 512", sweep, SHAPE_512, SEED + 30, "apply_all", 5),
        ("apply_all_transformations 32 (cifar)", sweep, SHAPE_32, SEED + 31, "apply_all", 5),
    ]


def check_sweep(torch, x, res) -> dict:
    """The 8 types, their shapes and types; rotation and shear at 0 LSB
    against the plain versions on the values the sweep drew; the noise
    changes the image. Returns the LSB of each checked type."""
    from imagetransformations_tpu_torch.ops.hopper import megakernel as mk
    from imagetransformations_tpu_torch.ops.hopper import resample as rs
    from imagetransformations_tpu_torch.pipeline.batch import TYPES

    n, h, w, _ = x.shape
    if set(res) != set(TYPES):
        fail(f"apply_all returned {sorted(res)}")
    for t, (values, out) in res.items():
        if values.shape != (n,) or out.shape != x.shape or out.dtype != torch.uint8:
            fail(f"apply_all {t}: values {tuple(values.shape)}, out {tuple(out.shape)} {out.dtype}")
        if out.device != x.device:
            fail(f"apply_all {t}: output on {out.device}")
    values, out = res["rotation"]
    taps, p = mk._params(h, w, 0.0, 0.0, x.device)[:2]
    k1, f1, k2, f2, ident = mk._traced_params(values, n, h, w, APPLY_ALL_BUDGET, x.device)
    plain_rot = mk.rgb_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, 0, True, False, ident)
    values, out_shear = res["shear"]
    lsb = {"rotation": max_lsb(torch, out, plain_rot),
           "shear": max_lsb(torch, out_shear, rs.shear_bicubic_plain(x, values))}
    for t, v in lsb.items():
        if v != 0:
            fail(f"apply_all {t} differs from its plain version by {v} LSB")
    if torch.equal(res["gaussian_noise"][1], x):
        fail("apply_all gaussian_noise left the images unchanged")
    return lsb


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from imagetransformations_tpu_torch import apply_all_transformations, fused_blur_rotate_image
    from imagetransformations_tpu_torch.ops.hopper import _lib
    from imagetransformations_tpu_torch.ops.hopper import megakernel as mk
    from imagetransformations_tpu_torch.ops.hopper import resample as rs
    from imagetransformations_tpu_torch.pipeline.batch import TYPES

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

    # per-image angles: the shifts are computed once on the card and fed to
    # the kernel and to its plain version; the entry point's output (routing
    # checked by its counter) must equal the kernel's.
    # each case: (kernel, shape, radius, angles, gray, stream, seed, ref)
    traced_cases = [
        ("luma_blur_rotate_traced", SHAPE_512, BLUR_RADIUS, traced_angles(SHAPE_512[0]), True,
         True, SEED + 20, "traced gray 512"),
        ("luma_blur_rotate_traced", SHAPE_32, BLUR_RADIUS, traced_angles(SHAPE_32[0]), True,
         True, SEED + 21, None),
        ("rgb_blur_rotate_traced", SHAPE_512, 0.0, cycled(ROTATION_GRID, SHAPE_512[0]), False,
         False, SEED + 22, None),
        ("rgb_blur_rotate_traced", SHAPE_224, BLUR_RADIUS, traced_angles(SHAPE_224[0], 5), False,
         True, SEED + 23, None),
    ]
    for kernel, shape, radius, angles, gray, stream, seed, ref in traced_cases:
        x = images(torch, shape, seed)
        n, h, w = shape
        budget = 25.0
        taps, p = mk._params(h, w, radius, 0.0, x.device)[:2]
        k1, f1, k2, f2, ident = mk._traced_params(angles, n, h, w, budget, x.device)
        before = mk.LAUNCHES[kernel]
        out = mk.fused_blur_rotate_batched(x, radius, angles, grayscale_out=gray, stream=stream,
                                           max_angle_deg=budget)
        if mk.LAUNCHES[kernel] != before + 1:
            fail(f"{kernel} {shape}: the entry point did not route to it: {mk.LAUNCHES}")
        row = {"phase": "parity", "kernel": kernel, "shape": [*shape, 3], "radius": radius,
               "angles": [float(angles.min()), float(angles.max())],
               "zero_angle_images": int((ident != 0).sum()), "grayscale": gray,
               "stream": stream}
        if kernel.startswith("luma"):
            ipb = mk._images_per_block(n, h)
            kern = mk.luma_blur_rotate(x, taps, p, k1, f1, k2, f2, 0, ipb)
            plain = mk.luma_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, 0)
            row["images_per_block"] = ipb
            if ipb > 1:
                one = mk.luma_blur_rotate(x, taps, p, k1, f1, k2, f2, 0, images_per_block=1)
                row["max_lsb_vs_one_image_a_block"] = max_lsb(torch, kern, one)
        else:
            kern = mk.rgb_blur_rotate(x, taps, p, k1, f1, k2, f2, 0, not stream, gray, ident)
            plain = mk.rgb_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, 0, not stream, gray,
                                             ident)
        torch.cuda.synchronize()
        row["max_lsb"] = max_lsb(torch, kern, plain)
        row["max_lsb_entry_vs_kernel"] = max_lsb(torch, out, kern)
        emit(row)
        err = max(v for k, v in row.items() if k.startswith("max_lsb"))
        if err != 0:
            fail(f"parity {kernel} {shape} differs by {err} LSB")
        errs[kernel] = max(errs[kernel], err)
        if ref is not None:
            refs[ref] = plain
        del x, out, kern, plain

    for shape, seed in ((SHAPE_512, SEED + 24), (SHAPE_32, SEED + 25)):
        x = images(torch, shape, seed)
        f = torch.from_numpy(cycled(SHEAR_GRID, shape[0])).to(x.device)
        before = mk.LAUNCHES["shear_bicubic"]
        out = rs.shear_bicubic_batched(x, f)
        if mk.LAUNCHES["shear_bicubic"] != before + 1:
            fail(f"shear_bicubic {shape}: the entry point did not route to it")
        err = max_lsb(torch, out, rs.shear_bicubic_plain(x, f))
        emit({"phase": "parity", "kernel": "shear_bicubic", "shape": [*shape, 3],
              "factors": SHEAR_GRID, "max_lsb": err})
        if err != 0:
            fail(f"parity shear_bicubic {shape} differs by {err} LSB")
        errs["shear_bicubic"] = max(errs["shear_bicubic"], err)
        del x, out

    # ---- main path: the user-facing entry points, counters reset ----------
    runs = main_path_runs()
    inputs = {label: images(torch, shape, seed) for label, _, shape, seed, *_ in runs}
    torch.cuda.synchronize()
    for k in mk.LAUNCHES:
        mk.LAUNCHES[k] = 0
    results = []
    for label, fn, shape, _, ref, reps in runs:
        x = inputs[label]
        out = fn(x)
        ms = time_ms(torch, lambda: fn(x), reps)
        n, h, w = shape
        row = {"run": label, "shape": [*shape, 3], "ms": ms,
               "gpix_per_s": n * h * w / (ms * 1e-3) / 1e9}
        if ref == "apply_all":
            row["max_lsb_vs_plain"] = check_sweep(torch, x, out)
        else:
            if out.shape != x.shape or out.dtype != torch.uint8 or out.device != x.device:
                fail(f"{label}: bad output {tuple(out.shape)} {out.dtype} {out.device}")
            is_gray = ref[1] if isinstance(ref, tuple) else "gray" in ref
            if is_gray:
                if not (torch.equal(out[..., 0], out[..., 1])
                        and torch.equal(out[..., 0], out[..., 2])):
                    fail(f"{label}: grayscale channels differ")
            # the same seed made the parity case's input: the output must
            # equal the plain version computed there
            row["max_lsb_vs_plain"] = max_lsb(torch, out, refs[ref])
            if row["max_lsb_vs_plain"] != 0:
                fail(f"{label}: differs from the plain version by {row['max_lsb_vs_plain']} LSB")
        results.append(row)
    torch.cuda.synchronize()
    launches = dict(mk.LAUNCHES)
    emit({"phase": "main_path", "runs": results, "launches": launches})
    for k, v in launches.items():
        if v <= 0:
            fail(f"kernel {k} was not launched on the main path")

    # ---- apply_all by type: the sweep with one type at a time --------------
    for label, _, shape, _, ref, _ in runs:
        if ref != "apply_all":
            continue
        x = inputs[label]
        ms = {t: time_ms(torch, lambda: apply_all_transformations(x, SEED, types=(t,)), 5)
              for t in TYPES}
        emit({"phase": "apply_all_types", "run": label, "shape": [*shape, 3],
              "ms_by_type": ms, "ms_sum": sum(ms.values())})
    del inputs, refs

    # ---- kernels: each wrapper and its plain version at main-path shapes ---
    entries = []
    for kernel in KERNELS:
        if kernel == "shear_bicubic":
            shape = SHAPE_512
            x = images(torch, shape, SEED + 100)
            f = torch.from_numpy(cycled(SHEAR_GRID, shape[0])).to(x.device)
            run = lambda: rs.shear_bicubic(x, f)
            plain = lambda: rs.shear_bicubic_plain(x, f)
            b_ms, b_by = bound(*shape, 3, 3, ops_shear_bicubic(3))
            mode = "grid factors 0..1"
        else:
            traced = kernel.endswith("_traced")
            # (shape, radius, gray, stream): the main path's use of each kernel
            shape, radius, gray, stream = {
                "luma_blur_rotate": (SHAPE_512, BLUR_RADIUS, True, True),
                "luma_blur_rotate_packed": (SHAPE_32, BLUR_RADIUS, True, True),
                "rgb_blur_rotate": (SHAPE_512, BLUR_RADIUS, True, False),
                "luma_blur_rotate_traced": (SHAPE_512, BLUR_RADIUS, True, True),
                "rgb_blur_rotate_traced": (SHAPE_512, 0.0, False, False),  # apply_all
            }[kernel]
            n, h, w = shape
            x = images(torch, shape, SEED + 100)
            if traced:
                angles = (traced_angles(n) if kernel.startswith("luma")
                          else cycled(ROTATION_GRID, n))
                taps, p = mk._params(h, w, radius, 0.0, x.device)[:2]
                k1, f1, k2, f2, ident = mk._traced_params(angles, n, h, w, 25.0, x.device)
            else:
                taps, p, k1, f1, k2, f2 = mk._params(h, w, radius, ANGLE, x.device)
                ident = False
            if kernel.startswith("luma"):
                ipb = mk._images_per_block(n, h)
                run = lambda: mk.luma_blur_rotate(x, taps, p, k1, f1, k2, f2, 0, ipb)
                plain = lambda: mk.luma_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, 0)
                b_ms, b_by = bound(n, h, w, 3, 3, ops_luma(p))
            else:
                run = lambda: mk.rgb_blur_rotate(x, taps, p, k1, f1, k2, f2, 0, not stream,
                                                 gray, ident)
                plain = lambda: mk.rgb_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, 0,
                                                         not stream, gray, ident)
                b_ms, b_by = bound(n, h, w, 3, 3, ops_rgb(p, not stream, gray, False))
            mode = (("stream" if stream else "strict") + (" gray" if gray else "")
                    + f" r {radius}" + (" per-image angles" if traced else f" {ANGLE} deg"))
        entries.append({
            "name": kernel, "route": "cuda", **KERNELS[kernel],
            "launches": launches[kernel], "max_abs_err": errs[kernel],
            "ms": time_ms(torch, run, 20), "plain_ms": time_ms(torch, plain, 5),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None,
            "library_note": NO_LIBRARY.get(kernel, NO_LIBRARY_BLUR_ROTATE),
            "shape": [*shape, 3], "mode": mode,
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
