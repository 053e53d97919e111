#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``imagetransformations_tpu_torch/
csrc`` with nvcc, holds each against its plain PyTorch version on the card
at full size (0 LSB; the NEAREST rotation also against a numpy model of
Pillow's fixed point on the host, on the grid, beyond 45 degrees and on
Pillow's f64 route), drives the main paths (``build_chain_fn`` with static
and per-image angles, in strict mode (also a strict rotation of 135
degrees, on the NEAREST rotation kernel), with an affine run, a rotation
beyond 45 degrees and a photometric chain; ``fused_blur_rotate_image``; the 8-type
``apply_all_transformations`` sweep with its default flags and with the
fast scale/shear and PIL rotation; ``blur_separable``, ``rotate_3shear``,
``blur_rotate_fused`` and ``shear_rows_per_image``) at the benchmark shapes,
with rotate_3shear's middle pass on the column kernel (no transposes),
with the sweep's per-image blur on ``blur_separable_batched``, with the
rgb blur-rotate kernel's tiles held at large angles, 1 and 4 channels and
the sweep's budget edge, with the luma kernel's row bands held at large
angles, r 5, fill 255 and in another geometry (column segments, or one
band a block),
each with the launch counters reset just before it and read just after,
times each sweep type, and times each kernel beside its bound and, where
one exists, a PyTorch call that computes the same function or samples the
same way: ``ms`` a wrapper call (CUDA events), ``device_ms`` its kernels'
device time alone (torch.profiler; where a session records nothing, CUDA
events around calls queued behind a spin kernel); the rgb kernel's entries add rows
(``modes``) for stream mode, strict at radius 0 beside ``rotate_3shear``
and the sweep's use at 4096x32x32, and the BICUBIC shear's, the
bilinear zoom's and the NEAREST rotation's entries a row at 4096x32x32 (the sweeps' CIFAR use; their
parity cases add the shear budget's edge 1.05, negative factors and
random_zoom at 0.5 and 4); phase ``geometry`` times the luma kernel's
band rows and images a block at 4096x32x32 and 32x512x512.
Prints one JSON line per phase; the
last line is ``{"ok": true, "device": {...}}``. Any failure raises: the exit code is then
non-zero and no result line is printed. Without a CUDA device it exits 1.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
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
SCALE_GRID = [0.9, 1.0, 1.1, 1.2, 1.3, 1.4]
BLUR_GRID = [0.5 * i for i in range(11)]  # radius 0:0.5:5
ZOOM_BOUNDS = [0.85, 1.45]  # the fast scale's budget: scale grid min/max -+ 0.05
RANDOM_ZOOM_FACTORS = [0.5, 1.2, 4.0]  # random_zoom's kernel range [0.5, 4], and inside it
SHEAR_EDGES = [1.05, -0.3, 0.5, -1.0]  # the shear budget's edge and negative factors
APPLY_ALL_BUDGET = 23.0  # max |grid angle| + 0.5, as pipeline/batch.py routes it
STRICT_ANGLE = 135.0  # a strict rotation beyond 45 degrees: Pillow's gather (kernel #12)
ROTATION_EDGES = [60.0, -60.0, 90.0, 135.0, 180.0]  # #12's parity beyond the grid
FLOAT_PATH_SHAPE = (1, 3, 40000)  # (n, h, w): Pillow's f64 route (every corner past 32768)
PER_IMAGE_PAD = 20  # shear_rows_per_image's pad_px on the main path (shifts to +-30)
# apply_all's flags by main-path run kind
SWEEP_FLAGS = {
    "apply_all": {},
    "apply_all_fast": {"pil_parity_scale_shear": False, "pil_parity_rotation": True},
}

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
    "shear_rows_logrouted": dict(
        source="imagetransformations_tpu_torch/csrc/shear_rows.cu",
        replaces="imagetransformations_tpu/ops/pallas/shear.py:446",
    ),
    "zoom_bilinear": dict(
        source="imagetransformations_tpu_torch/csrc/zoom_bilinear.cu",
        replaces="imagetransformations_tpu/ops/pallas/resample.py:86",
        also_replaces="imagetransformations_tpu/ops/pallas/resample.py:96",
    ),
    "pil_rotate_nearest": dict(
        source="imagetransformations_tpu_torch/csrc/rotate_nearest.cu",
        replaces="imagetransformations_tpu/ops/pallas/rotate_gather.py:76",
    ),
    "blur_separable": dict(
        source="imagetransformations_tpu_torch/csrc/blur_separable.cu",
        replaces="imagetransformations_tpu/ops/pallas/blur.py:36",
    ),
    # apply_all's per-image blur: kernel #6 with a tap row an image (the JAX
    # package runs it through XLA, ops/stencil.py:109-114)
    "blur_separable_batched": dict(
        source="imagetransformations_tpu_torch/csrc/blur_separable.cu",
        replaces="imagetransformations_tpu/ops/pallas/blur.py:36",
    ),
    "shear_rows": dict(
        source="imagetransformations_tpu_torch/csrc/shear_rows.cu",
        replaces="imagetransformations_tpu/ops/pallas/shear.py:67",
    ),
    "shear_rows_per_image": dict(
        source="imagetransformations_tpu_torch/csrc/shear_rows.cu",
        replaces="imagetransformations_tpu/ops/pallas/shear.py:182",
    ),
    # rotate_3shear's middle pass: kernel #7 on a transposed slab in JAX
    # (ops/pallas/shear.py:388,392), a column shift in place here. Its
    # wrapper counts under "shear_cols" and under "shear_rows" (the pass of
    # #7 it carries); the kernels line gives #7 the row launches alone.
    "shear_cols": dict(
        source="imagetransformations_tpu_torch/csrc/shear_rows.cu",
        replaces="imagetransformations_tpu/ops/pallas/shear.py:67",
    ),
}
COL_PASS = "shear_cols"
# why no single PyTorch call is timed beside a kernel (library_ms null)
NO_LIBRARY = {
    "shear_bicubic": "grid_sample(mode='bicubic') uses A=-0.75 and other borders; "
                     "PIL's cubic is A=-1 with white fill",
}
NO_LIBRARY_BLUR_ROTATE = "no single PyTorch call computes blur + 3-shear rotation"
# the PyTorch call timed beside a gather kernel (library_ms)
LIBRARY_NOTE = ("F.grid_sample(mode={mode}, padding_mode='zeros', align_corners=False) on the "
                "f32 NCHW batch, grid precomputed outside the timed region: samples the same "
                "points up to border and rounding rules, not bit-equal; f32 in and out")
BLUR_LIBRARY_NOTE = ("F.conv2d of the KxK outer product of the taps, groups=3, on the reflect-"
                     "padded f32 NCHW batch (padding outside the timed region), TF32 off: the "
                     "same filter summed in another order, not bit-equal; f32 in and out")
BLUR_BATCHED_LIBRARY_NOTE = (
    "F.conv2d of each image's 31x31 outer product of its zero-padded tap row, groups=3n, on "
    "the reflect-padded f32 batch as one [1, 3n, h+30, w+30] image (padding outside the timed "
    "region), TF32 off: the same filters summed in another order, not bit-equal; f32 in and out")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def images(torch, shape, seed, c=3):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randint(0, 256, (*shape, c), generator=g, device="cuda", dtype=torch.uint8)


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


def device_ms(torch, fn, reps: int) -> float:
    """Mean device time of one fn() call: the self time of every CUDA kernel
    it launches, under torch.profiler, over `reps` calls after two warm-up
    calls. Host time between launches is not counted, so for a kernel
    faster than its wrapper's host overhead this is the kernel's time, where
    ``time_ms`` is the wrapper's. torch.profiler at times stops recording
    within a process (PERF.md section 7); where a session records no device
    time, ``held_ms`` takes it instead."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0) or 0 for e in prof.key_averages()
             if str(getattr(e, "device_type", "")).endswith("CUDA"))
    if us > 0:
        return us / reps / 1e3
    print("chip_smoke: torch.profiler recorded no device time; CUDA events on a held stream",
          file=sys.stderr, flush=True)
    return held_ms(torch, fn, reps)


def held_ms(torch, fn, reps: int) -> float:
    """Mean device time of one fn() call without the profiler: a spin kernel
    holds the stream while the host queues `reps` calls between two CUDA
    events, so the card runs them back to back and the events time the
    kernels (and the gaps between launches, ~1 us) but no host time. The
    hold grows until the start event is still pending when the last call
    is queued; fails if it never is."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    cycles = 20_000_000  # ~10 ms at the H100's clock
    for _ in range(4):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        held = not start.query()
        torch.cuda.synchronize()
        if held:
            return start.elapsed_time(end) / reps
        cycles *= 4
    fail("no device time: torch.profiler recorded none, and the host did not queue "
         f"{reps} calls within a held stream")


def row_launches(launches: dict, kernel: str) -> int:
    """A kernel's launches in ``launches`` (the wrappers' counters), with
    "shear_rows" its row passes alone: the column pass's wrapper counts
    under both keys, and each kernel of a run must launch on its own."""
    if kernel == "shear_rows":
        return launches["shear_rows"] - launches[COL_PASS]
    return launches[kernel]


def max_lsb(torch, a, b) -> int:
    if a.shape != b.shape or a.dtype != b.dtype:
        fail(f"shape/dtype mismatch {tuple(a.shape)} {a.dtype} vs {tuple(b.shape)} {b.dtype}")
    return int((a.to(torch.int16) - b.to(torch.int16)).abs().max().item())


def bound(n, h, w, c_in, c_out, ops_per_px):
    """(bound_ms, bound_by): each u8 input byte read once and each output
    byte written once over HBM bandwidth, against the operations (none
    fused) over the unfused issue rate."""
    px = n * h * w
    return bound_of(px * (c_in + c_out), px * ops_per_px)


def bound_of(nbytes, ops):
    """(bound_ms, bound_by) of a call that must move ``nbytes`` and do
    ``ops`` unfused operations."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / UNFUSED_OPS_PER_S
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


def ops_blur(k: int) -> int:
    # per value: cvt, K mul + K-1 add a pass (two passes), rint, clip (2), cvt
    return 1 + 2 * (2 * k - 1) + 4


def bound_blur_batched(torch, x, radii):
    """Per-image blur: each image at radius r > 0 does ops_blur(K) a value
    with its own K; an image at radius 0 is a copy (no operations). Reads
    the batch and the [n, 31] f32 tap rows, writes the batch."""
    from imagetransformations_tpu_torch.ops import stencil as st

    n, h, w, c = x.shape
    taps = st.blur_taps_batched(radii)
    k = (taps != 0).sum(1)
    ops = int(torch.where(radii > 0, 4 * k + 3, 0).sum().item()) * h * w * c
    return bound_of(2 * x.numel() + taps.numel() * 4, ops)


# The gather kernels read only the source pixels their taps touch, which
# depends on the parameters: each bound counts the source bytes this run's
# parameters need (each read once), every output byte, and the parameters.


def bound_shear_rows(torch, x, shifts, b_px):
    """Row shift: per value two u8->f32 conversions, the lerp (3), trunc and
    conversion (2); per pixel the window test (index add, 2 compares); per
    row floor, sub, clamp (2) and conversion. Reads columns max(0, k) ..
    min(w-1, w+k) of each row."""
    n, h, w, c = x.shape
    k = torch.clamp(torch.floor(shifts), -b_px, b_px)
    cols = torch.clamp(torch.clamp(w + k, max=w - 1) - torch.clamp(k, min=0) + 1, min=0)
    nbytes = int(cols.sum().item()) * c + n * h * w * c + shifts.numel() * 4
    return bound_of(nbytes, n * h * w * (7 * c + 3) + n * h * 5)


def bound_shear_cols(torch, x, shifts, b_px):
    """Column pass: ``bound_shear_rows`` with h in the place of w, one
    shift a column for the batch. Reads rows max(0, k) .. min(h-1, h+k) of
    each column of each image."""
    n, h, w, c = x.shape
    k = torch.clamp(torch.floor(shifts), -b_px, b_px)
    rows = torch.clamp(torch.clamp(h + k, max=h - 1) - torch.clamp(k, min=0) + 1, min=0)
    nbytes = n * int(rows.sum().item()) * c + n * h * w * c + shifts.numel() * 4
    return bound_of(nbytes, n * h * w * (7 * c + 3) + w * 5)


def bound_shear_bicubic(torch, x, factors):
    """PIL BICUBIC shear: reads the source bytes its valid pixels' taps
    touch (columns [x0(first valid) - 1, x0(last valid) + 2] of each row,
    within the row) and the factors, writes every output byte. Operations:
    per pixel the coordinate and its test (2 adds, 2 compares); per valid
    pixel xin, floor and fx (3); per valid value the cubic (p2 1, p3 4, p4
    3, Horner 6), the clip (2) and the trunc (1); one u8 -> f32 conversion
    a source value read; per row t (2), per image m2 (2)."""
    n, h, w, c = x.shape
    s = factors.reshape(n, 1, 1)
    m2 = -torch.where(s > 0, torch.ceil(s * float(h)), 0.0)
    xo = torch.arange(w, dtype=torch.float32, device=x.device).view(1, 1, w) + 0.5
    yo = torch.arange(h, dtype=torch.float32, device=x.device).view(1, h, 1) + 0.5
    xx = (xo + s * yo) + m2
    valid = (xx >= 0) & (xx < w)
    x0 = torch.floor(xx - 0.5)
    lo = torch.where(valid, x0, float(w)).amin(-1) - 1  # x0 is monotone along a row
    hi = torch.where(valid, x0, -1.0).amax(-1) + 2
    cols = torch.where(valid.any(-1), hi.clamp(max=w - 1) - lo.clamp(min=0) + 1, 0.0)
    touched = int(cols.sum().item()) * c
    nvalid = int(valid.sum().item())
    ops = n * h * w * 4 + nvalid * (3 + 17 * c) + touched + n * h * 2 + n * 2
    return bound_of(touched + n * h * w * c + n * 4, ops)


def bound_zoom(torch, x, factors):
    """Bilinear zoom: reads the rows and columns its taps touch. Operations:
    one u8 -> f32 conversion a source value read; per valid value three
    lerps (9) and the trunc (1: both lerps stay within their u8 ends, so
    no clip binds); per pixel the joint validity; per column and per row
    of each image the axis terms (15); per image 1/f and m (5)."""
    from imagetransformations_tpu_torch.ops.hopper.resample import zoom_axis

    n, h, w, c = x.shape
    inv = 1.0 / factors.reshape(n, 1)

    def touched(dim):
        i0, i1, _, valid = zoom_axis(inv, dim)
        hits = torch.zeros((n, dim), dtype=torch.int32, device=x.device)
        hits.scatter_add_(1, i0, valid.to(torch.int32))
        hits.scatter_add_(1, i1, valid.to(torch.int32))
        return (hits > 0).sum(1), valid.sum(1)

    (tw, vw), (th, vh) = touched(w), touched(h)
    read = int((tw * th).sum().item()) * c
    nbytes = read + n * h * w * c + n * 4
    axes = n * (h + w) * 15 + n * 5
    nvalid = int((vw * vh).sum().item()) * c
    return bound_of(nbytes, read + nvalid * 10 + n * h * w + axes)


def bound_rotate(torch, x, coeffs):
    """Pillow's fixed-point NEAREST rotation: per pixel two adds and two
    shifts (the 16.16 coordinates), the window test (2 unsigned compares
    and an and), the source address (2), and a select a value; per row the
    accumulators' start (4). Reads the source pixels that land inside the
    output (from the same integers) and the int32 coefficients."""
    from imagetransformations_tpu_torch.ops.hopper.rotate_gather import _wrap_shift

    n, h, w, c = x.shape
    k = coeffs.to(torch.int64).expand(n, 6).reshape(n, 6, 1, 1)
    xs = torch.arange(w, dtype=torch.int64, device=x.device).view(1, 1, w)
    ys = torch.arange(h, dtype=torch.int64, device=x.device).view(1, h, 1)
    xi = _wrap_shift(k[:, 2] + ys * k[:, 1] + xs * k[:, 0])
    yi = _wrap_shift(k[:, 5] + ys * k[:, 4] + xs * k[:, 3])
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    idx = torch.where(valid, yi * w + xi, 0).reshape(n, -1)
    hits = torch.zeros((n, h * w), dtype=torch.int32, device=x.device)
    hits.scatter_add_(1, idx, valid.reshape(n, -1).to(torch.int32))
    nbytes = int((hits > 0).sum().item()) * c + n * h * w * c + coeffs.numel() * 4
    return bound_of(nbytes, n * h * w * (9 + c) + n * h * 4)


def rotate_coeffs(torch, angles, w, h, device):
    """int32 [n, 6] Pillow coefficients of host angles, on ``device``."""
    from imagetransformations_tpu_torch.ops.hopper.rotate_gather import pil_rotate_coeffs

    co = pil_rotate_coeffs(angles, w, h)
    if co.flagged.any():
        fail(f"angles {angles} at {w}x{h} take Pillow's float path")
    return torch.from_numpy(co.fixed).to(device)


def rotate_model(x, coeffs, fill, fp=None):
    """Pillow's NEAREST rotation in numpy on the host, written apart from
    the port's plain version: x u8 [n, h, w, c], coeffs int32 [n, 6]; the
    flagged images (``fp``: indices, f64 row starts [m, h, 2], per-pixel
    steps [m, 2]) by sequential f64 adds along each row."""
    import numpy as np

    n, h, w, c = x.shape
    k = np.broadcast_to(np.asarray(coeffs, np.int64), (n, 6)).reshape(n, 6, 1, 1)
    ys, xs = np.arange(h, dtype=np.int64).reshape(1, h, 1), np.arange(w, dtype=np.int64)

    def fixed(i0, i1, i2):
        v = k[:, i2] + ys * k[:, i1] + xs.reshape(1, 1, w) * k[:, i0]
        return ((v + 2**31) % 2**32 - 2**31) >> 16

    xi, yi = fixed(0, 1, 2), fixed(3, 4, 5)
    if fp is not None:
        images, rows, steps = (np.asarray(t) for t in fp)
        for j, img in enumerate(images.tolist()):
            seq = np.empty((h, w, 2))
            seq[:, 0] = rows[j]
            seq[:, 1:] = steps[j]
            acc = np.add.accumulate(seq, axis=1)  # one add a pixel, in order
            okf = (acc >= 0).all(-1) & (acc[..., 0] < w) & (acc[..., 1] < h)
            xi[img] = np.where(okf, acc[..., 0], -1).astype(np.int64)
            yi[img] = np.where(okf, acc[..., 1], -1).astype(np.int64)
    ok = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    out = np.full_like(x, fill)
    nn = np.broadcast_to(np.arange(n).reshape(n, 1, 1), ok.shape)
    out[ok] = x[nn[ok], yi[ok], xi[ok]]
    return out


def grid_sample_call(torch, x, src_x, src_y, mode):
    """A call of F.grid_sample that samples x (NHWC u8) at continuous
    source coordinates (pixel-centre units, [n, h, w] each) with ``mode``;
    the f32 NCHW input and the grid are made here, outside the call."""
    n, h, w, _ = x.shape
    xf = x.permute(0, 3, 1, 2).to(torch.float32).contiguous()
    grid = torch.stack([2.0 * src_x / w - 1.0, 2.0 * src_y / h - 1.0], dim=-1).contiguous()
    return lambda: torch.nn.functional.grid_sample(xf, grid, mode=mode, padding_mode="zeros",
                                                   align_corners=False)


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
    """The main paths as a user calls them, one entry per run:
    (label, fn, shape, seed, ref, reps, kernels). ``ref`` names the parity
    case whose plain output the run's output must equal (same seed, same
    inputs), or is a key of SWEEP_FLAGS for the sweeps, whose
    kernel-carried types are held against the plain versions on the values
    the sweep drew, or is a callable that computes the run's plain
    composition from its input. ``kernels`` are the launch counters the run
    must raise. tools/profile_torch_port.py profiles the same runs."""
    import torch

    from imagetransformations_tpu_torch import (
        OpSpec,
        apply_all_transformations,
        build_chain_fn,
        fused_blur_rotate_image,
    )
    from imagetransformations_tpu_torch.ops import elementwise as ew
    from imagetransformations_tpu_torch.ops import histogram as hg
    from imagetransformations_tpu_torch.ops import stencil as st
    from imagetransformations_tpu_torch.ops import warp as wp
    from imagetransformations_tpu_torch.ops.hopper import blur as bl
    from imagetransformations_tpu_torch.ops.hopper import rotate_gather as rg
    from imagetransformations_tpu_torch.ops.hopper import shear as sh

    blur, gray = OpSpec("blur", {"radius": BLUR_RADIUS}), OpSpec("grayscale")
    rotation = OpSpec("rotation", {"angle": ANGLE})
    fn_gray, fn_rgb = build_chain_fn([blur, rotation, gray]), build_chain_fn([blur, rotation])
    # bench.py's traced-angle shape: one angle an image, linspace(-22.5, 22.5)
    fn_traced = build_chain_fn(
        [blur, OpSpec("rotation", {"angle": traced_angles(SHAPE_512[0])}), gray])
    fn_strict = build_chain_fn([blur, rotation, gray], strict_parity=True)
    fn_rot135 = build_chain_fn([OpSpec("rotation", {"angle": STRICT_ANGLE})], strict_parity=True)
    affine = [OpSpec("translation", {"tx": 12, "ty": -7}), OpSpec("zoom", {"factor": 1.2}),
              OpSpec("rotation", {"angle": 10.0})]
    fn_affine = build_chain_fn(affine)
    fn_rot60 = build_chain_fn([OpSpec("rotation", {"angle": 60.0})])
    photometric = [("brightness", {"factor": 0.05}), ("contrast", {"alpha": 1.2}),
                   ("sharpness", {"factor": 1.5}), ("histogram_equalization", {}),
                   ("invert", {})]
    fn_photo = build_chain_fn([OpSpec(n, p) for n, p in photometric])
    n, h, _ = SHAPE_512
    per_image_shifts = per_image_row_shifts(torch, n, h, "cuda")

    def strict(x):
        return fused_blur_rotate_image(x, BLUR_RADIUS, ANGLE, grayscale_out=True, stream=False)

    def sweep(x):
        return apply_all_transformations(x, SEED)

    def sweep_fast(x):
        return apply_all_transformations(x, SEED, **SWEEP_FLAGS["apply_all_fast"])

    def strict_plain(x):
        k = rotate_coeffs(torch, ANGLE, x.shape[2], x.shape[1], x.device)
        return ew.grayscale(rg.pil_rotate_nearest_plain(st.gaussian_blur_plain(x, BLUR_RADIUS),
                                                        k, 0))

    def rot135_plain(x):
        return rg.pil_rotate_nearest_plain(
            x, rotate_coeffs(torch, STRICT_ANGLE, x.shape[2], x.shape[1], x.device), 0)

    def affine_plain(x):
        w, h = x.shape[2], x.shape[1]
        m = wp.translation_matrix(12, -7, device=x.device)
        m = wp.compose_matrices(wp.zoom_matrix(1.2, w, h, device=x.device), m)
        m = wp.compose_matrices(wp.rotation_matrix(10.0, w, h, device=x.device), m)
        return wp.affine_warp(x, m, method="bilinear", fill=0.0)

    def rot60_plain(x):
        m = wp.rotation_matrix(60.0, x.shape[2], x.shape[1], device=x.device)
        return wp.affine_warp(x, m, method="bilinear", fill=0.0)

    def photo_plain(x):
        x = ew.apply_contrast(ew.apply_brightness(x, 0.05), 1.2)
        return ew.invert(hg.histogram_equalization(st.sharpen(x, 1.5)))

    return [
        ("chain blur>rotate>gray 512", fn_gray, SHAPE_512, SEED + 0, (SHAPE_512, True, True), 20,
         ("luma_blur_rotate",)),
        ("chain blur>rotate>gray 224", fn_gray, SHAPE_224, SEED + 1, (SHAPE_224, True, True), 20,
         ("luma_blur_rotate",)),
        ("chain blur>rotate>gray 32 (cifar)", fn_gray, SHAPE_32, SEED + 3,
         (SHAPE_32, True, True), 20, ("luma_blur_rotate_packed",)),
        ("chain blur>rotate 512", fn_rgb, SHAPE_512, SEED + 4, (SHAPE_512, False, True), 10,
         ("rgb_blur_rotate",)),
        ("fused_blur_rotate_image strict gray 512", strict, SHAPE_512, SEED + 5,
         (SHAPE_512, True, False), 10, ("rgb_blur_rotate",)),
        ("chain blur>rotate(per-image angles)>gray 512", fn_traced, SHAPE_512, SEED + 20,
         "traced gray 512", 20, ("luma_blur_rotate_traced",)),
        ("apply_all_transformations 512", sweep, SHAPE_512, SEED + 30, "apply_all", 5,
         ("rgb_blur_rotate_traced", "shear_bicubic", "blur_separable_batched")),
        ("apply_all_transformations 32 (cifar)", sweep, SHAPE_32, SEED + 31, "apply_all", 5,
         ("rgb_blur_rotate_traced", "shear_bicubic", "blur_separable_batched")),
        ("apply_all_transformations fast+pil-rotation 512", sweep_fast, SHAPE_512, SEED + 32,
         "apply_all_fast", 5, ("shear_rows_logrouted", "zoom_bilinear", "pil_rotate_nearest",
                               "blur_separable_batched")),
        ("apply_all_transformations fast+pil-rotation 32 (cifar)", sweep_fast, SHAPE_32,
         SEED + 33, "apply_all_fast", 5,
         ("shear_rows_logrouted", "zoom_bilinear", "pil_rotate_nearest",
          "blur_separable_batched")),
        ("chain strict blur>rotate>gray 512", fn_strict, SHAPE_512, SEED + 40, strict_plain, 10,
         ("blur_separable", "pil_rotate_nearest")),
        ("chain strict rotation 135 512", fn_rot135, SHAPE_512, SEED + 48, rot135_plain, 10,
         ("pil_rotate_nearest",)),
        ("chain rotation 60 512", fn_rot60, SHAPE_512, SEED + 41, rot60_plain, 5, ()),
        ("chain affine translation>zoom>rotation(10) 512", fn_affine, SHAPE_512, SEED + 42,
         affine_plain, 5, ()),
        ("chain photometric 512", fn_photo, SHAPE_512, SEED + 43, photo_plain, 5, ()),
        ("blur_separable 512 r1.5", lambda x: bl.blur_separable(x, BLUR_RADIUS), SHAPE_512,
         SEED + 44, lambda x: st.gaussian_blur_plain(x, BLUR_RADIUS), 20, ("blur_separable",)),
        ("rotate_3shear 512 15deg", lambda x: sh.rotate_3shear(x, ANGLE), SHAPE_512, SEED + 45,
         lambda x: sh.rotate_3shear_plain(x, ANGLE), 20, ("shear_rows", COL_PASS)),
        ("blur_rotate_fused gray 512",
         lambda x: sh.blur_rotate_fused(x, BLUR_RADIUS, ANGLE, grayscale_out=True), SHAPE_512,
         SEED + 46, lambda x: sh.blur_rotate_fused_plain(x, BLUR_RADIUS, ANGLE,
                                                         grayscale_out=True), 20,
         ("blur_separable", "shear_rows", COL_PASS)),
        ("shear_rows_per_image 512",
         lambda x: sh.shear_rows_per_image(x, per_image_shifts, fill=255, pad_px=PER_IMAGE_PAD),
         SHAPE_512, SEED + 47,
         lambda x: sh.shear_rows_plain(x, per_image_shifts, 255, PER_IMAGE_PAD), 20,
         ("shear_rows_per_image",)),
    ]


def per_image_row_shifts(torch, n: int, h: int, device):
    """[n, h] f32 row shifts, uniform in +-30 px from a seed: beyond
    PER_IMAGE_PAD on part of the rows, so saturation is exercised."""
    g = torch.Generator(device=device).manual_seed(SEED + 7)
    return ((torch.rand((n, h), generator=g, device=device) - 0.5) * 60.0).contiguous()


def check_sweep(torch, x, res, kind: str) -> dict:
    """The 8 types, their shapes and types; the types that kernels carry
    (blur, rotation and shear; with the fast flags also scale) at 0 LSB
    against the plain versions on the values the sweep drew; the noise
    changes the image. Returns the LSB of each checked type."""
    from imagetransformations_tpu_torch.ops import stencil as st
    from imagetransformations_tpu_torch.ops import warp as wp
    from imagetransformations_tpu_torch.ops.hopper import megakernel as mk
    from imagetransformations_tpu_torch.ops.hopper import resample as rs
    from imagetransformations_tpu_torch.ops.hopper import rotate_gather as rg
    from imagetransformations_tpu_torch.ops.hopper import shear as sh
    from imagetransformations_tpu_torch.pipeline import batch
    from imagetransformations_tpu_torch.pipeline.batch import TYPES

    n, h, w, _ = x.shape
    if set(res) != set(TYPES):
        fail(f"apply_all returned {sorted(res)}")
    for t, (values, out) in res.items():
        if values.shape != (n,) or out.shape != x.shape or out.dtype != torch.uint8:
            fail(f"apply_all {t}: values {tuple(values.shape)}, out {tuple(out.shape)} {out.dtype}")
        if out.device != x.device:
            fail(f"apply_all {t}: output on {out.device}")
    plain = {"blur": st.blur_batched_plain(x, res["blur"][0])}
    values = res["rotation"][0]
    if kind == "apply_all_fast":
        plain["rotation"] = rg.pil_rotate_nearest_plain(
            x, rotate_coeffs(torch, values.cpu().numpy(), w, h, x.device), 0)
        values = res["shear"][0]
        bound_px = batch.fast_shear_budget(max(SHEAR_GRID), h)
        plain["shear"] = sh.shear_rows_plain(
            x, batch.fast_shear_shifts(values, h, x.device), 255, min(bound_px + 1, w + 2))
        plain["scale"] = rs.zoom_bilinear_plain(x, res["scale"][0])
    else:
        taps, p = mk._params(h, w, 0.0, 0.0, x.device)[:2]
        k1, f1, k2, f2, ident = mk._traced_params(values, n, h, w, APPLY_ALL_BUDGET, x.device)
        plain["rotation"] = mk.rgb_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, 0, True, False,
                                                     ident)
        plain["shear"] = rs.shear_bicubic_plain(x, res["shear"][0])
    lsb = {t: max_lsb(torch, res[t][1], ref) for t, ref in plain.items()}
    for t, v in lsb.items():
        if v != 0:
            fail(f"apply_all {t} differs from its plain version by {v} LSB")
    if torch.equal(res["gaussian_noise"][1], x):
        fail("apply_all gaussian_noise left the images unchanged")
    return lsb


def rgb_modes(torch, mk, sh, kernel, run_launches) -> list:
    """The kernels line's further rows of the tile kernel, each held at 0
    LSB against the plain version: #3 in stream mode (the chain's use) and
    strict at radius 0 beside ``rotate_3shear``, the same function by three
    row / column launches, on the same batch; #5 at 4096x32x32 (apply_all's
    CIFAR use). launches: the main-path run's count (0: no run uses it)."""
    rows = []
    if kernel == "rgb_blur_rotate":
        n, h, w = SHAPE_512
        x = images(torch, SHAPE_512, SEED + 102)
        for radius, stream, run_label in ((BLUR_RADIUS, True, "chain blur>rotate 512"),
                                          (0.0, False, None)):
            taps, p, k1, f1, k2, f2 = mk._params(h, w, radius, ANGLE, x.device)
            slopes = mk.slope_bound(ANGLE)
            run = lambda: mk.rgb_blur_rotate(x, taps, p, k1, f1, k2, f2, 0, not stream, False,
                                             False, slopes=slopes)
            want = mk.rgb_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, 0, not stream, False,
                                            False)
            row = mode_row(torch, ("stream" if stream else "strict") + f" r {radius} {ANGLE} deg",
                           SHAPE_512, run, want, bound(n, h, w, 3, 3, ops_rgb(p, not stream,
                                                                           False, False)),
                           run_launches.get(run_label, {}).get(kernel, 0))
            if not stream:
                r3 = lambda: sh.rotate_3shear(x, ANGLE)
                if max_lsb(torch, r3(), want) != 0:
                    fail("rotate_3shear differs from the strict r 0 tile kernel")
                row["rotate_3shear_ms"] = time_ms(torch, r3, 20)
                row["rotate_3shear_device_ms"] = device_ms(torch, r3, 20)
            rows.append(row)
    else:
        n, h, w = SHAPE_32
        x = images(torch, SHAPE_32, SEED + 103)
        taps, p = mk._params(h, w, 0.0, 0.0, x.device)[:2]
        k1, f1, k2, f2, ident = mk._traced_params(cycled(ROTATION_GRID, n), n, h, w, 25.0,
                                                  x.device)
        slopes = mk.budget_slope_bound(25.0)
        run = lambda: mk.rgb_blur_rotate(x, taps, p, k1, f1, k2, f2, 0, True, False, ident,
                                         slopes=slopes)
        want = mk.rgb_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, 0, True, False, ident)
        rows.append(mode_row(torch, "strict r 0 per-image angles (apply_all)", SHAPE_32, run,
                             want, bound(n, h, w, 3, 3, ops_rgb(0, True, False, False)),
                             run_launches.get("apply_all_transformations 32 (cifar)",
                                              {}).get(kernel, 0)))
    return rows


def resample_modes(torch, rs, kernel, run_launches) -> list:
    """The kernels line's further row of #10 / #11: the sweep's use at
    4096x32x32 (the scale grid or the shear grid cycled over the batch),
    held at 0 LSB against the plain version, with the plain version's time
    and F.grid_sample's (bilinear, #10 only); launches from that sweep's
    main-path run."""
    n, h, w = SHAPE_32
    x = images(torch, SHAPE_32, SEED + 104)
    library = None  # no single PyTorch call for the BICUBIC shear (NO_LIBRARY)
    if kernel == "shear_bicubic":
        f = torch.from_numpy(cycled(SHEAR_GRID, n)).to(x.device)
        run, plain = lambda: rs.shear_bicubic(x, f), lambda: rs.shear_bicubic_plain(x, f)
        b, label = bound_shear_bicubic(torch, x, f), "apply_all_transformations 32 (cifar)"
        mode = "grid factors 0..1"
    else:
        f = torch.from_numpy(cycled(SCALE_GRID, n)).to(x.device)
        run, plain = lambda: rs.zoom_bilinear(x, f), lambda: rs.zoom_bilinear_plain(x, f)
        b = bound_zoom(torch, x, f)
        label = "apply_all_transformations fast+pil-rotation 32 (cifar)"
        mode = "scale grid factors 0.9..1.4"
        xo = torch.arange(w, dtype=torch.float32, device=x.device).view(1, 1, w) + 0.5
        yo = torch.arange(h, dtype=torch.float32, device=x.device).view(1, h, 1) + 0.5
        inv = (1.0 / f).view(n, 1, 1)
        library = grid_sample_call(torch, x, (inv * xo + (w / 2.0 - inv * (w / 2.0))).expand(n, h, w),
                                   (inv * yo + (h / 2.0 - inv * (h / 2.0))).expand(n, h, w),
                                   "bilinear")
    row = mode_row(torch, mode, SHAPE_32, run, plain(), b,
                   run_launches.get(label, {}).get(kernel, 0))
    row["plain_ms"] = time_ms(torch, plain, 5)
    row["library_ms"] = None if library is None else time_ms(torch, library, 20)
    return [row]


def rotate_library_call(torch, x, coeffs):
    """F.grid_sample (nearest) at the 16.16 coordinates of ``coeffs``,
    taken as f32 pixel positions."""
    n, h, w, _ = x.shape
    k = coeffs.to(torch.float64).view(n, 6, 1, 1)
    xs = torch.arange(w, dtype=torch.float64, device=x.device).view(1, 1, w)
    ys = torch.arange(h, dtype=torch.float64, device=x.device).view(1, h, 1)
    sx = ((k[:, 2] + ys * k[:, 1] + xs * k[:, 0]) / 65536.0).to(torch.float32)
    sy = ((k[:, 5] + ys * k[:, 4] + xs * k[:, 3]) / 65536.0).to(torch.float32)
    return grid_sample_call(torch, x, sx, sy, "nearest")


def rotate_modes(torch, rg, run_launches) -> list:
    """The kernels line's further row of #12: the fast sweep's use at
    4096x32x32 (the rotation grid cycled over the batch), held at 0 LSB
    against the plain version; launches from that sweep's main-path run."""
    n, h, w = SHAPE_32
    x = images(torch, SHAPE_32, SEED + 105)
    k = rotate_coeffs(torch, cycled(ROTATION_GRID, n), w, h, x.device)
    row = mode_row(torch, "rotation grid angles -22.5..22.5, fill 0", SHAPE_32,
                   lambda: rg.pil_rotate_nearest(x, k, 0), rg.pil_rotate_nearest_plain(x, k, 0),
                   bound_rotate(torch, x, k),
                   run_launches.get("apply_all_transformations fast+pil-rotation 32 (cifar)",
                                    {}).get("pil_rotate_nearest", 0))
    row["plain_ms"] = time_ms(torch, lambda: rg.pil_rotate_nearest_plain(x, k, 0), 5)
    row["library_ms"] = time_ms(torch, rotate_library_call(torch, x, k), 20)
    return [row]


def mode_row(torch, mode, shape, run, want, b, launches) -> dict:
    err = max_lsb(torch, run(), want)
    if err != 0:
        fail(f"{mode} {shape}: the kernel differs from its plain version by {err} LSB")
    return {"mode": mode, "shape": [*shape, 3], "ms": time_ms(torch, run, 20),
            "device_ms": device_ms(torch, run, 20), "bound_ms": b[0], "bound_by": b[1],
            "launches": launches, "max_abs_err": err}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from imagetransformations_tpu_torch import apply_all_transformations, fused_blur_rotate_image
    from imagetransformations_tpu_torch.ops.hopper import _lib
    from imagetransformations_tpu_torch.ops.hopper import megakernel as mk
    from imagetransformations_tpu_torch.ops import warp as wp
    from imagetransformations_tpu_torch.ops.hopper import resample as rs
    from imagetransformations_tpu_torch.ops.hopper import rotate_gather as rg
    from imagetransformations_tpu_torch.ops.hopper import shear as sh
    from imagetransformations_tpu_torch.ops.hopper import blur as bl
    from imagetransformations_tpu_torch.ops import stencil as st
    from imagetransformations_tpu_torch.pipeline import batch
    from imagetransformations_tpu_torch.pipeline.batch import TYPES

    # no TF32 anywhere: the conv2d yardstick and any matrix product stay f32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

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
        # the luma kernel beyond 45 degrees (shift windows of whole rows near
        # 180), at r 5 (p 15: the ring of X rows) and fill 255, and the
        # blur-only gray chain (r 1.5, angle 0); after the cases above, whose
        # seeds (SEED + index) the main-path runs share
        ("luma_blur_rotate", SHAPE_512, BLUR_RADIUS, 60.0, 0, True, True),
        ("luma_blur_rotate", SHAPE_512, 5.0, 135.0, 255, True, True),
        ("luma_blur_rotate", SHAPE_512, BLUR_RADIUS, 170.0, 255, True, True),
        ("luma_blur_rotate", SHAPE_512, BLUR_RADIUS, 0.0, 0, True, True),
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
        if kernel.startswith("luma"):
            # other geometries give the same bytes: one image a block for
            # the packed route, column segments (sub-bands where the shifts
            # spread) for whole rows
            g = mk._luma_geometry(h, w, p)
            other = (g._replace(groups=1) if g.groups > 1 else
                     g._replace(seg_w=128, win=128 + 2, threads=33, groups=1))
            row["geometry"], row["other_geometry"] = list(g), list(other)
            alt = mk.luma_blur_rotate(x, taps, p, k1, f1, k2, f2, fill, geometry=other)
            row["max_lsb_vs_other_geometry"] = max_lsb(torch, out, alt)
            err = max(err, row["max_lsb_vs_other_geometry"])
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
            g = mk._luma_geometry(h, w, p)
            kern = mk.luma_blur_rotate(x, taps, p, k1, f1, k2, f2, 0)
            plain = mk.luma_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, 0)
            row["geometry"] = list(g)
            if g.groups > 1:
                one = mk.luma_blur_rotate(x, taps, p, k1, f1, k2, f2, 0,
                                          geometry=g._replace(groups=1))
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

    # the tile kernel at large angles (its footprint grows toward the k clip,
    # the tiles shrink and R1 is cut into chunks) and at 1 and 4 channels;
    # each case: (shape, c, radius, angle, fill, gray, stream)
    tile_cases = [
        (SHAPE_512, 3, BLUR_RADIUS, 45.0, 0, True, False),
        (SHAPE_512, 3, BLUR_RADIUS, 90.0, 0, False, True),
        (SHAPE_512, 3, 0.0, 135.0, 255, False, False),
        (SHAPE_512, 3, BLUR_RADIUS, 170.0, 128, False, False),
        (SHAPE_224, 1, BLUR_RADIUS, ANGLE, 0, False, False),
        (SHAPE_224, 4, 5.0, -30.0, 7, False, True),
    ]
    for i, (shape, c, radius, angle, fill, gray, stream) in enumerate(tile_cases):
        x = images(torch, shape, SEED + 60 + i, c)
        n, h, w = shape
        before = mk.LAUNCHES["rgb_blur_rotate"]
        out = fused_blur_rotate_image(x, radius, angle, fill=fill, grayscale_out=gray,
                                      stream=stream)
        if mk.LAUNCHES["rgb_blur_rotate"] != before + 1:
            fail(f"tile case {i} did not route to rgb_blur_rotate: {mk.LAUNCHES}")
        taps, p, k1, f1, k2, f2 = mk._params(h, w, radius, angle, x.device)
        plain = mk.rgb_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, fill, not stream, gray,
                                         angle == 0.0)
        t = mk._tiling(h, w, p, c, mk.slope_bound(angle))
        torch.cuda.synchronize()
        err = max_lsb(torch, out, plain)
        emit({"phase": "parity", "kernel": "rgb_blur_rotate", "shape": [*shape, c],
              "radius": radius, "angle": angle, "fill": fill, "grayscale": gray,
              "stream": stream, "tiling": t._asdict(), "max_lsb": err})
        if err != 0:
            fail(f"tile case {i} differs by {err} LSB")
        errs["rgb_blur_rotate"] = max(errs["rgb_blur_rotate"], err)
        del x, out, plain
    # per-image angles at the sweep's budget edges, with identity images
    x = images(torch, SHAPE_512, SEED + 70)
    n, h, w = SHAPE_512
    angles = cycled([-APPLY_ALL_BUDGET, APPLY_ALL_BUDGET, 0.0] + ROTATION_GRID, n)
    taps, p = mk._params(h, w, 0.0, 0.0, x.device)[:2]
    k1, f1, k2, f2, ident = mk._traced_params(angles, n, h, w, APPLY_ALL_BUDGET, x.device)
    before = mk.LAUNCHES["rgb_blur_rotate_traced"]
    out = mk.fused_blur_rotate_batched(x, 0.0, angles, max_angle_deg=APPLY_ALL_BUDGET)
    if mk.LAUNCHES["rgb_blur_rotate_traced"] != before + 1:
        fail("budget-edge case did not route to rgb_blur_rotate_traced")
    err = max_lsb(torch, out, mk.rgb_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, 0, True,
                                                       False, ident))
    emit({"phase": "parity", "kernel": "rgb_blur_rotate_traced", "shape": [*SHAPE_512, 3],
          "radius": 0.0, "angles": [-APPLY_ALL_BUDGET, APPLY_ALL_BUDGET],
          "budget": APPLY_ALL_BUDGET, "zero_angle_images": int((ident != 0).sum()),
          "max_lsb": err})
    if err != 0:
        fail(f"budget-edge case differs by {err} LSB")
    errs["rgb_blur_rotate_traced"] = max(errs["rgb_blur_rotate_traced"], err)
    del x, out

    # the shear grid, then its budget edge 1.05 (rows with no valid pixel)
    # and negative factors (no canvas shift) beside grid values
    for shape, seed in ((SHAPE_512, SEED + 24), (SHAPE_32, SEED + 25)):
        x = images(torch, shape, seed)
        for factors in (SHEAR_GRID, SHEAR_EDGES):
            f = torch.from_numpy(cycled(factors, shape[0])).to(x.device)
            before = mk.LAUNCHES["shear_bicubic"]
            out = rs.shear_bicubic_batched(x, f)
            if mk.LAUNCHES["shear_bicubic"] != before + 1:
                fail(f"shear_bicubic {shape}: the entry point did not route to it")
            err = max_lsb(torch, out, rs.shear_bicubic_plain(x, f))
            emit({"phase": "parity", "kernel": "shear_bicubic", "shape": [*shape, 3],
                  "factors": factors, "max_lsb": err})
            if err != 0:
                fail(f"parity shear_bicubic {shape} {factors} differs by {err} LSB")
            errs["shear_bicubic"] = max(errs["shear_bicubic"], err)
        del x, out

    # row shift, zoom and NEAREST rotation: the parameters are computed once
    # on the card and fed to the kernel and to its plain version; each entry
    # point's output (routing checked by its counter) must equal the kernel's.
    def routed(kernel, entry):
        before = mk.LAUNCHES[kernel]
        out = entry()
        if mk.LAUNCHES[kernel] != before + 1:
            fail(f"{kernel}: the entry point did not route to it: {mk.LAUNCHES}")
        return out

    for shape, seed in ((SHAPE_512, SEED + 26), (SHAPE_32, SEED + 27)):
        x = images(torch, shape, seed)
        n, h, w = shape
        dev = x.device
        # the fast shear over the grid, and one row beyond the budget
        v = torch.from_numpy(cycled(SHEAR_GRID, n)).to(dev)
        out = routed("shear_rows_logrouted", lambda: batch._shear_fast(x, v, None))
        bound_px = batch.fast_shear_budget(max(SHEAR_GRID), h)
        b_px = min(bound_px + 1, w + 2)
        shifts = batch.fast_shear_shifts(v, h, dev)
        over = shifts.clone()
        over[0, h // 2] = -(bound_px + 20.5)
        row = {"phase": "parity", "kernel": "shear_rows_logrouted", "shape": [*shape, 3],
               "factors": SHEAR_GRID, "b_px": b_px, "beyond_budget_row": float(over[0, h // 2])}
        kern = sh.shear_rows_logrouted(x, shifts, fill=255, max_shift_px=bound_px)
        row["max_lsb"] = max_lsb(torch, kern, sh.shear_rows_plain(x, shifts, 255, b_px))
        row["max_lsb_entry_vs_kernel"] = max_lsb(torch, out, kern)
        kern = sh.shear_rows_logrouted(x, over, fill=255, max_shift_px=bound_px)
        row["max_lsb_beyond_budget"] = max_lsb(
            torch, kern, sh.shear_rows_plain(x, over, 255, b_px))
        # the zoom over the scale grid and both budget bounds; random_zoom
        f = torch.from_numpy(cycled(SCALE_GRID + ZOOM_BOUNDS, n)).to(dev)
        zoom_rows = {"phase": "parity", "kernel": "zoom_bilinear", "shape": [*shape, 3],
                     "factors": SCALE_GRID + ZOOM_BOUNDS}
        out = routed("zoom_bilinear", lambda: batch._zoom_fast(x, f))
        kern = rs.zoom_bilinear(x, f)
        zoom_rows["max_lsb"] = max_lsb(torch, kern, rs.zoom_bilinear_plain(x, f))
        zoom_rows["max_lsb_entry_vs_kernel"] = max_lsb(torch, out, kern)
        for factor in RANDOM_ZOOM_FACTORS:  # random_zoom's range [0.5, 4] and inside it
            out = routed("zoom_bilinear", lambda: wp.random_zoom(x, factor))
            fz = torch.full((n,), factor, dtype=torch.float32, device=dev)
            zoom_rows[f"max_lsb_random_zoom_{factor:g}_vs_plain"] = max_lsb(
                torch, out, rs.zoom_bilinear_plain(x, fz))
        # the rotation over the grid angles and +-45, against its plain
        # version and a numpy model on the host from the same coefficients;
        # apply_rotation at 45 and the sweep's table route
        angles = cycled(ROTATION_GRID + [45.0, -45.0], n)
        rot_rows = {"phase": "parity", "kernel": "pil_rotate_nearest", "shape": [*shape, 3],
                    "angles": ROTATION_GRID + [45.0, -45.0]}
        out = routed("pil_rotate_nearest",
                     lambda: rg.pil_rotate_nearest_batched(x, angles, max_angle_deg=45.0))
        k = rotate_coeffs(torch, angles, w, h, dev)
        kern = rg.pil_rotate_nearest(x, k, 0)
        rot_rows["max_lsb"] = max_lsb(torch, kern, rg.pil_rotate_nearest_plain(x, k, 0))
        rot_rows["max_lsb_entry_vs_kernel"] = max_lsb(torch, out, kern)
        rot_rows["max_lsb_vs_host_model"] = max_lsb(torch, kern, torch.from_numpy(
            rotate_model(x.cpu().numpy(), k.cpu().numpy(), 0)).to(dev))
        out = routed("pil_rotate_nearest", lambda: wp.apply_rotation(x, 45.0))
        k45 = rotate_coeffs(torch, 45.0, w, h, dev).expand(n, 6)
        rot_rows["max_lsb_apply_rotation_vs_kernel"] = max_lsb(torch, out,
                                                               rg.pil_rotate_nearest(x, k45, 0))
        grid_idx = torch.arange(n, device=dev) % len(ROTATION_GRID)
        out = routed("pil_rotate_nearest",
                     lambda: batch._rotation_pil(x, grid_idx, tuple(ROTATION_GRID)))
        rot_rows["max_lsb_sweep_table_vs_plain"] = max_lsb(torch, out, rg.pil_rotate_nearest_plain(
            x, rotate_coeffs(torch, cycled(ROTATION_GRID, n), w, h, dev), 0))
        torch.cuda.synchronize()
        for kernel, r in (("shear_rows_logrouted", row), ("zoom_bilinear", zoom_rows),
                          ("pil_rotate_nearest", rot_rows)):
            emit(r)
            err = max(v for k, v in r.items() if k.startswith("max_lsb"))
            if err != 0:
                fail(f"parity {kernel} {shape} differs by {err} LSB")
            errs[kernel] = max(errs[kernel], err)
        del x, out, kern

    # #12 beyond the grid at 512x512 (an edge angle an image, and 135 for the
    # batch with fill 255), then at the f64 route's shape, each against its
    # plain version and the host model
    import numpy as np

    x = images(torch, SHAPE_512, SEED + 28)
    n, h, w = SHAPE_512
    angles = cycled(ROTATION_EDGES, n)
    k = rotate_coeffs(torch, angles, w, h, x.device)
    edge_row = {"phase": "parity", "kernel": "pil_rotate_nearest", "shape": [*SHAPE_512, 3],
                "angles": ROTATION_EDGES}
    out = routed("pil_rotate_nearest", lambda: rg.pil_rotate_nearest_batched(x, angles))
    edge_row["max_lsb"] = max_lsb(torch, out, rg.pil_rotate_nearest_plain(x, k, 0))
    edge_row["max_lsb_vs_host_model"] = max_lsb(torch, out, torch.from_numpy(
        rotate_model(x.cpu().numpy(), k.cpu().numpy(), 0)).to(x.device))
    out = routed("pil_rotate_nearest", lambda: rg.pil_rotate_nearest_batched(x, 135.0, fill=255))
    k = rotate_coeffs(torch, 135.0, w, h, x.device).expand(n, 6)
    edge_row["max_lsb_135_fill_255"] = max_lsb(torch, out, rg.pil_rotate_nearest_plain(x, k, 255))
    n, h, w = FLOAT_PATH_SHAPE
    x = images(torch, FLOAT_PATH_SHAPE, SEED + 29, c=1)
    co = rg.pil_rotate_coeffs(7.0, w, h)
    if not co.flagged.all():
        fail(f"7 degrees at {w}x{h} should take Pillow's float path")
    fp = rg.float_path(co, np.zeros(n, np.int64), h, x.device)
    float_row = {"phase": "parity", "kernel": "pil_rotate_nearest", "shape": [*FLOAT_PATH_SHAPE, 1],
                 "angles": [7.0], "route": "f64 (check_fixed fails)"}
    out = routed("pil_rotate_nearest", lambda: rg.pil_rotate_nearest_batched(x, 7.0))
    k = torch.from_numpy(co.fixed).to(x.device).expand(n, 6)
    float_row["max_lsb"] = max_lsb(torch, out, rg.pil_rotate_nearest_plain(x, k, 0, fp))
    float_row["max_lsb_vs_host_model"] = max_lsb(torch, out, torch.from_numpy(rotate_model(
        x.cpu().numpy(), co.fixed, 0, tuple(t.cpu().numpy() for t in fp))).to(x.device))
    torch.cuda.synchronize()
    for r in (edge_row, float_row):
        emit(r)
        err = max(v for key, v in r.items() if key.startswith("max_lsb"))
        if err != 0:
            fail(f"parity pil_rotate_nearest {r['shape']} differs by {err} LSB")
        errs["pil_rotate_nearest"] = max(errs["pil_rotate_nearest"], err)
    del x, out

    # separable blur, row shifts and the 3-shear rotations built on them:
    # each entry point against its plain version on the same inputs
    def parity_row(kernel, row, got, want):
        row["max_lsb"] = max(row.get("max_lsb", 0), max_lsb(torch, got, want))
        errs[kernel] = max(errs[kernel], row["max_lsb"])

    new_rows = []
    for shape, seed in ((SHAPE_512, SEED + 50), (SHAPE_32, SEED + 51), ((4, 5, 7), SEED + 52)):
        x = images(torch, shape, seed)
        n, h, w = shape
        row = {"phase": "parity", "kernel": "blur_separable", "shape": [*shape, 3],
               "radii": [0.5, 1.5, 5.0] if h > 5 else [1.5]}
        for r in row["radii"]:
            parity_row("blur_separable", row,
                       routed("blur_separable", lambda: bl.blur_separable(x, r)),
                       st.gaussian_blur_plain(x, r))
        new_rows.append(row)
        # one radius an image: the blur grid cycled over the batch (radius 0
        # included), through the entry point and through apply_blur
        # (every grid radius: a batch of at least 11 images)
        xb = x if n >= len(BLUR_GRID) else images(torch, (len(BLUR_GRID), h, w), seed)
        radii = torch.from_numpy(cycled(BLUR_GRID, xb.shape[0])).to(x.device)
        row = {"phase": "parity", "kernel": "blur_separable_batched", "shape": [*xb.shape],
               "radii": sorted(set(radii.tolist()))}
        want = st.blur_batched_plain(xb, radii)
        parity_row("blur_separable_batched", row,
                   routed("blur_separable_batched", lambda: bl.blur_separable_batched(xb, radii)),
                   want)
        parity_row("blur_separable_batched", row,
                   routed("blur_separable_batched", lambda: st.apply_blur(xb, radii)), want)
        new_rows.append(row)
        del xb, want
        if h <= 5:
            continue
        # one shift vector for the batch, within and beyond an explicit pad
        g = torch.Generator(device="cuda").manual_seed(seed)
        shifts = ((torch.rand((h,), generator=g, device="cuda") - 0.5) * 60.0).contiguous()
        row = {"phase": "parity", "kernel": "shear_rows", "shape": [*shape, 3],
               "shift_range": [float(shifts.min()), float(shifts.max())], "pad_px": [None, 10]}
        for pad in (None, 10):
            b_px = max(pad or math.ceil(float(shifts.abs().max())) + 1, 1)
            for post in (None, "grayscale"):
                got = routed("shear_rows", lambda: sh.shear_rows(x, shifts, fill=7, pad_px=pad,
                                                                 postop=post))
                parity_row("shear_rows", row, got,
                           sh.shear_rows_plain(x, shifts, 7, b_px, post == "grayscale"))
        for angle in (ANGLE, -44.0):
            parity_row("shear_rows", row, sh.rotate_3shear(x, angle),
                       sh.rotate_3shear_plain(x, angle))
            # the strict rgb_blur_rotate kernel at radius 0 computes the same function
            row[f"max_lsb_rotate_3shear_vs_rgb_blur_rotate_strict_r0_{angle:g}deg"] = max_lsb(
                torch, sh.rotate_3shear(x, angle),
                fused_blur_rotate_image(x, 0.0, angle, stream=False))
        parity_row("shear_rows", row,
                   sh.blur_rotate_fused(x, BLUR_RADIUS, ANGLE, grayscale_out=True),
                   sh.blur_rotate_fused_plain(x, BLUR_RADIUS, ANGLE, grayscale_out=True))
        new_rows.append(row)
        # the column pass: Paeth shifts (rotate_3shear's pass 2) and random
        # shift vectors, within and beyond the saturation bound, against its
        # plain version and against the row pass between two transposes
        cols = [sh._rotation_shifts(h, w, a, x.device)[2:] + (0,) for a in (ANGLE, -44.0)]
        sy = ((torch.rand((w,), generator=g, device="cuda") - 0.5) * h).contiguous()
        cols += [(sy, math.ceil(float(sy.abs().max())) + 1, 255), (sy, 3, 9)]
        row = {"phase": "parity", "kernel": COL_PASS, "shape": [*shape, 3],
               "shifts": [f"Paeth {ANGLE} deg", "Paeth -44 deg", "random +-h/2",
                          "random +-h/2, b_px 3"]}
        for sy, b_px, fill in cols:
            got = routed(COL_PASS, lambda: sh._col_shift(x, sy, fill, b_px))
            parity_row(COL_PASS, row, got, sh.shear_cols_plain(x, sy, fill, b_px))
            parity_row(COL_PASS, row, got,
                       sh._swap_hw(sh.shear_rows_plain(sh._swap_hw(x), sy, fill, b_px)))
        new_rows.append(row)
        per_image = per_image_row_shifts(torch, n, h, "cuda")
        row = {"phase": "parity", "kernel": "shear_rows_per_image", "shape": [*shape, 3],
               "pad_px": PER_IMAGE_PAD,
               "saturated_rows": int((per_image.floor().abs() > PER_IMAGE_PAD).sum())}
        got = routed("shear_rows_per_image",
                     lambda: sh.shear_rows_per_image(x, per_image, fill=255, pad_px=PER_IMAGE_PAD))
        parity_row("shear_rows_per_image", row, got,
                   sh.shear_rows_plain(x, per_image, 255, PER_IMAGE_PAD))
        new_rows.append(row)
        del x, got
    torch.cuda.synchronize()
    for row in new_rows:
        emit(row)
        err = max(v for k, v in row.items() if k.startswith("max_lsb"))
        if err != 0:
            fail(f"parity {row['kernel']} {row['shape']} differs by {err} LSB")

    # ---- main paths: the user-facing entry points, counters reset around each
    runs = main_path_runs()
    inputs = {label: images(torch, shape, seed) for label, _, shape, seed, *_ in runs}
    torch.cuda.synchronize()
    launches = {k: 0 for k in mk.LAUNCHES}
    results = []
    drawn_radii = None  # the blur radii the default sweep drew at 32x512x512
    for label, fn, shape, _, ref, reps, kernels in runs:
        x = inputs[label]
        for k in mk.LAUNCHES:
            mk.LAUNCHES[k] = 0
        out = fn(x)
        ms = time_ms(torch, lambda: fn(x), reps)
        torch.cuda.synchronize()
        run_launches = {k: v for k in mk.LAUNCHES if (v := row_launches(mk.LAUNCHES, k))}
        for k, v in run_launches.items():
            launches[k] += v
        missing = [k for k in kernels if not run_launches.get(k)]
        if missing:
            fail(f"{label}: kernels {missing} were not launched: {run_launches}")
        n, h, w = shape
        row = {"run": label, "shape": [*shape, 3], "ms": ms,
               "gpix_per_s": n * h * w / (ms * 1e-3) / 1e9, "launches": run_launches}
        if not callable(ref) and ref in SWEEP_FLAGS:
            row["max_lsb_vs_plain"] = check_sweep(torch, x, out, ref)
            if ref == "apply_all" and shape == SHAPE_512:
                drawn_radii = out["blur"][0]
        else:
            if out.shape != x.shape or out.dtype != torch.uint8 or out.device != x.device:
                fail(f"{label}: bad output {tuple(out.shape)} {out.dtype} {out.device}")
            if callable(ref):
                want = ref(x)  # the run's plain composition on the same input
            else:
                is_gray = ref[1] if isinstance(ref, tuple) else "gray" in ref
                if is_gray:
                    if not (torch.equal(out[..., 0], out[..., 1])
                            and torch.equal(out[..., 0], out[..., 2])):
                        fail(f"{label}: grayscale channels differ")
                # the same seed made the parity case's input: the output must
                # equal the plain version computed there
                want = refs[ref]
            row["max_lsb_vs_plain"] = max_lsb(torch, out, want)
            if row["max_lsb_vs_plain"] != 0:
                fail(f"{label}: differs from the plain version by {row['max_lsb_vs_plain']} LSB")
        results.append(row)
    torch.cuda.synchronize()
    run_launches_by_label = {row["run"]: row["launches"] for row in results}
    emit({"phase": "main_path", "runs": results, "launches": launches})
    for k, v in launches.items():
        if v <= 0:
            fail(f"kernel {k} was not launched on the main paths")

    # ---- apply_all by type: the sweep with one type at a time --------------
    for label, _, shape, _, ref, *_ in runs:
        if callable(ref) or ref not in SWEEP_FLAGS:
            continue
        x = inputs[label]
        ms = {t: time_ms(torch, lambda: apply_all_transformations(x, SEED, types=(t,),
                                                                  **SWEEP_FLAGS[ref]), 5)
              for t in TYPES}
        emit({"phase": "apply_all_types", "run": label, "shape": [*shape, 3],
              "ms_by_type": ms, "ms_sum": sum(ms.values())})
    del inputs, refs

    # ---- kernels: each wrapper and its plain version at main-path shapes ---
    entries = []
    for kernel in KERNELS:
        library_ms, library_note = None, NO_LIBRARY.get(kernel, NO_LIBRARY_BLUR_ROTATE)
        extra = {}
        if kernel in ("shear_rows_logrouted", "zoom_bilinear", "pil_rotate_nearest"):
            # the fast sweep's use of each at 32x512x512: grid parameters
            # cycled over the batch, computed once on the card
            shape = SHAPE_512
            n, h, w = shape
            x = images(torch, shape, SEED + 100)
            xo = torch.arange(w, dtype=torch.float32, device=x.device).view(1, 1, w) + 0.5
            yo = torch.arange(h, dtype=torch.float32, device=x.device).view(1, h, 1) + 0.5
            if kernel == "shear_rows_logrouted":
                v = torch.from_numpy(cycled(SHEAR_GRID, n)).to(x.device)
                shifts = batch.fast_shear_shifts(v, h, x.device)
                bound_px = batch.fast_shear_budget(max(SHEAR_GRID), h)
                b_px = min(bound_px + 1, w + 2)
                run = lambda: sh.shear_rows_logrouted(x, shifts, 255, bound_px)
                plain = lambda: sh.shear_rows_plain(x, shifts, 255, b_px)
                b_ms, b_by = bound_shear_rows(torch, x, shifts, b_px)
                lib = grid_sample_call(torch, x, (xo + shifts[:, :, None]).expand(n, h, w),
                                       yo.expand(n, h, w), "bilinear")
                mode, lib_mode = "fast shear, grid factors 0..1, fill 255", "'bilinear'"
            elif kernel == "zoom_bilinear":
                f = torch.from_numpy(cycled(SCALE_GRID, n)).to(x.device)
                run = lambda: rs.zoom_bilinear(x, f)
                plain = lambda: rs.zoom_bilinear_plain(x, f)
                b_ms, b_by = bound_zoom(torch, x, f)
                extra = {"modes": resample_modes(torch, rs, kernel, run_launches_by_label)}
                inv = (1.0 / f).view(n, 1, 1)
                src_x = inv * xo + (w / 2.0 - inv * (w / 2.0))  # centre zoom, as zoom_matrix
                src_y = inv * yo + (h / 2.0 - inv * (h / 2.0))
                lib = grid_sample_call(torch, x, src_x.expand(n, h, w), src_y.expand(n, h, w),
                                       "bilinear")
                mode, lib_mode = "scale grid factors 0.9..1.4", "'bilinear'"
            else:
                k = rotate_coeffs(torch, cycled(ROTATION_GRID, n), w, h, x.device)
                run = lambda: rg.pil_rotate_nearest(x, k, 0)
                plain = lambda: rg.pil_rotate_nearest_plain(x, k, 0)
                b_ms, b_by = bound_rotate(torch, x, k)
                extra = {"modes": rotate_modes(torch, rg, run_launches_by_label)}
                lib = rotate_library_call(torch, x, k)
                mode, lib_mode = "rotation grid angles -22.5..22.5, fill 0", "'nearest'"
            library_ms = time_ms(torch, lib, 20)
            library_note = LIBRARY_NOTE.format(mode=lib_mode)
        elif kernel == "blur_separable":
            shape = SHAPE_512
            n, h, w = shape
            x = images(torch, shape, SEED + 100)
            run = lambda: bl.blur_separable(x, BLUR_RADIUS)
            plain = lambda: st.gaussian_blur_plain(x, BLUR_RADIUS)
            taps = bl.blur_taps(BLUR_RADIUS, x.device)
            k = taps.numel()
            b_ms, b_by = bound(n, h, w, 3, 3, 3 * ops_blur(k))
            # the yardstick: one grouped conv2d of the KxK outer-product taps
            # on the reflect-padded f32 NCHW batch, padded outside the timing
            p = k // 2
            xf = torch.nn.functional.pad(x.permute(0, 3, 1, 2).to(torch.float32), (p, p, p, p),
                                         mode="reflect").contiguous()
            weight = torch.outer(taps, taps).expand(3, 1, k, k).contiguous()
            lib = lambda: torch.nn.functional.conv2d(xf, weight, groups=3)
            library_ms, library_note = time_ms(torch, lib, 20), BLUR_LIBRARY_NOTE
            mode = f"r {BLUR_RADIUS} ({k} taps)"
        elif kernel == "blur_separable_batched":
            # the default sweep's blur at 32x512x512: the radii it drew
            shape = SHAPE_512
            n, h, w = shape
            x = images(torch, shape, SEED + 100)
            radii = drawn_radii
            taps = st.blur_taps_batched(radii)
            # the kernel on tap rows made outside the timing; the entry
            # point with its taps (a few dozen PyTorch ops) is timed apart
            run = lambda: bl._launch(x, taps, taps.shape[1], "blur_separable_batched")
            plain = lambda: st.blur_batched_plain(x, radii)
            b_ms, b_by = bound_blur_batched(torch, x, radii)
            extra = {"entry_ms": time_ms(torch, lambda: bl.blur_separable_batched(x, radii), 20)}
            if not torch.equal(run(), plain()):
                fail("blur_separable_batched differs from its plain version on the drawn radii")
            p = (taps.shape[1] - 1) // 2
            xf = torch.nn.functional.pad(x.permute(0, 3, 1, 2).to(torch.float32), (p, p, p, p),
                                         mode="reflect").reshape(1, 3 * n, h + 2 * p, w + 2 * p)
            xf = xf.contiguous()
            weight = (taps[:, :, None] * taps[:, None, :]).repeat_interleave(3, 0)[:, None]
            weight = weight.contiguous()
            lib = lambda: torch.nn.functional.conv2d(xf, weight, groups=3 * n)
            library_ms, library_note = time_ms(torch, lib, 5), BLUR_BATCHED_LIBRARY_NOTE
            ks = sorted(set(int(k) for k in (taps != 0).sum(1).tolist()))
            mode = (f"radii drawn by apply_all (seed {SEED + 30}): "
                    f"{sorted(set(round(v, 2) for v in radii.tolist()))}, K in {ks}")
        elif kernel == COL_PASS:
            # pass 2 of rotate_3shear at 15 degrees: one shift a column
            shape = SHAPE_512
            n, h, w = shape
            x = images(torch, shape, SEED + 100)
            sy, by = sh._rotation_shifts(h, w, ANGLE, x.device)[2:]
            run = lambda: sh._col_shift(x, sy, 0, by)
            plain = lambda: sh.shear_cols_plain(x, sy, 0, by)
            b_ms, b_by = bound_shear_cols(torch, x, sy, by)
            xo = torch.arange(w, dtype=torch.float32, device=x.device).view(1, 1, w) + 0.5
            yo = torch.arange(h, dtype=torch.float32, device=x.device).view(1, h, 1) + 0.5
            lib = grid_sample_call(torch, x, xo.expand(n, h, w),
                                   (yo + sy.view(1, 1, w)).expand(n, h, w), "bilinear")
            library_ms, library_note = time_ms(torch, lib, 20), LIBRARY_NOTE.format(
                mode="'bilinear'")
            mode = f"rotate_3shear pass 2 at {ANGLE} deg, fill 0"
        elif kernel in ("shear_rows", "shear_rows_per_image"):
            # shear_rows: pass 1 of rotate_3shear at 15 degrees (one shift
            # vector); shear_rows_per_image: the main path's [n, h] shifts
            shape = SHAPE_512
            n, h, w = shape
            x = images(torch, shape, SEED + 100)
            if kernel == "shear_rows":
                a, _ = sh._paeth_params(ANGLE)
                host = sh._row_shifts(h, a, h / 2.0)
                s1 = torch.from_numpy(host).to(x.device)
                b_px = math.ceil(float(abs(host).max())) + 1
                run = lambda: sh.shear_rows(x, s1, pad_px=b_px)  # as rotate_3shear calls it
                plain = lambda: sh.shear_rows_plain(x, s1, 0, b_px)
                shifts = s1.expand(n, h)
                mode = f"rotate_3shear pass 1 at {ANGLE} deg, fill 0"
            else:
                shifts = per_image_row_shifts(torch, n, h, x.device)
                b_px = PER_IMAGE_PAD
                run = lambda: sh.shear_rows_per_image(x, shifts, fill=255, pad_px=b_px)
                plain = lambda: sh.shear_rows_plain(x, shifts, 255, b_px)
                mode = f"random shifts +-30 px, pad_px {b_px} (saturating), fill 255"
            b_ms, b_by = bound_shear_rows(torch, x, shifts, b_px)
            xo = torch.arange(w, dtype=torch.float32, device=x.device).view(1, 1, w) + 0.5
            yo = torch.arange(h, dtype=torch.float32, device=x.device).view(1, h, 1) + 0.5
            lib = grid_sample_call(torch, x, (xo + shifts[:, :, None]).expand(n, h, w),
                                   yo.expand(n, h, w), "bilinear")
            library_ms, library_note = time_ms(torch, lib, 20), LIBRARY_NOTE.format(
                mode="'bilinear'")
        elif kernel == "shear_bicubic":
            shape = SHAPE_512
            x = images(torch, shape, SEED + 100)
            f = torch.from_numpy(cycled(SHEAR_GRID, shape[0])).to(x.device)
            run = lambda: rs.shear_bicubic(x, f)
            plain = lambda: rs.shear_bicubic_plain(x, f)
            b_ms, b_by = bound_shear_bicubic(torch, x, f)
            extra = {"modes": resample_modes(torch, rs, kernel, run_launches_by_label)}
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
                slopes = mk.budget_slope_bound(25.0)
            else:
                taps, p, k1, f1, k2, f2 = mk._params(h, w, radius, ANGLE, x.device)
                ident, slopes = False, mk.slope_bound(ANGLE)
            if kernel.startswith("luma"):
                run = lambda: mk.luma_blur_rotate(x, taps, p, k1, f1, k2, f2, 0)
                plain = lambda: mk.luma_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, 0)
                b_ms, b_by = bound(n, h, w, 3, 3, ops_luma(p))
            else:
                run = lambda: mk.rgb_blur_rotate(x, taps, p, k1, f1, k2, f2, 0, not stream,
                                                 gray, ident, slopes=slopes)
                plain = lambda: mk.rgb_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, 0,
                                                         not stream, gray, ident)
                b_ms, b_by = bound(n, h, w, 3, 3, ops_rgb(p, not stream, gray, False))
                extra = {"modes": rgb_modes(torch, mk, sh, kernel, run_launches_by_label)}
            mode = (("stream" if stream else "strict") + (" gray" if gray else "")
                    + f" r {radius}" + (" per-image angles" if traced else f" {ANGLE} deg"))
        entries.append({
            "name": kernel, "route": "cuda", **KERNELS[kernel],
            "launches": launches[kernel], "max_abs_err": errs[kernel],
            "ms": time_ms(torch, run, 20), "device_ms": device_ms(torch, run, 20),
            "plain_ms": time_ms(torch, plain, 5),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": library_ms, "library_note": library_note,
            "shape": [*shape, 3], "mode": mode, **extra,
        })
        del x, run, plain

    # ---- geometry: the luma kernel's band rows and images a block ----------
    # ms of each geometry at 4096x32x32 and 32x512x512 (byte-equal to the
    # host's choice; CUDA events around 20 calls: torch.profiler recorded no
    # device time after about forty sessions in one process), two rounds, the
    # second in reverse order, so warm-up favours neither end.
    for shape, variants in (
            (SHAPE_32, lambda g: [g, g._replace(groups=g.groups // 2), g._replace(groups=1),
                                  g._replace(rows_a=32), g._replace(rows_b=8),
                                  g._replace(rows_b=16)]),
            (SHAPE_512, lambda g: [g, g._replace(rows_a=16), g._replace(rows_a=64),
                                   g._replace(rows_b=4), g._replace(rows_b=16)])):
        n, h, w = shape
        x = images(torch, shape, SEED + 101)
        taps, p, k1, f1, k2, f2 = mk._params(h, w, BLUR_RADIUS, ANGLE, x.device)
        routed = mk._luma_geometry(h, w, p)
        geometries = variants(routed)
        ref = mk.luma_blur_rotate(x, taps, p, k1, f1, k2, f2, 0)
        rounds = []
        for order in (geometries, geometries[::-1]):
            ms = {}
            for g in order:
                run = lambda: mk.luma_blur_rotate(x, taps, p, k1, f1, k2, f2, 0, geometry=g)
                if max_lsb(torch, run(), ref) != 0:
                    fail(f"geometry {g} differs from the host's choice {routed}")
                ms[g] = time_ms(torch, run, 20)
            rounds.append(ms)
        emit({"phase": "geometry", "kernel": "luma_blur_rotate", "shape": [*shape, 3],
              "fields": list(mk.LumaGeometry._fields), "routed": list(routed),
              "ms_by_geometry": [[list(g), r[g]] for g in geometries for r in rounds]})
        del x, ref
    emit({"kernels": entries})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
