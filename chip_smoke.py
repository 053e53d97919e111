#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``imagetransformations_tpu_torch/
csrc`` with nvcc, holds each against its plain PyTorch version on the card
at full size (0 LSB: the blur #6 / #6b in cv2's integers with the sweep's
tap table, the BICUBIC shear #11 with the sweep's int32 canvas shifts; the
NEAREST rotation also against a numpy model of
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
random_zoom at 0.5 and 4), the luma kernel's entry rows on its resident
route (S1 in a cluster's shared memory) at the chain cell's 1024x224x224,
at 32x512x512 and at two shapes of the route's edges, each beside the band
route; phase ``geometry`` times the luma kernel's band rows and images a
block at 4096x32x32 and 32x512x512. Before those,
phase ``trig`` holds the per-image shifts and rotation matrices computed on
the card to the CPU's bit for bit, and phase ``folder`` runs the
reference's main script: folders of JPEGs (32 at 512x512, 512 at 32x32)
through ``python -m imagetransformations_tpu_torch transform`` and
``chain``, with stage seconds, images a second and the card's busy share.
After the kernels are timed, phase ``corrupt`` runs every corruption of
``evalx.harness`` at severities 1-5 at 10000x32x32 (the CIFAR-10 test set)
and 64x224x224 (ImageNet-C) on the card, each held to the CPU path on its
first images within 1 LSB (numpy draws; ``rotation`` on the NEAREST
rotation kernel), and the folder phase's ``corrupt`` command takes 256
PNGs of 32x32 through the store's 19 corruptions at severities 1-5.
Then phase ``models`` runs each classifier of ``models`` (ResNet-20 / 56,
SimpleCNN on 10000x32x32 in ``evaluate_batched``'s batches of 256, the
Bayesian CNN's 50 predictive samples of 1000 images, ResNet-18 / 50 on
256x224x224, VGG-19-BN on 64x224x224; random weights from a seed): ms and
images a second, the bound (multiply-adds over the f32 FMA rate), peak
device memory, the card's logits against the CPU's on the first images,
and the forward with TF32 switched on by the caller bit-equal to TF32 off;
and phase ``sweep`` holds the backward passes (one Adam step of a
ResNet-20, ODIN's input gradient) with TF32 on bit-equal to off, runs
``corruption_sweep`` with ODIN and Mahalanobis on
a demo-trained ResNet-20 over 10000 synthetic images, the 15 canonical
corruptions and ``rotation`` (kernel #12) at severities 1-5, holds the
same cells on 64 images to the CPU's (numpy draws), and times the
``sweep`` and ``report`` commands in process. Then phase ``swag`` runs
``workflows.swag_pipeline`` on a seeded ResNet-56 (the reference's
cifar_swag.py: 200 SGD collection steps of 128 synthetic images, rank 20,
30 weight samples, the BMA of 10 over 10 000 test images: ms a step,
``sample_many`` ms, BMA s against the forwards' bound, peak memory) and
holds 4 steps on 64 images to the CPU's with the same draws; and phase
``refine`` runs ``workflows.refinement_pipeline`` on the demo ResNet-20
over 10 000 synthetic images (also with the clip at the model space's
range), FGSM, reverse FGSM, PGD and ``minimal_epsilon`` in pixel space,
kNN and Laplace on the features of 50 000 x 10 000 images, each timed,
and holds each to the CPU on 64 images. Then phase ``tent`` runs TENT on
the demo ResNet-20 over the 10 000 test images in batches of 256 (one
step's ms against its bound, the continuous / reset / conditional
protocols, ``workflows.tent_sweep`` over 3 corruptions x 2 severities x 4
protocols, the entropy-gated main-path chain at 10000x32x32 and
32x512x512 on kernels #2 and #1) and phase ``tta`` runs the three TTA
stacks, adaptive TTA with SLSQP, MATTA / VATTA, the mixing ratio, every
post-hoc calibrator (ECE, NLL, Brier before and after) and AugMix at
10000x32x32 and 32x512x512 on kernel #12; each holds itself to the CPU on
64 images and fails if its kernels were not launched. Then, on one demo
ResNet-20, phase ``patches`` trains the universal patch (40 batches of 256
under noise) and the restorative patches (1000 images x 20 Adam steps) and
times ``adet_operator`` at 10000x32x32; phase ``evolution`` runs
``evolutionary_search`` at JAX's defaults over 10 000 images (#3 through
the blur genes); phase ``sharding`` runs ``sharded_chain_fn`` (#1, #3, #4,
#5) and ``sharded_gaussian_blur`` (#6) at 32x512x512 on 4 shards of one
card, 0 LSB against one device, ``evaluate_sharded``, the sweep's
``mesh=`` and one ``sweep --data-parallel`` row (``tools/run_mesh_phases.py``
runs these three alone). These nine phases
run under the flags a user has by default, TF32 on for cuDNN (here
cuBLAS's too), so the port's scoped true f32 (``core.precision.full_f32``)
is what holds their results to the CPU's; the rest of the script runs
with TF32 off.
Prints one JSON line per phase; the
last line is ``{"ok": true, "device": {...}}``. Any failure raises: the exit code is then
non-zero and no result line is printed. Without a CUDA device it exits 1.
Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import signal
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
SHAPE_CHAIN = (1024, 224, 224)  # the benchmark's chain cell: one call's batch
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
# phase corrupt: the CIFAR-10 test set's shape and ImageNet-C's, (n, h, w), and
# how many of their images the CPU path recomputes
CORRUPT_SHAPES = ((10000, 32, 32), (64, 224, 224))
CORRUPT_CPU_IMAGES = {32: 256, 224: 8}
FOLDER_CORRUPT_IMAGES = 256  # the folder phase's corrupt run: PNGs of 32x32
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
BLUR_LIBRARY_NOTE = ("F.conv2d of the KxK outer product of the integer taps / 256 in f32, "
                     "groups=3, on the reflect-padded f32 NCHW batch (padding outside the timed "
                     "region), TF32 off: the same filter in f32, not bit-equal to cv2's integer "
                     "sums; f32 in and out")
BLUR_BATCHED_LIBRARY_NOTE = (
    "F.conv2d of each image's 31x31 outer product of its zero-padded integer tap row / 256 in "
    "f32, groups=3n, on the reflect-padded f32 batch as one [1, 3n, h+30, w+30] image (padding "
    "outside the timed region), TF32 off: the same filters in f32, not bit-equal to cv2's "
    "integer sums; f32 in and out")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    raise RuntimeError(msg)


@contextlib.contextmanager
def caller_tf32(torch, on: bool, deterministic: bool | None = None):
    """The caller's TF32 flags for cuBLAS and cuDNN set to ``on`` (and
    cuDNN's deterministic flag to ``deterministic`` where given) for the
    scope; the previous flags restored after."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (matmul.allow_tf32, cudnn.allow_tf32, cudnn.deterministic)
    matmul.allow_tf32 = cudnn.allow_tf32 = on
    if deterministic is not None:
        cudnn.deterministic = deterministic
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32, cudnn.deterministic = saved


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


def kernels_per_call(torch, fn, reps: int):
    """CUDA kernels a fn() call launches, counted by torch.profiler over
    `reps` calls; None where the profiler records none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    n = sum(e.count for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA"))
    return n / reps if n else None


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


def bound_of(nbytes, ops, rate=UNFUSED_OPS_PER_S):
    """(bound_ms, bound_by) of a call that must move ``nbytes`` and do
    ``ops`` operations at ``rate`` a second (by default unfused f32)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
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
    # cv2's integer blur, per value: K multiply-adds a pass (two passes) and
    # the shift; the rounding term 2^15 starts the sum. Every partial sum is
    # an integer below 2^24, exact as an f32 FMA, so each counts at the
    # unfused f32 rate (an FMA a lane a clock), as the kernel's horizontal
    # pass runs them; the shift is one FMA there too
    return 2 * k + 1


def bound_blur(x, taps):
    """cv2's integer blur with one int32 tap row of K taps: reads and
    writes the batch and reads the row; ops_blur(K) operations a value."""
    return bound_of(2 * x.numel() + taps.numel() * 4, x.numel() * ops_blur(taps.numel()))


def bound_blur_batched(torch, x, taps):
    """Per-image blur: each image does ops_blur(K) a value with its own
    K, the taps between its row's outer nonzero ones; an image at radius 0
    (the delta row) is a copy (no operations). Reads the batch and the
    int32 tap rows, writes the batch."""
    n, h, w, c = x.shape
    nz = taps != 0
    first = nz.int().argmax(1)
    k = taps.shape[1] - 2 * first
    ops = int(torch.where(k > 1, ops_blur(k), 0).sum().item()) * h * w * c
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
    v = s.to(torch.float64)  # the canvas shift: PIL's f64 ceil(s*h), as the kernel takes it
    m2 = -torch.where(v > 0, torch.ceil(v * float(h)), 0.0).to(torch.float32)
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
    must raise."""
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
    plain = {"blur": st.blur_batched_plain(x, res["blur"][0])}  # host rows of the drawn radii
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
        # the grid's f64 canvas shifts, by each drawn value's grid index
        values = res["shear"][0]
        plain["shear"] = rs.shear_bicubic_plain(x, values, sweep_shear_shifts(torch, batch,
                                                                              values, h))
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


def luma_route(mk, h: int, w: int, p: int) -> str:
    """The route the luma kernel's wrapper takes at (h, w, p) by itself."""
    return "resident" if mk._resident_geometry(h, w, p) is not None else "band"


def luma_modes(torch, mk, run_launches) -> list:
    """The kernels line's further rows of the luma kernel (#1) on its
    resident route (S1 in a cluster's shared memory), each held at 0 LSB
    against the plain version, with the band route's times beside it: the
    chain cell's call (1024x224x224), 32x512x512, and two shapes at the
    route's edges (128 rows of the widest row it takes, clusters of 8; an
    odd shape, clusters of 2)."""
    rows = []
    # the main-path run whose launches a row reports (none at the edges)
    runs = {SHAPE_CHAIN: "chain blur>rotate>gray 224", SHAPE_512: "chain blur>rotate>gray 512"}
    for i, shape in enumerate((SHAPE_CHAIN, SHAPE_512, (128, 128, 512), (352, 160, 149))):
        n, h, w = shape
        x = images(torch, shape, SEED + 104 + i)
        taps, p, k1, f1, k2, f2 = mk._params(h, w, BLUR_RADIUS, ANGLE, x.device)
        if luma_route(mk, h, w, p) != "resident":
            fail(f"luma_blur_rotate {shape}: the host does not take the resident route")
        run = lambda: mk.luma_blur_rotate(x, taps, p, k1, f1, k2, f2, 0)
        want = mk.luma_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, 0)
        row = mode_row(torch, f"stream gray r {BLUR_RADIUS} {ANGLE} deg", shape, run, want,
                       bound(n, h, w, 3, 3, ops_luma(p)),
                       run_launches.get(runs.get(shape), {}).get("luma_blur_rotate_resident", 0))
        row["route"], row["cluster"] = "resident", mk._resident_geometry(h, w, p).cluster
        band = mk._luma_geometry(h, w, p)
        alt = lambda: mk.luma_blur_rotate(x, taps, p, k1, f1, k2, f2, 0, geometry=band)
        if max_lsb(torch, alt(), want) != 0:
            fail(f"luma_blur_rotate {shape}: the band route differs from the plain version")
        row["band_route"] = {"geometry": list(band), "ms": time_ms(torch, alt, 20),
                             "device_ms": device_ms(torch, alt, 20)}
        rows.append(row)
        del x, want
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
        from imagetransformations_tpu_torch.pipeline import batch

        f = torch.from_numpy(cycled(SHEAR_GRID, n)).to(x.device)
        m = sweep_shear_shifts(torch, batch, f, h)  # outside the timing
        run, plain = lambda: rs.shear_bicubic(x, f, m), lambda: rs.shear_bicubic_plain(x, f, m)
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


def sweep_shear_shifts(torch, batch, factors, h):
    """The sweep's int32 canvas shifts of shear grid values: the grid's f64
    table gathered by each value's grid index (0.1 steps)."""
    idx = torch.round(factors * 10.0).to(torch.int64)
    from imagetransformations_tpu_torch.ops.hopper.resample import shear_shift_table

    return shear_shift_table(batch._grid_f64("shear"), h, factors.device)[idx]


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


def trig_phase(torch) -> dict:
    """The per-image shifts (``megakernel._traced_params``) and rotation
    matrices (``warp.rotation_matrix``) computed on the card equal the CPU's
    bit for bit: on the rotation grid and on 512 seeded random angles."""
    import numpy as np

    from imagetransformations_tpu_torch.ops import warp as wp
    from imagetransformations_tpu_torch.ops.hopper import megakernel as mk

    cpu, dev = torch.device("cpu"), torch.device("cuda")
    rand = np.random.default_rng(SEED + 9).uniform(-180.0, 180.0, 512).astype(np.float32)
    row = {"phase": "trig", "angles": {"grid": len(ROTATION_GRID), "random": len(rand)}}
    for name, angles, budget in (("grid", np.float32(ROTATION_GRID), APPLY_ALL_BUDGET),
                                 ("random", rand, 180.0)):
        a = torch.from_numpy(angles)
        n, (h, w) = a.numel(), SHAPE_512[1:]
        card = mk._traced_params(a.to(dev), n, h, w, budget, dev)
        host = mk._traced_params(a, n, h, w, budget, cpu)
        row[f"traced_params_{name}_differ"] = sum(int((c.cpu() != v).sum()) for c, v in
                                                  zip(card, host))
        row[f"rotation_matrix_{name}_differ"] = int(
            (wp.rotation_matrix(a.to(dev), w, h).cpu() != wp.rotation_matrix(a, w, h)).sum())
    emit(row)
    bad = {k: v for k, v in row.items() if k.endswith("_differ") and v}
    if bad:
        fail(f"the card's shifts or matrices differ from the CPU's: {bad}")
    return row


def folder_phase(torch, mk) -> list:
    """The reference's main script on the card: folders of JPEGs (32 at
    512x512x3 and 512 at 32x32x3, written from a seed) through the
    ``transform`` and ``chain`` commands, run as ``python -m
    imagetransformations_tpu_torch`` runs them (``runpy``, in this process,
    so the launch counters can be read). Each command runs three times: a
    warm-up; the measured run, with the counters reset just before it and
    read just after, its wall seconds, stage seconds (``--stats``) and
    images a second end to end; and a run under torch.profiler, whose
    device time (kernels, and copies apart) over the measured run's wall
    time is the card's busy share (the profiler slows the host, not the
    card). The files must equal the same codec's encoding of the same
    computation redone here (the chain; the sweep with the same seed).
    Without a JPEG codec (the native build and PIL both missing) the phase
    prints what is missing and is not measured."""
    import shutil
    import tempfile

    import numpy as np

    from imagetransformations_tpu_torch import OpSpec, apply_all_transformations
    from imagetransformations_tpu_torch.pipeline import native_io
    from imagetransformations_tpu_torch.pipeline.chain import build_chain_fn
    from imagetransformations_tpu_torch.pipeline.io import load_folder_images

    try:
        import PIL  # noqa: F401
        pil = True
    except ImportError:
        pil = False
    codecs = {"g++": shutil.which("g++"), "native": native_io.native_available(),
              "native_error": native_io.build_error(), "pil": pil}
    if not codecs["native"] and not pil:
        print(f"chip_smoke: folder phase not measured: no JPEG codec (native build: "
              f"{codecs['native_error']}; PIL not installed)", flush=True)
        emit({"phase": "folder", "measured": False, "codecs": codecs})
        return []
    chain_spec = f"blur:{BLUR_RADIUS},rotation:{ANGLE},grayscale"
    chain = [OpSpec("blur", {"radius": BLUR_RADIUS}), OpSpec("rotation", {"angle": ANGLE}),
             OpSpec("grayscale")]
    rows = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_folder_") as tmp:
        for n, side in ((32, 512), (512, 32)):
            src = os.path.join(tmp, f"in{side}")
            os.makedirs(src)
            imgs = np.random.default_rng(SEED + side).integers(0, 256, (n, side, side, 3),
                                                               dtype=np.uint8)
            native_io.encode_batch(imgs, [os.path.join(src, f"im{i:04d}.jpeg") for i in range(n)])
            for cmd in ("transform", "chain"):
                out_dir = os.path.join(tmp, f"{cmd}{side}")
                argv = [cmd, src, out_dir, f"--size={side}x{side}", "--stats", "--device=cuda"]
                if cmd == "chain":
                    argv.append(f"--ops={chain_spec}")

                stats, wall, launches, device_us = measure_cli(torch, mk, argv)
                want = (("rgb_blur_rotate_traced", "shear_bicubic", "blur_separable_batched")
                        if cmd == "transform" else
                        ("luma_blur_rotate" if side >= 128 else "luma_blur_rotate_packed",))
                missing = [k for k in want if not launches.get(k)]
                if missing:
                    fail(f"folder {cmd} {side}: kernels {missing} were not launched: {launches}")
                if stats["images"] != n:
                    fail(f"folder {cmd} {side}: the command read {stats['images']} of {n} images")
                # the files against the same computation redone, encoded alike
                x, paths = load_folder_images(src, size=(side, side), native=codecs["native"])
                if len(paths) != n:
                    fail(f"folder {cmd} {side}: decoded {len(paths)} of {n} images")
                xd = torch.from_numpy(x).cuda()
                stems = [os.path.splitext(os.path.basename(p))[0] for p in paths]
                if cmd == "chain":
                    arrs = {"chained": build_chain_fn(chain)(xd).cpu().numpy()}
                    names = {"chained": [f"{s}_chained.jpeg" for s in stems]}
                else:
                    res = apply_all_transformations(xd, torch.Generator("cuda").manual_seed(0))
                    arrs = {t: a.cpu().numpy() for t, (_, a) in res.items()}
                    names = {t: [f"{s}_{t}_{round(float(v[i]), 2)}_corrupted.jpeg"
                                 for i, s in enumerate(stems)]
                             for t, (v, _) in res.items()}
                written = sorted(os.listdir(out_dir))
                expect = sorted(nm for v in names.values() for nm in v)
                if written != expect:
                    fail(f"folder {cmd} {side}: {len(written)} files, expected {len(expect)} "
                         "named by their values")
                check = os.path.join(tmp, "check")
                mismatched = 0
                for t, arr in arrs.items():
                    os.makedirs(check, exist_ok=True)
                    paths_c = [os.path.join(check, nm) for nm in names[t][:8]]
                    if codecs["native"]:
                        native_io.encode_batch(arr[:8], paths_c)
                    else:
                        from PIL import Image

                        for a, pc in zip(arr[:8], paths_c):
                            Image.fromarray(a).save(pc)
                    for pc, nm in zip(paths_c, names[t][:8]):
                        with open(pc, "rb") as fa, open(os.path.join(out_dir, nm), "rb") as fb:
                            mismatched += fa.read() != fb.read()
                    shutil.rmtree(check)
                if mismatched:
                    fail(f"folder {cmd} {side}: {mismatched} files differ from the recomputation")
                row = {"phase": "folder", "command": cmd, "images": n,
                       "shape": [side, side, 3], "codec": "native" if codecs["native"] else "PIL",
                       **folder_columns(stats, wall, n, device_us),
                       "files": len(written), "files_checked": min(8, n) * len(arrs),
                       "launches": launches, "codecs": codecs}
                emit(row)
                rows.append(row)
                shutil.rmtree(out_dir)
    return rows


def run_cli(argv) -> dict:
    """``python -m imagetransformations_tpu_torch *argv`` in this process
    (``runpy``); returns the ``--stats`` line it prints last."""
    import contextlib
    import io as _io
    import runpy

    buf, saved = _io.StringIO(), sys.argv
    sys.argv = ["imagetransformations_tpu_torch", *argv]
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_module("imagetransformations_tpu_torch", run_name="__main__",
                             alter_sys=True)
    finally:
        sys.argv = saved
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def measure_cli(torch, mk, argv):
    """A CLI command three times: a warm-up; the measured run (counters
    reset just before, read just after, wall seconds); a run under
    torch.profiler for the device's kernel and copy time. Returns (stats,
    wall_s, launches, device_us)."""
    from torch.profiler import ProfilerActivity, profile

    run_cli(argv)  # warm-up: caches, first launches
    torch.cuda.synchronize()
    for k in mk.LAUNCHES:
        mk.LAUNCHES[k] = 0
    t0 = time.perf_counter()
    stats = run_cli(argv)
    wall = time.perf_counter() - t0
    launches = {k: v for k in mk.LAUNCHES if (v := row_launches(mk.LAUNCHES, k))}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_cli(argv)
    device_us = {"kernels": 0.0, "copies": 0.0}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            kind = "copies" if e.key.startswith(("Memcpy", "Memset")) else "kernels"
            device_us[kind] += getattr(e, "self_device_time_total", 0) or 0
    return stats, wall, launches, device_us


def folder_columns(stats: dict, wall: float, n: int, device_us: dict) -> dict:
    """The columns every folder row reports: wall and stage seconds, images
    a second end to end, the device's kernel and copy time and busy shares."""
    return {"wall_s": wall, "stage_s": {k: stats[k] for k in (
                "decode_s", "h2d_s", "compute_s", "d2h_s", "encode_s")},
            "compute_event_ms": stats.get("compute_event_ms"),
            "images_per_s": n / wall,
            "device_kernel_ms": device_us["kernels"] / 1e3,
            "device_copy_ms": device_us["copies"] / 1e3,
            "device_busy_share": (device_us["kernels"] + device_us["copies"]) / 1e6
            / wall if device_us["kernels"] > 0 else None,
            "kernel_busy_share": device_us["kernels"] / 1e6 / wall
            if device_us["kernels"] > 0 else None}


def folder_corrupt_run(torch, mk) -> dict:
    """The folder phase's ``corrupt`` command on the card: a folder of PNGs
    (256 at 32x32x3, written from a seed) through the store's 19
    corruptions at severities 1-5 (``corrupt --stats --device=cuda``),
    measured as the other folder runs. ``rotation`` is not in the store, so
    no kernel of the port need launch; the files must equal each cell
    recomputed here with its generator (``workflows.corruption_generator``),
    on 8 images a cell. The PNGs need PIL: without it the run is not
    measured."""
    import tempfile

    import numpy as np

    from imagetransformations_tpu_torch.evalx.harness import corrupt
    from imagetransformations_tpu_torch.workflows import STORE_CORRUPTIONS, corruption_generator

    try:
        from PIL import Image
    except ImportError:
        print("chip_smoke: folder corrupt run not measured: its PNGs need PIL", flush=True)
        return {"phase": "folder", "command": "corrupt", "measured": False}
    n, side = FOLDER_CORRUPT_IMAGES, 32
    imgs = np.random.default_rng(SEED + 77).integers(0, 256, (n, side, side, 3), dtype=np.uint8)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_corrupt_") as tmp:
        src, out_dir = os.path.join(tmp, "in"), os.path.join(tmp, "out")
        os.makedirs(src)
        for i, im in enumerate(imgs):
            Image.fromarray(im).save(os.path.join(src, f"im{i:04d}.png"))
        argv = ["corrupt", src, out_dir, f"--size={side}x{side}", "--stats", "--device=cuda"]
        stats, wall, launches, device_us = measure_cli(torch, mk, argv)
        if stats["images"] != n:
            fail(f"folder corrupt: the command read {stats['images']} of {n} images")
        written = sorted(os.listdir(out_dir))
        expect = sorted(f"im{i:04d}_{name}_severity{sev}.png" for i in range(n)
                        for name in STORE_CORRUPTIONS for sev in range(1, 6))
        if written != expect:
            fail(f"folder corrupt: {len(written)} files, expected {len(expect)} named by cell")
        xd = torch.from_numpy(imgs).cuda()
        mismatched = 0
        for name in STORE_CORRUPTIONS:
            for sev in range(1, 6):
                want = corrupt(xd, name, sev, corruption_generator(0, name, sev, xd.device))
                want = want[:8].cpu().numpy()
                for i in range(8):
                    fn = os.path.join(out_dir, f"im{i:04d}_{name}_severity{sev}.png")
                    mismatched += not np.array_equal(np.asarray(Image.open(fn)), want[i])
        if mismatched:
            fail(f"folder corrupt: {mismatched} files differ from the recomputation")
    return {"phase": "folder", "command": "corrupt", "images": n, "shape": [side, side, 3],
            "codec": "PIL (PNG)", "cells": len(STORE_CORRUPTIONS) * 5,
            **folder_columns(stats, wall, n, device_us),
            "outputs_per_s": len(written) / wall, "files": len(written),
            "files_checked": 8 * len(STORE_CORRUPTIONS) * 5, "launches": launches}


def corrupt_phase(torch, mk) -> dict:
    """Every corruption of ``evalx.harness`` (the store's 19, rotation and
    translation) at severities 1-5 through ``harness.corrupt`` on the card,
    at 10000x32x32x3 (the CIFAR-10 test set) and 64x224x224x3
    (ImageNet-C), random u8 from a seed, with explicit draws made by numpy
    (``harness.numpy_draws``) and copied to the card outside the timing.
    The CPU path recomputes the first 256 (32x32) or 8 (224x224) images of
    each cell with the same draws: every generator is per-image, so those
    rows must agree within 1 LSB. ``rotation`` must launch the NEAREST
    rotation kernel (#12); the counters are reset just before each card run
    and read just after. Per cell: ms a call (CUDA events), max LSB against
    the CPU and the share of values that differ; per shape the store's
    total ms (95 cells) and the CPU path's seconds. Returns the phase's
    launches by kernel."""
    import numpy as np

    from imagetransformations_tpu_torch.evalx import harness as hs
    from imagetransformations_tpu_torch.workflows import STORE_CORRUPTIONS

    names = [*hs.CORRUPTIONS, *hs.EXTRA_CORRUPTIONS]
    launches = {k: 0 for k in mk.LAUNCHES}
    for n, h, w in CORRUPT_SHAPES:
        imgs = np.random.default_rng(SEED + 13 + h).integers(0, 256, (n, h, w, 3),
                                                              dtype=np.uint8)
        m = CORRUPT_CPU_IMAGES[h]
        x = torch.from_numpy(imgs).cuda()
        xc = torch.from_numpy(imgs[:m].copy())
        cells, cpu_s, t_phase = [], 0.0, time.perf_counter()
        for name in names:
            for sev in range(1, 6):
                rng = np.random.default_rng([SEED, h, names.index(name), sev])
                draws = hs.numpy_draws(imgs, name, sev, rng)
                dd = {k: torch.from_numpy(v).cuda() for k, v in draws.items()}
                # the first m images' draws: glass_blur's offsets lead with the iterations
                dc = {k: torch.from_numpy(np.ascontiguousarray(v[:, :m] if k == "offsets"
                                                               else v[:m]))
                      for k, v in draws.items()}
                torch.cuda.synchronize()
                for k in mk.LAUNCHES:
                    mk.LAUNCHES[k] = 0
                out = hs.corrupt(x, name, sev, None, **dd)
                torch.cuda.synchronize()
                run_launches = {k: v for k in mk.LAUNCHES if (v := row_launches(mk.LAUNCHES, k))}
                for k, v in run_launches.items():
                    launches[k] += v
                if name == "rotation" and not run_launches.get("pil_rotate_nearest"):
                    fail(f"corrupt rotation {sev} at {h}x{w}: kernel #12 was not launched: "
                         f"{run_launches}")
                if out.shape != x.shape or out.dtype != torch.uint8:
                    fail(f"corrupt {name} {sev}: bad output {tuple(out.shape)} {out.dtype}")
                t0 = time.perf_counter()
                want = hs.corrupt(xc, name, sev, None, **dc)
                cpu_s += time.perf_counter() - t0
                d = (out[:m].cpu().to(torch.int16) - want.to(torch.int16)).abs()
                lsb, share = int(d.max()), float((d > 0).double().mean())
                if lsb > 1:
                    fail(f"corrupt {name} {sev} at {h}x{w}: the card differs from the CPU by "
                         f"{lsb} LSB on {share:.2%} of values")
                ms = time_ms(torch, lambda: hs.corrupt(x, name, sev, None, **dd), 3)
                cells.append({"name": name, "severity": sev, "ms": ms, "max_lsb_vs_cpu": lsb,
                              "share_differing": share, "launches": run_launches})
                del out, dd, dc, draws
        store = [c for c in cells if c["name"] in STORE_CORRUPTIONS]
        slowest = sorted(store, key=lambda c: -c["ms"])[:5]
        emit({"phase": "corrupt", "shape": [n, h, w, 3], "cells": cells,
              "store_ms": sum(c["ms"] for c in store), "store_cells": len(store),
              "all_ms": sum(c["ms"] for c in cells),
              "slowest_store_cells": [[c["name"], c["severity"], c["ms"]] for c in slowest],
              "max_lsb_vs_cpu": max(c["max_lsb_vs_cpu"] for c in cells),
              "cells_differing": sum(c["max_lsb_vs_cpu"] > 0 for c in cells),
              "cpu_images": m, "cpu_s": cpu_s, "phase_s": time.perf_counter() - t_phase})
        del x, xc, imgs
        torch.cuda.empty_cache()
    return launches


# phase models: (model, images, side, evaluate_batched's batch size (None: one
# call on the whole batch), predictive samples, images the CPU recomputes)
MODEL_ROWS = (
    ("resnet20", 10000, 32, 256, None, 64),
    ("resnet56", 10000, 32, 256, None, 64),
    ("simple_cnn", 10000, 32, 256, None, 64),
    ("bayesian_cnn", 1000, 32, None, 50, 64),
    ("resnet18", 256, 224, None, None, 4),
    ("resnet50", 256, 224, None, None, 4),
    ("vgg19_bn", 64, 224, None, None, 4),
)
# f32 outside the tensor cores (no TF32): 67 TFLOP/s counts an FMA as two
F32_FMA_PER_S = 67e12 / 2
# phase sweep: the CIFAR-10 test set's size, the images the CPU recomputes
SWEEP_IMAGES, SWEEP_CPU_IMAGES = 10000, 64


def make_model(name: str, device: str):
    from imagetransformations_tpu_torch import models as pm

    return {"resnet20": lambda: pm.resnet20(device=device),
            "resnet56": lambda: pm.resnet56(device=device),
            "simple_cnn": lambda: pm.SimpleCNN(device=device),
            "bayesian_cnn": lambda: pm.BayesianCNN(device=device),
            "resnet18": lambda: pm.ResNet18(device=device),
            "resnet50": lambda: pm.ResNet50(device=device),
            "vgg19_bn": lambda: pm.VGG19BN(device=device)}[name]()


def macs_per_image(torch, model, x1) -> int:
    """Multiply-adds of one image's forward (``x1``: a batch of one), from the
    shapes each convolution and dense layer sees (forward hooks)."""
    from imagetransformations_tpu_torch.models.bayesian import (
        BayesianCNN,
        BayesianConv,
        BayesianDense,
    )

    total = [0]

    def hook(mod, inp, out):
        if isinstance(mod, torch.nn.Conv2d):
            k = mod.in_channels // mod.groups * mod.kernel_size[0] * mod.kernel_size[1]
        elif isinstance(mod, BayesianConv):
            k = mod.mu[0].numel()
        elif isinstance(mod, torch.nn.Linear):
            k = mod.in_features
        else:  # BayesianDense
            k = mod.mu.shape[1]
        total[0] += out[0].numel() * k

    kinds = (torch.nn.Conv2d, torch.nn.Linear, BayesianConv, BayesianDense)
    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, kinds)]
    try:
        with torch.no_grad():
            if isinstance(model, BayesianCNN):
                model(x1, generator=torch.Generator(device=x1.device).manual_seed(0))
            else:
                model(x1)
    finally:
        for h in handles:
            h.remove()
    return total[0]


def logits_budget(torch, card, cpu, what: str) -> dict:
    """Card logits against the CPU's: max |difference| <= 1e-3 * max(1,
    max |logit|), and the same argmax except where the CPU's top two logits
    are within that budget. Fails otherwise."""
    card = card.float().cpu()
    budget = 1e-3 * max(1.0, float(cpu.abs().max()))
    err = float((card - cpu).abs().max())
    top2 = torch.topk(cpu, 2, dim=-1).values
    close = (top2[:, 0] - top2[:, 1]) <= budget
    agree = torch.argmax(card, -1) == torch.argmax(cpu, -1)
    if err > budget or not bool((agree | close).all()):
        fail(f"{what}: card against CPU max |d| {err} (budget {budget}), argmax differs on "
             f"{int((~agree).sum())} images ({int((~agree & close).sum())} with close top-2)")
    return {"max_abs_vs_cpu": err, "budget": budget, "argmax_equal": int(agree.sum()),
            "argmax_differs_close_top2": int((~agree).sum())}


def models_phase(torch) -> list:
    """Each classifier of ``models`` at full width on the card, random
    weights from a seed: ms for the whole batch (CUDA events, 3 runs after 2
    warm-ups) and images a second; the bound (the forward's multiply-adds,
    counted from its layers' shapes, over the f32 FMA rate, no TF32) and the
    share of it reached; peak device memory; the card's logits against the
    CPU's on the first images; the same forward with TF32 switched on by
    the caller, bit-equal to TF32 off (``full_f32``). The CIFAR nets run as
    ``evaluate_batched`` runs them (batches of 256), the BNN as 50
    predictive samples, the ImageNet nets one call on the whole batch. The
    BNN's card-against-CPU check runs a copy at its means (rho -100), since
    the two devices draw other weights."""
    import copy

    from imagetransformations_tpu_torch.evalx import harness as hs
    from imagetransformations_tpu_torch.models import bayesian as pb
    from imagetransformations_tpu_torch.models.imagenet import imagenet_model_space
    from imagetransformations_tpu_torch.models.resnet import cifar_model_space

    rows = []
    for name, n, side, batch, samples, m in MODEL_ROWS:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(SEED)
            cpu_model = make_model(name, "cpu")
        model = copy.deepcopy(cpu_model).cuda()
        space = cifar_model_space if side == 32 else imagenet_model_space
        x = images(torch, (n, side, side), SEED + 200)
        labels = torch.zeros(n, dtype=torch.int64, device="cuda")
        if batch is not None:
            def run():
                return hs.evaluate_batched(model, space, x, labels, batch, metric_names=(),
                                           device="cuda")["logits"]
        elif samples is not None:
            def run():
                g = torch.Generator(device="cuda").manual_seed(SEED)
                with torch.no_grad():
                    return pb.predictive_samples(model, space(x), g, samples)
        else:
            def run():
                with torch.no_grad():
                    return model(space(x))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out = run()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        if not bool(torch.isfinite(out).all()):
            fail(f"models {name}: non-finite logits")
        ms = time_ms(torch, run, 3)
        macs = macs_per_image(torch, model, space(x[:1])) * n * (samples or 1)
        bound = macs / F32_FMA_PER_S * 1e3
        # the card against the CPU on the first m images
        xs = space(x[:m])
        ref_cpu, ref_card = cpu_model, model
        if samples is not None:  # the BNN at its means
            ref_cpu = copy.deepcopy(cpu_model)
            with torch.no_grad():
                for mod in ref_cpu.modules():
                    if isinstance(mod, pb._Bayesian):
                        mod.rho.fill_(-100.0)
                        mod.bias_rho.fill_(-100.0)
            ref_card = copy.deepcopy(ref_cpu).cuda()

        def fwd(net, inp):
            with torch.no_grad():
                if samples is not None:
                    return net(inp, generator=torch.Generator(device=inp.device).manual_seed(0))
                return net(inp)

        t0 = time.perf_counter()
        cpu = fwd(ref_cpu, xs.cpu())
        cpu_s = time.perf_counter() - t0
        card = out[:m] if samples is None else fwd(ref_card, xs)
        check = logits_budget(torch, card, cpu, f"models {name}")
        # TF32 switched on by the caller: bit-equal to TF32 off
        with caller_tf32(torch, False):
            off = fwd(ref_card, xs)
        with caller_tf32(torch, True):
            on = fwd(ref_card, xs)
        if not torch.equal(on, off):
            fail(f"models {name}: TF32 on by the caller changed the logits by "
                 f"{float((on - off).abs().max())}")
        row = {"phase": "models", "model": name, "batch": [n, side, side, 3],
               "evaluate_batch": batch, "samples": samples, "ms": ms,
               "images_per_s": n / (ms * 1e-3), "macs_per_image": macs // n // (samples or 1),
               "bound_ms": bound, "bound_by": "operations", "bound_share": bound / ms,
               "peak_memory_bytes": peak, "cpu_images": m, "cpu_s": cpu_s, **check,
               "tf32_on_bit_equal": True,
               "parameters": sum(p.numel() for p in model.parameters())}
        emit(row)
        rows.append(row)
        del model, cpu_model, x, out, ref_card, ref_cpu
        torch.cuda.empty_cache()
    return rows


def backward_tf32_row(torch) -> dict:
    """The backward passes with TF32 switched on by the caller bit-equal to
    TF32 off: one Adam step of ``make_train_step`` on a ResNet-20 (256
    images of 32x32; every gradient and every parameter and statistic after
    the step) and ODIN's input gradient (``uq.odin``, 256 images). cuDNN
    reads the flag when a backward runs, so ``full_f32`` has to hold around
    the backward as well as the forward. cuDNN's deterministic algorithms
    both times, so that only TF32 could make the runs differ. Fails
    otherwise."""
    import copy

    from imagetransformations_tpu_torch import models as pm
    from imagetransformations_tpu_torch.models import training as pt
    from imagetransformations_tpu_torch.models.resnet import cifar_model_space
    from imagetransformations_tpu_torch.uq import odin

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        base = pm.resnet20(device="cpu").cuda()
    x = cifar_model_space(images(torch, (256, 32, 32), SEED + 300))
    y = torch.randint(0, 10, (256,), generator=torch.Generator(device="cuda").manual_seed(SEED),
                      device="cuda")
    runs = {}
    for on in (False, True):
        model = copy.deepcopy(base)
        with caller_tf32(torch, on, deterministic=True):
            grad_x = odin._input_gradient(model, x)
            pt.make_train_step(model, torch.optim.Adam(model.parameters(), lr=1e-3))(x, y)
        runs[on] = ({"input": grad_x, **{k: p.grad for k, p in model.named_parameters()}},
                    model.state_dict())
    differ = [k for k, g in runs[False][0].items() if not torch.equal(runs[True][0][k], g)]
    differ += [k for k, v in runs[False][1].items() if not torch.equal(runs[True][1][k], v)]
    if differ:
        fail(f"sweep: TF32 on by the caller changed the backward passes: {differ[:8]}")
    row = {"phase": "sweep", "check": "backward_tf32_on_bit_equal", "batch": [256, 32, 32, 3],
           "tensors": len(runs[False][0]) + len(runs[False][1]), "differ": 0}
    emit(row)
    return row


def sweep_phase(torch, mk) -> dict:
    """``corruption_sweep`` with ``uq_extras`` on the card: a ResNet-20
    trained by the demo recipe (``utils.demo.get_model``: 512 synthetic
    images, 3 epochs) on the card; Mahalanobis fitted on its clean training
    features; ODIN at T 1000, eps 0.0014; the 15 canonical corruptions and
    ``rotation`` (the NEAREST rotation kernel) at severities 1-5 over 10 000
    synthetic 32x32 test images, one generator a cell from the seed. Per
    cell: wall ms (host clock around the cell, synchronized) and CUDA-event
    ms; the total; #12's launches, counters reset just before the 80 cells
    and read just after (fails if none). Then the same 80 cells on the first
    64 images, on the card and on the CPU with the same per-cell numpy draws
    (``harness.numpy_draws``), the same model and the same Mahalanobis state:
    |d accuracy| <= 1/64 and |d AUROC| <= 0.01 in every column (fails
    otherwise). Returns the launches of the 80-cell run by kernel."""
    import copy

    import numpy as np

    from imagetransformations_tpu_torch.evalx import harness as hs
    from imagetransformations_tpu_torch.pipeline.datasets import synthetic
    from imagetransformations_tpu_torch.uq import mahalanobis as maha
    from imagetransformations_tpu_torch.utils import demo

    names = (*hs.CORRUPTIONS, "rotation")
    xtr, ytr = synthetic(512, seed=0)
    xte, yte = synthetic(SWEEP_IMAGES, seed=1)
    t0 = time.perf_counter()
    model_fn, space, model = demo.get_model(xtr, ytr, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    with torch.no_grad():
        st = maha.fit(model.features(space(torch.from_numpy(xtr).cuda())))
    extras = {"feats_logits_fn": model.features_and_logits, "maha_mean": st.mean,
              "maha_precision": st.precision}
    x, y = torch.from_numpy(xte).cuda(), torch.from_numpy(yte).cuda()
    metrics = ("shannon_entropy", "msp", "margin", "energy")

    def cell(name, sev, imgs, labels):
        return hs.corruption_sweep(model_fn, space, imgs, labels, seed=SEED,
                                   corruption_names=(name,), severities=(sev,),
                                   metric_names=metrics, uq_extras=extras,
                                   device="cuda")[name][sev]

    cell("gaussian_noise", 1, x[:512], y[:512])  # warm-up
    torch.cuda.synchronize()
    for k in mk.LAUNCHES:
        mk.LAUNCHES[k] = 0
    cells, t_all = [], time.perf_counter()
    for name in names:
        for sev in range(1, 6):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            res = cell(name, sev, x, y)
            end.record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
            vals = [res["accuracy"], *res["auroc"].values()]
            if not all(0.0 <= v <= 1.0 for v in vals) or len(res["auroc"]) != len(metrics) + 2:
                fail(f"sweep {name} {sev}: bad result {res}")
            cells.append({"name": name, "severity": sev, "ms": wall,
                          "event_ms": start.elapsed_time(end), **res})
    total_s = time.perf_counter() - t_all
    launches = {k: v for k in mk.LAUNCHES if (v := row_launches(mk.LAUNCHES, k))}
    if not launches.get("pil_rotate_nearest"):
        fail(f"sweep: kernel #12 was not launched by the rotation cells: {launches}")
    # the card against the CPU on the first images, with numpy draws
    m = SWEEP_CPU_IMAGES
    imgs, labels = xte[:m], yte[:m]
    draws = {(nm, sev): hs.numpy_draws(imgs, nm, sev,
                                       np.random.default_rng([SEED, 14, names.index(nm), sev]))
             for nm in names for sev in range(1, 6)}
    cpu_model = copy.deepcopy(model).cpu()

    def small(net, dev, mstate):
        return hs.corruption_sweep(net, space, imgs, labels, corruption_names=names,
                                   metric_names=metrics, batch_size=m,
                                   cell_draws=lambda nm, sev: draws[(nm, sev)],
                                   uq_extras={"feats_logits_fn": net.features_and_logits,
                                              "maha_mean": mstate.mean,
                                              "maha_precision": mstate.precision},
                                   device=dev)

    card64 = small(model, "cuda", st)
    t0 = time.perf_counter()
    cpu64 = small(cpu_model, "cpu", maha.MahalanobisState(st.mean.cpu(), st.precision.cpu()))
    cpu_s = time.perf_counter() - t0
    d_acc = d_auc = 0.0
    differing = 0
    for nm in names:
        for sev in range(1, 6):
            g, w = card64[nm][sev], cpu64[nm][sev]
            da = abs(g["accuracy"] - w["accuracy"])
            du = max(abs(g["auroc"][k] - w["auroc"][k]) for k in w["auroc"])
            if da > 1 / m or du > 0.01:
                fail(f"sweep {nm} {sev}: card against CPU on {m} images: |d accuracy| {da}, "
                     f"|d AUROC| {du}")
            differing += da > 0 or du > 0
            d_acc, d_auc = max(d_acc, da), max(d_auc, du)
    slowest = sorted(cells, key=lambda c: -c["ms"])[:5]
    emit({"phase": "sweep", "shape": [SWEEP_IMAGES, 32, 32, 3], "cells": cells,
          "total_s": total_s, "cell_ms_mean": total_s * 1e3 / len(cells), "train_s": train_s,
          "slowest_cells": [[c["name"], c["severity"], c["ms"]] for c in slowest],
          "launches": launches, "cpu_images": m, "cpu_s": cpu_s,
          "max_d_accuracy_vs_cpu": d_acc, "max_d_auroc_vs_cpu": d_auc,
          "cells_differing_vs_cpu": differing, "metrics": [*metrics, "odin", "mahalanobis"]})
    return {k: v for k, v in launches.items()}


def sweep_cli_rows(torch, mk) -> list:
    """The ``sweep`` and ``report`` commands on the card, in process, on
    synthetic data (an empty ``--data-root``), ``--severities=1``: wall
    seconds, the commands' stage seconds (``--stats``) and the device's
    kernel and copy time under torch.profiler over a third run's wall (the
    folder rows' busy share); the files each wrote (PNGs need matplotlib)."""
    import tempfile

    rows = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_sweep_") as tmp:
        for cmd in ("sweep", "report"):
            out_dir = os.path.join(tmp, cmd)
            argv = [cmd, f"--data-root={tmp}", f"--out-dir={out_dir}", "--severities=1",
                    "--device=cuda", "--stats"]
            stats, wall, launches, device_us = measure_cli(torch, mk, argv)
            busy = (device_us["kernels"] + device_us["copies"]) / 1e6 / wall
            row = {"phase": "sweep", "command": cmd, "wall_s": wall, "stats": stats,
                   "device_kernel_ms": device_us["kernels"] / 1e3,
                   "device_copy_ms": device_us["copies"] / 1e3,
                   "device_busy_share": busy if device_us["kernels"] > 0 else None,
                   "launches": launches, "files": sorted(os.listdir(out_dir))}
            emit(row)
            rows.append(row)
    return rows


# phases swag and refine: the CIFAR-10 sets' sizes (synthetic images), the
# images the CPU recomputes, and the reference's settings
UQ_TRAIN_IMAGES, UQ_TEST_IMAGES, UQ_CPU_IMAGES = 50000, 10000, 64
# cifar_swag.py collects for 50 epochs of 391 steps; cut to 200 steps
SWAG_STEPS, SWAG_BATCH, SWAG_RANK, SWAG_LR = 200, 128, 20, 1e-4
SWAG_SAMPLES, SWAG_EVAL_SAMPLES, SWAG_CPU_STEPS, SWAG_CPU_SAMPLES = 30, 10, 4, 3
REFINE_EPS, REFINE_ITERS, REFINE_MSP_STOP = 0.03, 10, 0.998
ATTACK_EPS, PGD_ALPHA, PGD_STEPS = 8 / 255, 2 / 255, 10
KNN_K, LAPLACE_SAMPLES = 10, 30
# card against CPU. The SWAG mean's max |d| over the largest |mean|: the
# training steps of a random-init ResNet-56 are ill-conditioned in f32 (on
# the CPU alone, 1 against 8 threads moves the 4-step mean by 5.1e-6, 1.6%
# of its largest movement), so 1e-4, not 1e-5. The BMA's probabilities and
# entropies (nats), max |d|: 1e-4 from one SWAG state and weights on both
# devices; end to end 5e-3 (each device collects its own, and SWAG's
# variances at lr 1e-4 are differences of nearly equal moments: the CPU
# alone, 1 against 8 threads, differs by 1.9e-4 / 1.1e-4). The Laplace
# outputs' max |d| over the tensor's max |value|. FGSM's and reverse
# FGSM's values allowed to differ (a gradient sign near 0). In images:
# PGD's 10 steps carry one differing sign through every later step of that
# image, so PGD is held by its accuracy; ``minimal_epsilon`` gives one level
# an image, and one differing sign can move an image that sits at a level's
# edge (1 of 64 in log call 6). Flip counts.
SWAG_MEAN_REL, BMA_ABS, BMA_E2E_ABS = 1e-4, 1e-4, 5e-3
LAPLACE_REL, ATTACK_SHARE, ATTACK_IMAGES, FLIP_COUNT = 1e-4, 1e-3, 2, 1


def once_ms(torch, fn):
    """(ms, result) of one fn() call: CUDA events around it, synchronized."""
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def reset_launches(mk) -> None:
    for k in mk.LAUNCHES:
        mk.LAUNCHES[k] = 0


def scaled_err(got: dict, want: dict) -> float:
    """Largest over the tensors of max |got - want| / max |want|."""
    return max(float((g.cpu() - want[k]).abs().max()) / max(float(want[k].abs().max()), 1e-30)
               for k, g in got.items())


def swag_phase(torch, mk, xtr, ytr, xte) -> dict:
    """``workflows.swag_pipeline`` on the card, the reference's
    attacks/cifar10-unvertainty/swag/cifar_swag.py on its ResNet-56 at full
    width from a seeded init (no pretrained weights in the repository):
    ``swag_collect`` (SGD lr 1e-4, momentum 0.9, batch 128, rank 20, an
    update a step) for 200 steps over synthetic CIFAR-shaped images (the
    reference: 50 epochs of 391), 30 weight samples, the first 10 of them
    in ``bma_logits`` over 10 000 test images. Wall s of the whole call,
    collection ms a step (the host clock, synchronized when the batches run
    out), then ``sample_many`` ms and the BMA's ms against 10 forwards'
    bound (multiply-adds over the f32 FMA rate), both with CUDA events on
    the collected state; peak device memory; the kernels' launches (none
    expected). Then card against CPU: 4 collection steps on the same 64
    images, the same explicit draws, BMA on those 64: the SWAG mean within
    1e-4 of the largest mean, the BMA's probabilities and entropies within
    1e-4 when the CPU samples from the card's state and weights, within
    5e-3 end to end, nothing NaN. Fails otherwise (after printing the
    row)."""
    import copy

    from imagetransformations_tpu_torch import workflows as wf
    from imagetransformations_tpu_torch.models.resnet import cifar_model_space
    from imagetransformations_tpu_torch.uq import mc as umc
    from imagetransformations_tpu_torch.uq import swag

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        cpu_model = make_model("resnet56", "cpu")
    model = copy.deepcopy(cpu_model).cuda()
    n = SWAG_STEPS * SWAG_BATCH
    xtr_d, ytr_d = torch.from_numpy(xtr[:n]).cuda(), torch.from_numpy(ytr[:n]).long().cuda()
    x_eval = cifar_model_space(torch.from_numpy(xte).cuda())
    collect = {}

    def train_iter():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(SWAG_STEPS):
            s = slice(i * SWAG_BATCH, (i + 1) * SWAG_BATCH)
            yield cifar_model_space(xtr_d[s]), ytr_d[s]
        torch.cuda.synchronize()  # the last step and its update have run
        collect["s"] = time.perf_counter() - t0

    reset_launches(mk)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = wf.swag_pipeline(model, train_iter, x_eval, torch.Generator(device="cuda").manual_seed(SEED),
                           num_weight_samples=SWAG_SAMPLES, eval_mc_samples=SWAG_EVAL_SAMPLES,
                           max_rank=SWAG_RANK, lr=SWAG_LR, device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    launches = {k: v for k, v in mk.LAUNCHES.items() if v}
    state = out["swag_state"]
    m = UQ_TEST_IMAGES
    if (tuple(out["probs"].shape) != (m, 10) or state.n_models != SWAG_STEPS
            or not all(bool(torch.isfinite(out[k]).all())
                       for k in ("probs", "entropy", "one_minus_max", "jsd", "variance"))
            or float(out["variance"].min()) < 0.0):
        fail(f"swag: bad pipeline output (n_models {state.n_models})")
    sample_ms, stacked = once_ms(torch, lambda: swag.sample_many(
        state, SWAG_SAMPLES, torch.Generator(device="cuda").manual_seed(SEED)))
    take = {k: v[:SWAG_EVAL_SAMPLES] for k, v in stacked.items()}
    bma_ms, logits = once_ms(torch, lambda: swag.bma_logits(model, take, x_eval))
    if not bool(torch.isfinite(logits).all()):
        fail("swag: non-finite BMA logits")
    bound = macs_per_image(torch, model, x_eval[:1]) * m / F32_FMA_PER_S * 1e3
    del stacked, take, logits, xtr_d, ytr_d
    # the card against the CPU on the same 64 images: 4 collection steps and
    # the same draws on each; then sampling and BMA on the CPU from the
    # card's state and weights
    k = UQ_CPU_IMAGES
    x64 = cifar_model_space(torch.from_numpy(xtr[:k]))
    y64 = torch.from_numpy(ytr[:k]).long()
    draws = [swag.draw(swag.init(cpu_model, SWAG_RANK), torch.Generator().manual_seed(SEED + s))
             for s in range(SWAG_CPU_SAMPLES)]

    def on(dev, d):
        return {"z_low": d["z_low"].to(dev), "z_diag": {n: v.to(dev) for n, v in d["z_diag"].items()}}

    def small(net, dev):
        xs, ys = x64.to(dev), y64.to(dev)
        return wf.swag_pipeline(net, lambda: [(xs, ys)] * SWAG_CPU_STEPS, xs,
                                num_weight_samples=SWAG_CPU_SAMPLES,
                                eval_mc_samples=SWAG_CPU_SAMPLES, max_rank=SWAG_RANK, lr=SWAG_LR,
                                draws=[on(dev, d) for d in draws], device=dev)

    card_net = copy.deepcopy(cpu_model).cuda()
    card = small(card_net, "cuda")
    t0 = time.perf_counter()
    cpu = small(copy.deepcopy(cpu_model), "cpu")
    cs = card["swag_state"]
    same_state = swag.SwagState(*({n: v.cpu() for n, v in getattr(cs, f).items()}
                                  for f in ("mean", "sq_mean", "deviations")),
                                cs.n_models, cs.max_rank)
    logits = swag.bma_logits(copy.deepcopy(card_net).cpu(),
                             swag.sample_many(same_state, SWAG_CPU_SAMPLES, draws=draws), x64)
    same = {"probs": torch.mean(torch.softmax(logits, -1), 0),
            "entropy": umc.predictive_entropy(logits, base2=False)}
    cpu_s = time.perf_counter() - t0
    scale = max(float(v.abs().max()) for v in cpu["swag_state"].mean.values())
    mean_err = max(float((cs.mean[n].cpu() - v).abs().max())
                   for n, v in cpu["swag_state"].mean.items()) / scale
    e2e = {n: float((card[n].cpu() - cpu[n]).abs().max()) for n in ("probs", "entropy")}
    same_err = {n: float((card[n].cpu() - same[n]).abs().max()) for n in ("probs", "entropy")}
    nan = any(bool(torch.isnan(card[n]).any())
              for n in ("probs", "entropy", "one_minus_max", "jsd", "variance"))
    row = {"phase": "swag", "model": "resnet56", "steps": SWAG_STEPS, "batch": SWAG_BATCH,
           "max_rank": SWAG_RANK, "lr": SWAG_LR, "weight_samples": SWAG_SAMPLES,
           "bma_samples": SWAG_EVAL_SAMPLES, "eval_images": m, "wall_s": wall,
           "collect_ms_per_step": collect["s"] * 1e3 / SWAG_STEPS,
           "sample_many_ms": sample_ms, "bma_s": bma_ms / 1e3,
           "bma_ms_per_sample": bma_ms / SWAG_EVAL_SAMPLES,
           "forward_bound_ms": bound, "bound_share": bound * SWAG_EVAL_SAMPLES / bma_ms,
           "peak_memory_bytes": peak, "launches": launches,
           "mean_entropy_nats": float(out["entropy"].mean()),
           "mean_variance": float(out["variance"].mean()),
           "cpu_images": k, "cpu_steps": SWAG_CPU_STEPS, "cpu_s": cpu_s,
           "mean_err_vs_cpu": mean_err, "bma_max_abs_vs_cpu": e2e,
           "bma_max_abs_vs_cpu_same_state": same_err}
    emit(row)
    if (mean_err > SWAG_MEAN_REL or nan or max(e2e.values()) > BMA_E2E_ABS
            or max(same_err.values()) > BMA_ABS):
        fail(f"swag: card against CPU on {k} images: mean {mean_err} (budget {SWAG_MEAN_REL}), "
             f"BMA {e2e} (budget {BMA_E2E_ABS}), from one state {same_err} (budget {BMA_ABS}), "
             f"NaN {nan}")
    return row


def differing_share(a, b) -> float:
    return float((a.cpu() != b.cpu()).float().mean())


def refine_phase(torch, mk, xtr, ytr, xte, yte) -> dict:
    """The refinement workflow, the attacks, kNN and Laplace on the card,
    with the demo ResNet-20 (``utils.demo.get_model``, trained on the card
    on 512 of the synthetic train images): ``refinement_pipeline``
    (``shannon_entropy``, eps 0.03, <= 10 iterations, MSP stop 0.998) over
    10 000 synthetic test images, then ``refine_batch`` alone on the same
    flagged images (ms an iteration against 3 forwards' bound: forward,
    input backward, re-score) and again with the clip at the model space's
    range, against the JAX package's [0, 1] on normalized inputs (ROADMAP
    C.2); ``fgsm_attack``, ``reverse_fgsm`` (the original labels) at 8/255,
    ``pgd_attack`` (10 steps of 2/255, a seeded random start) and
    ``minimal_epsilon`` (16 levels) in pixel space (``renormalize`` inside
    the model); the penultimate features of 50 000 train and the 10 000
    test images, ``knn_label_entropy`` (k 10, cosine and euclidean),
    ``nearest_feature_distance`` and Laplace ``fit`` / ``predictive`` (30
    samples) / ``closed_form_variance``. Seconds of each call (synchronized
    host clock), accuracies, flips, iterations, peak device memory, the
    kernels' launches (none expected). Then card against CPU on 64 images
    (the CPU a copy of the model; kNN and Laplace on the card's features):
    flip counts within 1, FGSM's and reverse FGSM's outputs differing on
    <= 0.1% of values, PGD's correct images within 2 (one differing sign
    changes the rest of an image's walk), ``minimal_epsilon``'s levels on
    all but 2 images, kNN entropies and labels equal, Laplace's variances and probabilities
    within 1e-4 of each tensor's scale. Fails otherwise (after printing
    the row)."""
    import copy

    from imagetransformations_tpu_torch import attacks
    from imagetransformations_tpu_torch import workflows as wf
    from imagetransformations_tpu_torch.adapt import refine
    from imagetransformations_tpu_torch.evalx.analysis import flip_analysis
    from imagetransformations_tpu_torch.models.resnet import CIFAR_MEAN, CIFAR_STD, to_unit
    from imagetransformations_tpu_torch.uq import knn, laplace
    from imagetransformations_tpu_torch.uq import metrics as um
    from imagetransformations_tpu_torch.uq.calibration import youden_threshold
    from imagetransformations_tpu_torch.utils import demo

    model_fn, space, model = demo.get_model(xtr[:512], ytr[:512], device="cuda", seed=SEED)
    model.eval()
    row = {"phase": "refine", "model": "resnet20 (demo recipe)", "images": len(xte)}
    xte_d, yte_d = torch.from_numpy(xte).cuda(), torch.from_numpy(yte).long().cuda()

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        row[f"{name}_s"] = time.perf_counter() - t0
        return out

    reset_launches(mk)
    torch.cuda.reset_peak_memory_stats()
    res = timed("refinement_pipeline", lambda: wf.refinement_pipeline(
        model_fn, space, xte_d, yte_d, metric="shannon_entropy", eps=REFINE_EPS,
        max_iters=REFINE_ITERS, msp_stop=REFINE_MSP_STOP, device="cuda"))
    if res["n"] != len(xte) or not 0 <= res["refine_iters"] <= REFINE_ITERS:
        fail(f"refine: bad result {res}")
    row["pipeline"] = res
    # refine_batch alone on the same flagged images, and with the clip at
    # the model space's range
    x = space(xte_d)
    with torch.no_grad():
        logits = model_fn(x)
        score = um.shannon_entropy(logits)
        err = (torch.argmax(logits, -1) != yte_d).to(torch.float32)
        flagged = score > youden_threshold(score, err)
    lo = float(((0.0 - CIFAR_MEAN) / CIFAR_STD).min())
    hi = float(((1.0 - CIFAR_MEAN) / CIFAR_STD).max())
    x_ref, iters = timed("refine_batch", lambda: refine.refine_batch(
        model_fn, x, flagged, eps=REFINE_EPS, max_iters=REFINE_ITERS, msp_stop=REFINE_MSP_STOP))
    x_wide, iters_wide = timed("refine_batch_model_range", lambda: refine.refine_batch(
        model_fn, x, flagged, eps=REFINE_EPS, max_iters=REFINE_ITERS, msp_stop=REFINE_MSP_STOP,
        clip_min=lo, clip_max=hi))
    with torch.no_grad():
        after, after_wide = model_fn(x_ref), model_fn(x_wide)
    outside = (x < 0.0) | (x > 1.0)
    fwd_bound = macs_per_image(torch, model, x[:1]) * len(xte) / F32_FMA_PER_S * 1e3
    row.update({
        "refine_iters": iters, "n_flagged": int(flagged.sum()),
        "refine_ms_per_iter": row["refine_batch_s"] * 1e3 / max(iters, 1),
        "iter_bound_ms": 3 * fwd_bound, "forward_bound_ms": fwd_bound,
        "clip01_outside_share": float(outside.float().mean()),
        "clip01_outside_share_flagged": float(outside[flagged].float().mean()),
        "clip01_flips": flip_analysis(logits, after, yte_d),
        "model_range_clip": [lo, hi], "model_range_iters": iters_wide,
        "model_range_flips": flip_analysis(logits, after_wide, yte_d),
        "clip01_vs_model_range_inputs_differ": differing_share(x_ref, x_wide)})
    del x_ref, x_wide
    # the attacks in pixel space
    x01 = to_unit(xte_d).permute(0, 3, 1, 2)

    def pixel_fn(xp):
        return model(attacks.renormalize(xp, CIFAR_MEAN, CIFAR_STD))

    def acc(xp):
        with torch.no_grad():
            return float((torch.argmax(pixel_fn(xp), -1) == yte_d).float().mean())

    row["accuracy_clean"] = acc(x01)
    adv = timed("fgsm", lambda: attacks.fgsm_attack(pixel_fn, x01, yte_d, ATTACK_EPS))
    row["accuracy_fgsm"] = acc(adv)
    rev = timed("reverse_fgsm", lambda: attacks.reverse_fgsm(pixel_fn, adv, yte_d, ATTACK_EPS))
    row["accuracy_reverse_fgsm"] = acc(rev)
    pgd = timed("pgd", lambda: attacks.pgd_attack(
        pixel_fn, x01, yte_d, torch.Generator(device="cuda").manual_seed(SEED), ATTACK_EPS,
        PGD_ALPHA, PGD_STEPS))
    row["accuracy_pgd"] = acc(pgd)
    meps = timed("minimal_epsilon", lambda: attacks.minimal_epsilon(pixel_fn, x01, yte_d))
    finite = torch.isfinite(meps)
    row["minimal_epsilon_flipped_share"] = float(finite.float().mean())
    row["minimal_epsilon_median"] = float(meps[finite].median()) if bool(finite.any()) else None
    del adv, rev, pgd
    # kNN and Laplace on the penultimate features
    xtr_d = torch.from_numpy(xtr).cuda()

    def features(u8):
        with torch.no_grad():
            return torch.cat([model.features(space(u8[i: i + 1000]))
                              for i in range(0, len(u8), 1000)])

    ftr = timed("features", lambda: features(xtr_d))
    fte = features(xte_d)
    ytr_d = torch.from_numpy(ytr).long().cuda()
    for metric in ("cosine", "euclidean"):
        ent, maj = timed(f"knn_{metric}", lambda: knn.knn_label_entropy(
            ftr, ytr_d, fte, KNN_K, 10, metric))
        row[f"knn_{metric}_mean_entropy"] = float(ent.mean())
        row[f"knn_{metric}_accuracy"] = float((maj == yte_d).float().mean())
    dist, _ = timed("nearest_feature_distance",
                    lambda: knn.nearest_feature_distance(ftr, ytr_d, fte))
    row["nearest_distance_mean"] = float(dist.mean())
    w, b = model.fc.weight.detach().T.contiguous(), model.fc.bias.detach()
    st = timed("laplace_fit", lambda: laplace.fit(ftr, w, b))
    mean_p, var = timed("laplace_predictive", lambda: laplace.predictive(
        st, fte, torch.Generator(device="cuda").manual_seed(SEED), LAPLACE_SAMPLES))
    cf = timed("laplace_closed_form", lambda: laplace.closed_form_variance(st, fte))
    if not all(bool(torch.isfinite(t).all()) for t in (mean_p, var, cf, dist)):
        fail("refine: non-finite kNN / Laplace output")
    row["laplace_mean_variance"] = float(var.mean())
    row["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    row["launches"] = {k: v for k, v in mk.LAUNCHES.items() if v}
    # the card against the CPU on the first images
    k = UQ_CPU_IMAGES
    cpu_model = copy.deepcopy(model).cpu()
    checks = {}
    card_res = wf.refinement_pipeline(model, space, xte_d[:k], yte_d[:k], eps=REFINE_EPS,
                                      max_iters=REFINE_ITERS, msp_stop=REFINE_MSP_STOP,
                                      device="cuda")
    t0 = time.perf_counter()
    cpu_res = wf.refinement_pipeline(cpu_model, space, xte[:k], yte[:k], eps=REFINE_EPS,
                                     max_iters=REFINE_ITERS, msp_stop=REFINE_MSP_STOP,
                                     device="cpu")
    flip_d = max(abs(card_res[f] - cpu_res[f]) for f in
                 ("n_flagged", "fixed", "broken", "changed", "stable_correct", "stable_incorrect"))
    checks["refinement_max_count_d"] = flip_d
    x01c, yc = x01[:k].cpu(), yte_d[:k].cpu()

    def cpu_pixel_fn(xp):
        return cpu_model(attacks.renormalize(xp, CIFAR_MEAN, CIFAR_STD))

    start = torch.rand(x01c.shape, generator=torch.Generator().manual_seed(SEED)) * (
        2 * ATTACK_EPS) - ATTACK_EPS
    pairs = {
        "fgsm": (attacks.fgsm_attack(pixel_fn, x01[:k], yte_d[:k], ATTACK_EPS),
                 attacks.fgsm_attack(cpu_pixel_fn, x01c, yc, ATTACK_EPS)),
        "pgd": (attacks.pgd_attack(pixel_fn, x01[:k], yte_d[:k], eps=ATTACK_EPS,
                                   alpha=PGD_ALPHA, steps=PGD_STEPS, start=start.cuda()),
                attacks.pgd_attack(cpu_pixel_fn, x01c, yc, eps=ATTACK_EPS, alpha=PGD_ALPHA,
                                   steps=PGD_STEPS, start=start)),
        "minimal_epsilon": (attacks.minimal_epsilon(pixel_fn, x01[:k], yte_d[:k]),
                            attacks.minimal_epsilon(cpu_pixel_fn, x01c, yc)),
    }
    adv_c = pairs["fgsm"][1]
    pairs["reverse_fgsm"] = (attacks.reverse_fgsm(pixel_fn, adv_c.cuda(), yte_d[:k], ATTACK_EPS),
                             attacks.reverse_fgsm(cpu_pixel_fn, adv_c, yc, ATTACK_EPS))
    for name, (g, c) in pairs.items():
        checks[f"{name}_differing_share"] = differing_share(g, c)
    g, c = pairs.pop("pgd")
    with torch.no_grad():
        hits = [int((torch.argmax(fn(a), -1).cpu() == yc).sum())
                for fn, a in ((pixel_fn, g), (cpu_pixel_fn, c))]
    checks["pgd_images_differing"] = int((g.cpu() != c).flatten(1).any(1).sum())
    checks["pgd_correct_card_cpu"] = hits
    g, c = pairs.pop("minimal_epsilon")
    checks["minimal_epsilon_images_differing"] = int((g.cpu() != c).sum())
    f64c, ftrc, ytrc = fte[:k].cpu(), ftr.cpu(), ytr_d.cpu()
    knn_equal = True
    for metric in ("cosine", "euclidean"):
        ge, gm = knn.knn_label_entropy(ftr, ytr_d, fte[:k], KNN_K, 10, metric)
        ce, cm = knn.knn_label_entropy(ftrc, ytrc, f64c, KNN_K, 10, metric)
        knn_equal &= torch.equal(ge.cpu(), ce) and torch.equal(gm.cpu(), cm)
    gd, gl = knn.nearest_feature_distance(ftr, ytr_d, fte[:k])
    cd, cl = knn.nearest_feature_distance(ftrc, ytrc, f64c)
    knn_equal &= torch.equal(gl.cpu(), cl)
    checks["knn_equal"] = bool(knn_equal)
    checks["nearest_distance_max_abs"] = float((gd.cpu() - cd).abs().max())
    cst = laplace.fit(ftrc, w.cpu(), b.cpu())
    zw = torch.randn((LAPLACE_SAMPLES, *w.shape), generator=torch.Generator().manual_seed(SEED))
    zb = torch.randn((LAPLACE_SAMPLES, 10), generator=torch.Generator().manual_seed(SEED + 1))
    gp = laplace.predictive(st, fte[:k], draws=(zw.cuda(), zb.cuda()))
    cp = laplace.predictive(cst, f64c, draws=(zw, zb))
    lap = {"w_var": (st.w_var, cst.w_var), "b_var": (st.b_var, cst.b_var),
           "predictive_var": (gp[1], cp[1]), "mean_probs": (gp[0], cp[0]),
           "closed_form": (laplace.closed_form_variance(st, fte[:k]),
                           laplace.closed_form_variance(cst, f64c))}
    checks["laplace_scaled_err"] = scaled_err({n: g for n, (g, _) in lap.items()},
                                              {n: c for n, (_, c) in lap.items()})
    checks["cpu_s"] = time.perf_counter() - t0
    row["vs_cpu"] = {"images": k, **checks}
    emit(row)
    bad = [n for n in pairs if checks[f"{n}_differing_share"] > ATTACK_SHARE]
    if (flip_d > FLIP_COUNT or bad or not knn_equal or abs(hits[0] - hits[1]) > ATTACK_IMAGES
            or checks["minimal_epsilon_images_differing"] > ATTACK_IMAGES
            or checks["laplace_scaled_err"] > LAPLACE_REL):
        fail(f"refine: card against CPU on {k} images: {checks}")
    return row


# phases tent and tta: the reference's per-protocol TENT lrs
# (TENT_Pipelines.py:353-366), its batch, the sweep's cells (gaussian_noise
# and contrast from the canonical 15, rotation on kernel #12), the CPU
# check's ragged batches of the first 64 images, and the AugMix draws of the
# card runs: every op of the 8 in some chain, both rotations among them
TENT_LR = {"continuous": 2.5e-4, "reset": 1e-3, "conditional": 1e-3}
TENT_BATCH, TENT_STEPS_TIMED, TENT_CPU_SIZES, TENT_CPU_STEPS = 256, 20, (24, 24, 16), 3
TENT_CORRUPTIONS, TENT_SEVERITIES = ("gaussian_noise", "contrast", "rotation"), (1, 3)
GATED_CHAIN = (("blur", {"radius": 1.5}), ("rotation", {"angle": 15.0}), ("grayscale", {}))
AUGMIX_DRAWS = {"ws": [0.5, 0.3, 0.2], "m": 0.6, "depth_draw": [3, 3, 2],
                "op_draw": [[0, 2, 4], [1, 5, 3], [6, 7, 0]]}
TTA_FIT_IMAGES = 5000
# card against CPU: a TENT step's logits, max |d| over the largest |logit|;
# the BatchNorm parameters after 3 steps, max |d| in units of lr x steps:
# Adam moves an element by ~lr a step whatever its gradient's size, so a
# gradient near 0 whose sign differs between the devices (f32 sums in
# another order) puts that element up to 2 lr a step apart (the first
# card run: 6.6e-4 of the largest parameter after 3 steps at lr 1e-3). TTA
# probabilities max |d|; the MATTA / VATTA and ensemble-temperature weights
# max |d|
TENT_LOGITS_REL, TENT_ADAM_BOUND, TTA_PROB_ABS, TTA_WEIGHT_ABS = 1e-4, 2.0, 1e-4, 1e-4


def params_and_buffers(model) -> dict:
    return {k: v.detach().clone() for k, v in [*model.named_parameters(),
                                               *model.named_buffers()]}


def unchanged(torch, model, before: dict) -> bool:
    """Every parameter and buffer of ``model`` bit-equal to ``before``'s."""
    now = params_and_buffers(model)
    return sorted(now) == sorted(before) and all(torch.equal(now[k], v)
                                                 for k, v in before.items())


def tent_phase(torch, mk, xtr, ytr, xte, yte) -> dict:
    """TENT on the card with the demo ResNet-20 (``utils.demo.get_model``,
    trained on the card on 512 of the synthetic train images) over 10 000
    synthetic test images in batches of 256 (39 and a ragged tail of 16):
    one adaptation step's ms (CUDA events over 20 chained steps; its
    kernels' device time and count by torch.profiler) against
    the bound of its forward plus its backward to the BatchNorm parameters
    (2 forwards' multiply-adds over the f32 FMA rate: the convolutions'
    weights are frozen, so the backward takes input gradients only);
    ``evaluate_with_tent`` under the three protocols at the reference's lrs
    (s and accuracy; the batches the conditional gate adapted);
    ``workflows.tent_sweep`` over gaussian_noise, contrast and rotation at
    severities 1 and 3 with the 4 protocols and the eval-mode baseline (s a
    cell); ``apply_if_entropy`` and ``conditional_transform_eval`` with the
    main-path chain blur 1.5 -> rotation 15 -> grayscale at 10000x32x32
    (kernel #2) and 32x512x512, half of them flat (kernel #1); peak memory;
    the kernels' launches (#1, #2 and, from the rotation cells, #12 must
    run). Then card against CPU on the first 64 images (batches of 24, 24,
    16; the CPU a copy of the model): each protocol's accuracy and each
    sweep cell's (numpy draws) within 1/64, a step's logits within 1e-4 of
    the largest, the BatchNorm parameters after 3 steps within 2 lr x 3
    (Adam's bound where a gradient near 0 differs in sign; the flips are
    counted), the gated chain 0 LSB, and the module's parameters and
    buffers bit-equal to what they were before the phase. Fails otherwise
    (after printing the row)."""
    import copy

    import numpy as np

    from imagetransformations_tpu_torch import workflows as wf
    from imagetransformations_tpu_torch.adapt import conditional, tent
    from imagetransformations_tpu_torch.evalx.harness import numpy_draws
    from imagetransformations_tpu_torch.pipeline.chain import OpSpec
    from imagetransformations_tpu_torch.utils import demo

    model_fn, space, model = demo.get_model(xtr[:512], ytr[:512], device="cuda", seed=SEED)
    before = params_and_buffers(model)
    x_d, y_d = torch.from_numpy(xte).cuda(), torch.from_numpy(yte).long().cuda()
    xm = space(x_d)
    n, b = len(xte), TENT_BATCH
    starts = range(0, n, b)
    batches = [(xm[i: i + b], x_d[i: i + b]) for i in starts]
    labels = [y_d[i: i + b] for i in starts]
    row = {"phase": "tent", "model": "resnet20 (demo recipe)", "images": n, "batch": b,
           "batches": len(batches), "tail": n % b, "lr": TENT_LR}
    reset_launches(mk)
    torch.cuda.reset_peak_memory_stats()
    state, tx = tent.init_tent(model, TENT_LR["reset"])
    step = tent.make_tent_step(model, tx)
    held = [state]

    def one_step():
        held[0], _ = step(held[0], batches[0][0])

    row["step_ms"] = time_ms(torch, one_step, TENT_STEPS_TIMED)
    row["step_device_ms"] = device_ms(torch, one_step, 5)
    row["step_kernels"] = kernels_per_call(torch, one_step, 5)
    bound = 2 * macs_per_image(torch, model, xm[:1]) * b / F32_FMA_PER_S * 1e3
    row.update(step_bound_ms=bound, step_bound_share=bound / row["step_ms"])

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        row[f"{name}_s"] = time.perf_counter() - t0
        return out

    for proto, lr in TENT_LR.items():
        row[f"{proto}_accuracy"] = timed(proto, lambda: tent.evaluate_with_tent(
            model, batches, labels, lr=lr, protocol=proto, device="cuda"))
    with torch.no_grad():
        row["eval_mode_accuracy"] = float((torch.argmax(model_fn(xm), -1) == y_d).float().mean())
    row["conditional_adapted_batches"] = sum(
        float(conditional.batch_gate_fraction(raw)) > 0.5 for _, raw in batches)
    # one call a corruption (each cell draws from its own generator, so the
    # cells are those of one call), timed apart
    row["sweep"] = {}
    for name in TENT_CORRUPTIONS:
        row["sweep"].update(timed(f"sweep_{name}", lambda: wf.tent_sweep(
            model, (name,), TENT_SEVERITIES, x_d, y_d, space, seed=SEED, lr=TENT_LR,
            batch_size=b, model_apply_eval=model_fn, device="cuda")))
    row["sweep_s"] = sum(row[f"sweep_{name}_s"] for name in TENT_CORRUPTIONS)
    row["sweep_s_per_cell"] = row["sweep_s"] / (len(TENT_CORRUPTIONS) * len(TENT_SEVERITIES))
    # the gated main-path chain
    chain = [OpSpec(name, dict(p)) for name, p in GATED_CHAIN]
    x512 = images(torch, SHAPE_512, SEED + 201)
    x512[: SHAPE_512[0] // 2] = x512[: SHAPE_512[0] // 2, :1, :1]  # flat: below the gate
    y512 = torch.randint(0, 10, (SHAPE_512[0],), generator=torch.Generator().manual_seed(SEED))
    for label, imgs, y in (("32", x_d, y_d), ("512", x512, y512.cuda())):
        gated_ms, (mixed, flagged) = once_ms(torch, lambda: conditional.apply_if_entropy(
            imgs, chain, device="cuda"))
        row[f"apply_if_entropy_{label}_ms"] = gated_ms
        row[f"apply_if_entropy_{label}_flagged"] = int(flagged.sum())
        row[f"conditional_transform_eval_{label}"] = timed(
            f"conditional_transform_eval_{label}", lambda: conditional.conditional_transform_eval(
                model_fn, space, imgs, y, chain, device="cuda"))
    del mixed, flagged
    row["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    launches = {k: v for k in mk.LAUNCHES if (v := row_launches(mk.LAUNCHES, k))}
    row["launches"] = launches
    # the card against the CPU on the first images
    k = UQ_CPU_IMAGES
    cpu_model = copy.deepcopy(model).cpu()
    cpu_before = params_and_buffers(cpu_model)
    t0 = time.perf_counter()
    checks = {}
    sizes = np.cumsum((0,) + TENT_CPU_SIZES)
    for proto, lr in TENT_LR.items():
        accs = []
        for net, dev in ((model, "cuda"), (cpu_model, "cpu")):
            raws, ys = x_d[:k].to(dev), y_d[:k].to(dev)
            xs = space(raws)
            bb = [(xs[i: j], raws[i: j]) for i, j in zip(sizes[:-1], sizes[1:])]
            lb = [ys[i: j] for i, j in zip(sizes[:-1], sizes[1:])]
            accs.append(tent.evaluate_with_tent(net, bb, lb, lr=lr, protocol=proto, device=dev))
        checks[f"{proto}_accuracy_card_cpu"] = accs
    runs = []
    for net, dev in ((model, "cuda"), (cpu_model, "cpu")):
        st, stx = tent.init_tent(net, TENT_LR["reset"])
        stp = tent.make_tent_step(net, stx)
        xs = space(x_d[:k].to(dev))
        first = stp(st, xs)
        st = first[0]
        for _ in range(TENT_CPU_STEPS - 1):
            st, _ = stp(st, xs)
        runs.append((first, st.bn_params))
    (f_card, bn_card), (f_cpu, bn_cpu) = runs
    checks["first_logits_scaled_err"] = scaled_err({"logits": f_card[1]}, {"logits": f_cpu[1]})
    d = torch.cat([(bn_card[n_].cpu() - v).abs().reshape(-1) for n_, v in bn_cpu.items()])
    g_card, g_cpu = f_card[0].opt_state.mu["bn"].cpu(), f_cpu[0].opt_state.mu["bn"]
    flips = torch.sign(g_card) != torch.sign(g_cpu)  # mu = 0.1 g after one step
    checks["bn_params_max_abs"] = float(d.max())
    checks["bn_params_share_above_1e-5"] = float((d > 1e-5).float().mean())
    checks["first_grad_sign_flips"] = int(flips.sum())
    checks["first_grad_max_abs_at_flips"] = (float(10 * g_cpu[flips].abs().max())
                                             if bool(flips.any()) else 0.0)

    def draws(name, sev):
        return numpy_draws(xte[:k], name, sev, np.random.default_rng([SEED, sev]))

    cells = [wf.tent_sweep(net, TENT_CORRUPTIONS, TENT_SEVERITIES, xte[:k], yte[:k], space,
                           lr=TENT_LR, batch_size=TENT_CPU_SIZES[0], model_apply_eval=net,
                           cell_draws=draws, device=dev)
             for net, dev in ((model, "cuda"), (cpu_model, "cpu"))]
    checks["sweep_max_accuracy_d"] = max(
        abs(cells[0][c][s][p] - cells[1][c][s][p])
        for c in TENT_CORRUPTIONS for s in TENT_SEVERITIES for p in cells[0][c][s])
    gated = [conditional.apply_if_entropy(x_d[:k].to(dev), chain, device=dev)[0].cpu()
             for dev in ("cuda", "cpu")]
    checks["gated_chain_max_lsb"] = max_lsb(torch, gated[0], gated[1])
    checks["module_unchanged"] = (unchanged(torch, model, before)
                                  and unchanged(torch, cpu_model, cpu_before))
    checks["cpu_s"] = time.perf_counter() - t0
    row["vs_cpu"] = {"images": k, **checks}
    emit(row)
    missing = [kn for kn in ("luma_blur_rotate", "luma_blur_rotate_packed", "pil_rotate_nearest")
               if not launches.get(kn)]
    acc_d = max(abs(a - c) for a, c in (checks[f"{p}_accuracy_card_cpu"] for p in TENT_LR))
    if (missing or acc_d > 1 / k + 1e-12 or checks["sweep_max_accuracy_d"] > 1 / k + 1e-12
            or checks["first_logits_scaled_err"] > TENT_LOGITS_REL
            or checks["bn_params_max_abs"] > TENT_ADAM_BOUND * TENT_LR["reset"] * TENT_CPU_STEPS
            or checks["gated_chain_max_lsb"] != 0 or not checks["module_unchanged"]):
        fail(f"tent: kernels not launched {missing}, or card against CPU on {k} images: {checks}")
    return launches


def calibration_row(torch, probs, y) -> dict:
    from imagetransformations_tpu_torch.uq import calibration as cal

    p = torch.as_tensor(probs).to(y.device).float()
    return {"ece": float(cal.ece(p, y)), "nll": float(cal.nll(p, y)),
            "brier": float(cal.brier(p, y)), "accuracy": float(cal.accuracy(p, y))}


def tta_phase(torch, mk, xtr, ytr, xte, yte) -> dict:
    """Test-time augmentation, MATTA and post-hoc calibration on the card,
    with the demo ResNet-20 over the 10 000 synthetic test images:
    ``predict_with_tta`` with each of the three stacks (ms, accuracy, ECE);
    ``adaptive_view_probs`` (ms) and ``fit_adaptive_weights`` (scipy's SLSQP
    on the host) on the first 5000, the mixture scored on the other 5000;
    ``fit_matta_weights`` (MATTA and VATTA, 200 Adam steps) and
    ``find_optimal_rho`` the same way; every post-hoc calibrator fitted on
    the first 5000 logits and scored on the other 5000 (ECE, NLL, Brier
    before and after; ms of fit and calibrate); ``augmix`` at 10000x32x32
    and 32x512x512 with draws that hold every op, both rotations among them
    (kernel #12 must run), ms a call; peak memory; the kernels' launches.
    Then card against CPU on the first 64 images: AugMix 0 LSB with the
    same draws (both shapes' first images), the three stacks' and the
    adaptive views' probabilities within 1e-4 (the same crop offsets), the
    MATTA / VATTA and ensemble-temperature weights within 1e-4. Fails
    otherwise (after printing the row)."""
    import copy

    import numpy as np

    from imagetransformations_tpu_torch.adapt import augmix, matta, posthoc, tta
    from imagetransformations_tpu_torch.core.precision import full_f32
    from imagetransformations_tpu_torch.ops import warp as wp
    from imagetransformations_tpu_torch.utils import demo

    model_fn, space, model = demo.get_model(xtr[:512], ytr[:512], device="cuda", seed=SEED)
    x_d, y_d = torch.from_numpy(xte).cuda(), torch.from_numpy(yte).long().cuda()

    def fn(u8):
        return model(space(u8))

    h = TTA_FIT_IMAGES
    row = {"phase": "tta", "model": "resnet20 (demo recipe)", "images": len(xte),
           "fit_images": h}
    reset_launches(mk)
    torch.cuda.reset_peak_memory_stats()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    stacks = {"gentle": tta.gentle_stack, "multiscale": tta.multiscale_stack,
              "color": tta.color_stack}
    for name, stack in stacks.items():
        ms, probs = once_ms(torch, lambda: tta.predict_with_tta(fn, x_d, g, stack=stack,
                                                                device="cuda"))
        row[f"tta_{name}"] = {"ms": ms, **calibration_row(torch, probs, y_d)}
    ms, vp = once_ms(torch, lambda: tta.adaptive_view_probs(fn, x_d, g, device="cuda"))
    row["adaptive_view_probs_ms"] = ms
    t0 = time.perf_counter()
    w = tta.fit_adaptive_weights(vp[:, :h], y_d[:h])
    row["fit_adaptive_weights_s"] = time.perf_counter() - t0
    row["adaptive_weights"] = w.tolist()
    with full_f32():
        mixed = torch.einsum("v,vbc->bc", torch.from_numpy(w.astype(np.float32)).cuda(),
                             vp[:, h:])
    row["adaptive"] = {"view0": calibration_row(torch, vp[0, h:], y_d[h:]),
                       "mixture": calibration_row(torch, mixed, y_d[h:])}
    for per_class, label in ((True, "matta"), (False, "vatta")):
        ms, wm = once_ms(torch, lambda: matta.fit_matta_weights(vp[:, :h], y_d[:h],
                                                                 per_class=per_class))
        mix = matta.apply_matta if per_class else matta.apply_vatta
        row[label] = {"fit_ms": ms, **calibration_row(
            torch, mix(vp[:, h:], torch.from_numpy(wm).cuda()), y_d[h:])}
    t0 = time.perf_counter()
    rho = matta.find_optimal_rho(vp[0, :h], vp[1:, :h].mean(0), y_d[:h])
    row["find_optimal_rho"] = {"s": time.perf_counter() - t0, "rho": rho, **calibration_row(
        torch, rho * vp[0, h:] + (1.0 - rho) * vp[1:, h:].mean(0), y_d[h:])}
    del vp, mixed
    with torch.no_grad():
        logits = fn(x_d)
    row["uncalibrated"] = calibration_row(torch, torch.softmax(logits[h:], -1), y_d[h:])
    probs = torch.softmax(logits, -1)
    calibrators = {
        "temperature": (posthoc.TemperatureScaling(), logits),
        "ensemble_temperature": (posthoc.EnsembleTemperatureScaling(), logits),
        "isotonic": (posthoc.IsotonicRegressionCalibration(), probs),
        "accuracy_preserving_isotonic": (posthoc.AccuracyPreservingIsotonicRegression(), probs),
    }
    for name, (cal, inputs) in calibrators.items():
        fit_ms, _ = once_ms(torch, lambda: cal.fit(inputs[:h], y_d[:h]))
        cal_ms, out = once_ms(torch, lambda: cal.calibrate(inputs[h:]))
        row[name] = {"fit_ms": fit_ms, "calibrate_ms": cal_ms, **calibration_row(torch, out,
                                                                                y_d[h:])}
    row["temperature"]["T"] = calibrators["temperature"][0].temperature
    row["ensemble_temperature"]["weights"] = calibrators["ensemble_temperature"][0].weights.tolist()
    boosted = posthoc.TTABoostedCalibration(posthoc.TemperatureScaling(), [wp.flip_vertical])
    fit_ms, _ = once_ms(torch, lambda: boosted.fit(logits[:h], y_d[:h]))
    cal_ms, out = once_ms(torch, lambda: boosted.calibrate_with_model(fn, x_d[h:]))
    row["tta_boosted_temperature"] = {"fit_ms": fit_ms, "calibrate_ms": cal_ms,
                                      **calibration_row(torch, out, y_d[h:])}
    # AugMix on kernel #12
    x512 = images(torch, SHAPE_512, SEED + 202)
    for label, imgs in (("32", x_d), ("512", x512)):
        out = augmix.augmix(imgs, draws=AUGMIX_DRAWS, device="cuda")
        if out.shape != imgs.shape or out.dtype != torch.uint8:
            fail(f"tta: augmix gave {tuple(out.shape)} {out.dtype}")
        row[f"augmix_{label}_ms"] = time_ms(
            torch, lambda: augmix.augmix(imgs, draws=AUGMIX_DRAWS, device="cuda"), 5)
    row["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    launches = {k: v for k in mk.LAUNCHES if (v := row_launches(mk.LAUNCHES, k))}
    row["launches"] = launches
    # the card against the CPU on the first images
    k = UQ_CPU_IMAGES
    cpu_model = copy.deepcopy(model).cpu()

    def cpu_fn(u8):
        return cpu_model(space(u8))

    t0 = time.perf_counter()
    checks = {"augmix_max_lsb": max(
        max_lsb(torch, augmix.augmix(imgs, draws=AUGMIX_DRAWS, device="cuda").cpu(),
                augmix.augmix(imgs.cpu(), draws=AUGMIX_DRAWS, device="cpu"))
        for imgs in (x_d[:k], x512[:2]))}
    offsets = [[1, 3], [4, 0]]
    for name, stack in stacks.items():
        pc = tta.predict_with_tta(fn, x_d[:k], stack=stack, offsets=offsets, device="cuda")
        pp = tta.predict_with_tta(cpu_fn, xte[:k], stack=stack, offsets=offsets, device="cpu")
        checks[f"tta_{name}_max_abs"] = float((pc.cpu() - pp).abs().max())
    vc = tta.adaptive_view_probs(fn, x_d[:k], offsets=offsets[:1], device="cuda")
    vq = tta.adaptive_view_probs(cpu_fn, xte[:k], offsets=offsets[:1], device="cpu")
    checks["adaptive_view_probs_max_abs"] = float((vc.cpu() - vq).abs().max())
    yk = y_d[:k]
    for per_class, label in ((True, "matta"), (False, "vatta")):
        checks[f"{label}_weights_max_abs"] = float(np.abs(
            matta.fit_matta_weights(vc, yk, per_class=per_class)
            - matta.fit_matta_weights(vc.cpu(), yk.cpu(), per_class=per_class)).max())
    ets = [posthoc.EnsembleTemperatureScaling().fit(lg, yk.to(lg.device)).weights
           for lg in (logits[:k], logits[:k].cpu())]
    checks["ensemble_temperature_weights_max_abs"] = float(np.abs(ets[0] - ets[1]).max())
    checks["cpu_s"] = time.perf_counter() - t0
    row["vs_cpu"] = {"images": k, **checks}
    emit(row)
    probs_d = max(v for c, v in checks.items() if c.endswith("_max_abs") and "weights" not in c)
    weights_d = max(v for c, v in checks.items() if c.endswith("weights_max_abs"))
    if (not launches.get("pil_rotate_nearest") or checks["augmix_max_lsb"] != 0
            or probs_d > TTA_PROB_ABS or weights_d > TTA_WEIGHT_ABS):
        fail(f"tta: #12 launches {launches.get('pil_rotate_nearest')}, or card against CPU on "
             f"{k} images: {checks}")
    return launches


# phases patches, evolution and sharding: the reference's angelic-patch
# settings (angellic.py: 20x20, sign-SGD lr 0.01; the per-image patch 8x8,
# Adam 0.1, 20 iterations), the images each call takes, the card-against-CPU
# cases, and the sharded runs' mesh and angles. Budgets, card against CPU:
# sign-SGD moves a value by lr a step, and a gradient near 0 can take the
# other sign, so the universal patch may differ on a few values (each
# within 2 lr a step); Adam moves a value ~lr a step whatever its
# gradient's size, so where the gradient of a confident image's entropy is
# ~0 the two devices' steps part by up to 2 lr: the restorative patches are
# held by the share of values beyond 1e-4 (6.1% on the H100, first run),
# by 2 lr a step, and by the patched images' mean entropy (1e-3
# relative); the warps and the fitness chains compute the same f32
# ops on both devices (expected 0); a fitness within 1e-3 relative (the
# MSP threshold can flip an image whose MSP sits at 0.8).
PATCH_BATCHES, PATCH_BATCH, PATCH_HW, PATCH_LR = 40, 256, (20, 20), 0.01
RESTORE_IMAGES, RESTORE_ITERS, RESTORE_LR = 1000, 20, 0.1
PATCH_CPU_IMAGES, PATCH_CPU_STEPS, RESTORE_CPU_ITERS = 64, 3, 5
PATCH_SIGN_SHARE, RESTORE_SHARE, RESTORE_ABS, MASK_SHARE, WARP_ABS = 0.02, 0.1, 1e-4, 0.995, 1e-5
RESTORE_ENTROPY_REL = 1e-3
FITNESS_REL = 1e-3
MESH_SLOTS, MESH_ANGLE = 4, 12.5
SHARD_EVAL_REL_ACC, SHARD_AUROC_ABS = 2e-4, 1e-4
MESH_SWEEP_CELLS = (("gaussian_noise", 3), ("contrast", 3), ("rotation", 3))


def demo_model(torch, xtr, ytr):
    """The demo ResNet-20 (``utils.demo.get_model``, trained on the card on
    512 of the synthetic train images) in eval mode: (model, space)."""
    from imagetransformations_tpu_torch.utils import demo

    _, space, model = demo.get_model(xtr[:512], ytr[:512], device="cuda", seed=SEED)
    model.eval()
    return model, space


def nhwc_model(model):
    """The patches' model_fn: an NHWC f32 batch in [0, 1] -> logits."""
    from imagetransformations_tpu_torch.models.resnet import normalize_cifar

    return lambda x01: model(normalize_cifar(x01).permute(0, 3, 1, 2))


def accuracy_entropy(torch, fn, x01, y) -> tuple:
    """(accuracy, mean entropy in nats) of ``fn`` on ``x01`` in batches of 1000."""
    from imagetransformations_tpu_torch.core.precision import full_f32

    logits = []
    with torch.no_grad(), full_f32():
        for i in range(0, len(x01), 1000):
            logits.append(fn(x01[i: i + 1000]))
    lg = torch.cat(logits)
    logp = torch.log_softmax(lg, -1)
    ent = float(-(logp.exp() * logp).sum(-1).mean())
    return float((lg.argmax(-1) == y).float().mean()), ent


def patches_phase(torch, mk, model, space, xtr, ytr, xte, yte) -> dict:
    """``adapt.patches`` on the card with the demo ResNet-20 on synthetic
    images (no pretrained weights in the repository): ``train_universal_patch``
    (20x20, sign-SGD lr 0.01, 40 batches of 256 training images under
    Gaussian noise 0.1 drawn on the card), with the accuracy and mean
    entropy of the 10 000 noisy test images with the 0.5-gray patch and with
    the trained one; ``restorative_patches_per_image`` on 1000 test images
    (8x8, 20 Adam steps of 0.1), entropy and accuracy before and after;
    ``adet_operator`` on the 10 000 test images (ms; the share of pixels the
    patch covers); ms of each (CUDA events), peak device memory. Then card
    against CPU on 64 images with the same numpy draws (the CPU a copy of
    the model): ``adet_operator`` and ``apply_transformed_patch`` (the mask
    equal on >= 99.5% of pixels, values within 1e-5 elsewhere; expected 0),
    3 sign-SGD steps (<= 2% of the patch's values differ, each within 2 lr a
    step), 5 Adam steps of the restorative patches (<= 10% of values beyond
    1e-4, each within 2 lr a step, the patched images' mean entropy within
    1e-3 relative). No kernel of csrc/ runs here (JAX runs patches in XLA; the warps
    are the plain ``affine_warp``). Fails otherwise (after printing the
    row)."""
    import copy

    import numpy as np

    from imagetransformations_tpu_torch.adapt import patches as pa
    from imagetransformations_tpu_torch.models.resnet import to_unit

    fn = nhwc_model(model)
    g = torch.Generator(device="cuda").manual_seed(SEED)

    def noisy(x, gen):
        return torch.clamp(x + 0.1 * torch.randn(x.shape, generator=gen, device=x.device), 0.0,
                           1.0)

    xtr01, xte01 = to_unit(torch.from_numpy(xtr).cuda()), to_unit(torch.from_numpy(xte).cuda())
    ytr_d, yte_d = torch.from_numpy(ytr).cuda().long(), torch.from_numpy(yte).cuda().long()
    batches = [xtr01[i * PATCH_BATCH: (i + 1) * PATCH_BATCH] for i in range(PATCH_BATCHES)]
    labels = [ytr_d[i * PATCH_BATCH: (i + 1) * PATCH_BATCH] for i in range(PATCH_BATCHES)]
    row = {"phase": "patches", "model": "resnet20 (demo recipe)"}
    reset_launches(mk)
    torch.cuda.reset_peak_memory_stats()
    ms, patch = once_ms(torch, lambda: pa.train_universal_patch(
        fn, batches, labels, patch_hw=PATCH_HW, lr=PATCH_LR, corruption_fn=noisy, generator=g,
        device="cuda"))
    test_noisy = noisy(xte01, torch.Generator(device="cuda").manual_seed(SEED + 1))
    gray = torch.full_like(patch, 0.5)
    row["universal"] = {
        "batches": PATCH_BATCHES, "batch": PATCH_BATCH, "patch_hw": list(PATCH_HW), "ms": ms,
        "ms_a_step": ms / PATCH_BATCHES,
        "values_moved": float((patch != 0.5).float().mean()),
        "noisy_test_gray_patch": accuracy_entropy(torch, fn, pa.apply_patch(test_noisy, gray), yte_d),
        "noisy_test_trained_patch": accuracy_entropy(torch, fn, pa.apply_patch(test_noisy, patch),
                                                     yte_d)}
    xr, yr = xte01[:RESTORE_IMAGES], yte_d[:RESTORE_IMAGES]
    ms, (patched, _) = once_ms(torch, lambda: pa.restorative_patches_per_image(
        fn, xr, iters=RESTORE_ITERS, lr=RESTORE_LR, device="cuda"))
    row["restorative"] = {"images": RESTORE_IMAGES, "iters": RESTORE_ITERS, "ms": ms,
                          "ms_an_iteration": ms / RESTORE_ITERS,
                          "before": accuracy_entropy(torch, fn, xr, yr),
                          "after": accuracy_entropy(torch, fn, patched, yr)}
    adet = lambda: pa.adet_operator(xte01, patch, torch.Generator(device="cuda").manual_seed(3))  # noqa: E731
    out = adet()
    if tuple(out.shape) != tuple(xte01.shape) or not bool(((out >= 0) & (out <= 1)).all()):
        fail(f"patches: adet_operator gave {tuple(out.shape)} outside [0, 1]")
    # the share of pixels the patch covers: the operator without its
    # corruption pool on images of -1, below any patch value
    placed = pa.adet_operator(-torch.ones_like(xte01), patch,
                              torch.Generator(device="cuda").manual_seed(3), corruption_fns=None)
    row["adet"] = {"images": len(xte01), "ms": time_ms(torch, adet, 5),
                   "covered_share": float((placed >= 0).any(-1).float().mean())}
    row["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    row["launches"] = {k: v for k in mk.LAUNCHES if (v := row_launches(mk.LAUNCHES, k))}
    # card against CPU on 64 images, the same numpy draws
    k, h, w = PATCH_CPU_IMAGES, 32, 32
    rng = np.random.default_rng([SEED, 17])
    cpu_fn = nhwc_model(copy.deepcopy(model).cpu())
    x64 = xte01[:k].cpu()
    draws = {"corruption_idx": rng.integers(0, 2, k), "scale": rng.uniform(0.8, 1.2, k),
             "angle": rng.uniform(-15, 15, k), "shear": rng.uniform(-0.15, 0.15, k),
             "brightness": rng.uniform(0.8, 1.2, k), "y_u": rng.uniform(0, 1, k),
             "x_u": rng.uniform(0, 1, k),
             "noise": rng.standard_normal((k, h, w, 3)).astype(np.float32)}
    checks = {}
    p_cpu = patch.cpu()
    neg = -torch.ones_like(x64)
    mc = pa.adet_operator(neg.cuda(), patch, corruption_fns=None, **draws).cpu() >= 0
    mq = pa.adet_operator(neg, p_cpu, corruption_fns=None, **draws) >= 0
    same = mc == mq
    checks["adet_mask_equal_share"] = float(same.float().mean())
    d = (pa.adet_operator(x64.cuda(), patch, **draws).cpu()
         - pa.adet_operator(x64, p_cpu, **draws)).abs()
    checks["adet_max_abs"] = float(d[same].max())
    tw = dict(scale=0.93, angle=-11.0, y0=5, x0=9)
    checks["transformed_patch_max_abs"] = float(
        (pa.apply_transformed_patch(x64.cuda(), patch[:8, :8], **tw).cpu()
         - pa.apply_transformed_patch(x64, p_cpu[:8, :8], **tw)).abs().max())
    xs = [xtr01[i * k: (i + 1) * k] for i in range(PATCH_CPU_STEPS)]
    ys = [ytr_d[i * k: (i + 1) * k] for i in range(PATCH_CPU_STEPS)]
    noise = [torch.from_numpy(rng.standard_normal((k, h, w, 3)).astype(np.float32))
             for _ in range(PATCH_CPU_STEPS)]

    def from_list(queue):
        return lambda x, gen: torch.clamp(x + 0.1 * queue.pop(0).to(x.device), 0.0, 1.0)

    uc = pa.train_universal_patch(fn, xs, ys, patch_hw=PATCH_HW, lr=PATCH_LR,
                                  corruption_fn=from_list(list(noise)), device="cuda").cpu()
    uq = pa.train_universal_patch(cpu_fn, [t.cpu() for t in xs], [t.cpu() for t in ys],
                                  patch_hw=PATCH_HW, lr=PATCH_LR,
                                  corruption_fn=from_list(list(noise)), device="cpu")
    du = (uc - uq).abs()
    checks["universal_differing_share"] = float((du > 0).float().mean())
    checks["universal_max_abs"] = float(du.max())
    xc, rc = pa.restorative_patches_per_image(fn, x64.cuda(), iters=RESTORE_CPU_ITERS,
                                              lr=RESTORE_LR, device="cuda")
    xq, rq = pa.restorative_patches_per_image(cpu_fn, x64, iters=RESTORE_CPU_ITERS,
                                              lr=RESTORE_LR, device="cpu")
    dr = (rc.cpu() - rq).abs()
    checks["restorative_share_beyond_1e-4"] = float((dr > RESTORE_ABS).float().mean())
    checks["restorative_max_abs"] = float(dr.max())
    y64 = yte_d[:k]
    ent_c = accuracy_entropy(torch, fn, xc, y64)[1]
    ent_q = accuracy_entropy(torch, cpu_fn, xq, y64.cpu())[1]
    checks["restorative_entropy_card_cpu"] = [ent_c, ent_q]
    checks["restorative_entropy_rel"] = abs(ent_c - ent_q) / abs(ent_q)
    row["vs_cpu"] = {"images": k, **checks}
    emit(row)
    if (checks["adet_mask_equal_share"] < MASK_SHARE or checks["adet_max_abs"] > WARP_ABS
            or checks["transformed_patch_max_abs"] > WARP_ABS
            or checks["universal_differing_share"] > PATCH_SIGN_SHARE
            or checks["universal_max_abs"] > 2 * PATCH_LR * PATCH_CPU_STEPS + 1e-6
            or checks["restorative_share_beyond_1e-4"] > RESTORE_SHARE
            or checks["restorative_max_abs"] > 2 * RESTORE_LR * RESTORE_CPU_ITERS
            or checks["restorative_entropy_rel"] > RESTORE_ENTROPY_REL):
        fail(f"patches: card against CPU on {k} images: {checks}")
    if not row["universal"]["values_moved"] > 0:
        fail("patches: the universal patch did not move")
    return row["launches"]


def evolution_phase(torch, mk, model, space, xte) -> dict:
    """``adapt.evolution.evolutionary_search`` on the card at JAX's defaults
    (population 16, 4 generations, elite 4, seed 0) over the 10 000 test
    images with the demo ResNet-20: wall s (host clock, synchronized), the
    fitness evaluations (the module-level ``fitness_fn`` counted), the best
    genome, the kernels' launches (counters reset just before, read just
    after: #3, ``rgb_blur_rotate`` in stream mode at angle 0, must run for
    the blur genes). Then ``fitness_fn`` card against CPU on 64 images for
    each of the 16 noise-free gene combos (within 1e-3 relative), and the
    gene-by-gene route of blur 1.0 -> sharpness 1.5 on the 10 000 images
    against its plain composition (#3's plain version, then the plain
    sharpen): 0 LSB, one launch of #3. Fails otherwise."""
    import copy

    from imagetransformations_tpu_torch.adapt import evolution as ev
    from imagetransformations_tpu_torch.ops import stencil as st

    x = torch.from_numpy(xte).cuda()
    calls = []
    real = ev.fitness_fn

    def counted(*args, **kwargs):
        calls.append(list(args[3].genome))
        return real(*args, **kwargs)

    ev.fitness_fn = counted
    try:
        reset_launches(mk)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        best = ev.evolutionary_search(model, space, x, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ev.fitness_fn = real
    launches = {k: v for k in mk.LAUNCHES if (v := row_launches(mk.LAUNCHES, k))}
    blur_genes = sum(op == "blur" for genome in calls for op, _ in genome)
    row = {"phase": "evolution", "images": len(x), "population": 16, "generations": 4,
           "elite": 4, "wall_s": wall, "fitness_evaluations": len(calls),
           "s_a_fitness": wall / max(len(calls), 1), "blur_genes_evaluated": blur_genes,
           "best": {"genome": [list(gn) for gn in best.genome], "fitness": best.fitness},
           "launches": launches}
    # fitness, card against CPU
    cpu_model = copy.deepcopy(model).cpu()
    x64 = xte[:64]
    worst = 0.0
    for gene in ev._GENE_COMBOS:
        if "noise" in gene[0]:
            continue
        ind = ev.Individual([gene])
        fc = ev.fitness_fn(model, space, x64, ind, device="cuda")
        fq = ev.fitness_fn(cpu_model, space, x64, ind, device="cpu")
        worst = max(worst, abs(fc - fq) / abs(fq))
    row["fitness_max_rel_vs_cpu"] = worst
    # the gene-by-gene route against its plain composition
    ind = ev.Individual([("blur", 1.0), ("sharpness", 1.5)])
    n, h, w, _ = x.shape
    before = mk.LAUNCHES["rgb_blur_rotate"]
    got = ev.transform_genome(x, ind, device="cuda")
    genes_launches = mk.LAUNCHES["rgb_blur_rotate"] - before
    taps, p, k1, f1, k2, f2 = mk._params(h, w, 1.0, 0.0, x.device)
    want = st.sharpen(mk.rgb_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, 0, False, False, True),
                      1.5)
    row["genes_vs_plain_max_lsb"] = max_lsb(torch, got, want)
    row["genes_rgb_blur_rotate_launches"] = genes_launches
    emit(row)
    if (len(calls) != 80 or not launches.get("rgb_blur_rotate") or worst > FITNESS_REL
            or row["genes_vs_plain_max_lsb"] != 0 or genes_launches != 1
            or not 0.5 <= best.fitness <= 1.0):
        fail(f"evolution: {len(calls)} fitness calls, launches {launches}, fitness card "
             f"against CPU {worst}, gene route {row['genes_vs_plain_max_lsb']} LSB "
             f"({genes_launches} launches of #3), best {best}")
    return launches


def sharding_phase(torch, mk, model, space, xte, yte) -> dict:
    """The one-process mesh on the card: ``data_mesh(4, device="cuda:0")``
    (4 shards on the one H100), and every visible device as well where
    there are more. Per mesh: ``sharded_chain_fn`` at 32x512x512x3 for blur
    1.5 -> rotation 12.5 -> grayscale (#1), the same with per-image angles
    in -22.5..22.5 whose first shard lies within 4.5 degrees (#4, each
    shard with the batch's budget 25), and the RGB forms of both (#3 in
    stream mode, #5), each 0 LSB against the one-device chain and each
    kernel launched once a shard; ``sharded_gaussian_blur`` at r 1.5 (rows
    over the shards, halo rows copied between slots): 0 LSB against
    ``gaussian_blur``, #6 once a shard; ``evaluate_sharded`` against
    ``evaluate_batched`` on the 10 000 test images (logits within the
    models' card budget, 1e-3 of max(1, max |logit|); accuracy within the
    images whose top two logits are that close); ``corruption_sweep(mesh=)``
    on gaussian_noise, contrast and rotation at severity 3 against the
    one-device sweep (accuracy within 2e-4, AUROC within 1e-4: the shards'
    forwards run batches of 2500, the one-device sweep's 256); one ``sweep
    --data-parallel=true --mesh-slots=4`` CLI row (256 images, severity 1).
    ms of each against the one-device run (CUDA events; the shards run the
    same kernels one after another, so no speed-up is expected on one
    card). Returns (the launches of the sharded runs, the first mesh's ms by
    run, named as ``tools/run_process_mesh.py`` names them). Fails
    otherwise."""
    import contextlib
    import io as _io
    import tempfile

    import numpy as np

    from imagetransformations_tpu_torch.__main__ import main as cli_main
    from imagetransformations_tpu_torch.evalx import harness as hs
    from imagetransformations_tpu_torch.ops.sharded_stencil import sharded_gaussian_blur
    from imagetransformations_tpu_torch.ops.stencil import gaussian_blur
    from imagetransformations_tpu_torch.pipeline import sharding as shd
    from imagetransformations_tpu_torch.pipeline.chain import OpSpec, build_chain_fn

    meshes = [shd.data_mesh(MESH_SLOTS, device="cuda:0")]
    if torch.cuda.device_count() > 1:
        meshes.append(shd.data_mesh())
    x = images(torch, SHAPE_512, SEED + 120)
    n = SHAPE_512[0]
    rng = np.random.default_rng([SEED, 19])
    angles = rng.uniform(-22.5, 22.5, n).astype(np.float32)
    angles[: n // MESH_SLOTS] = rng.uniform(-4.5, 4.5, n // MESH_SLOTS)
    angles[-1] = 22.5
    blur = OpSpec("blur", {"radius": BLUR_RADIUS})
    chains = [
        ("luma_blur_rotate", [blur, OpSpec("rotation", {"angle": MESH_ANGLE}), OpSpec("grayscale")]),
        ("luma_blur_rotate_traced", [blur, OpSpec("rotation", {"angle": angles}),
                                     OpSpec("grayscale")]),
        ("rgb_blur_rotate", [blur, OpSpec("rotation", {"angle": MESH_ANGLE})]),
        ("rgb_blur_rotate_traced", [blur, OpSpec("rotation", {"angle": angles})]),
    ]
    total = {}
    rows = []

    def counted(run, kernel, slots):
        reset_launches(mk)
        out = run()
        torch.cuda.synchronize()
        got = {k: v for k in mk.LAUNCHES if (v := row_launches(mk.LAUNCHES, k))}
        if got.get(kernel) != slots:
            fail(f"sharding: {kernel} launched {got.get(kernel)} times for {slots} shards: {got}")
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        return out, got

    for mesh in meshes:
        slots = mesh.size
        row = {"phase": "sharding", "mesh": [str(d) for d in mesh.devices],
               "shape": [*SHAPE_512, 3], "runs": []}
        for kernel, chain in chains:
            sharded = shd.sharded_chain_fn(chain, mesh)
            one = build_chain_fn(chain, device="cuda")
            out, got = counted(lambda: sharded(x).gather(), kernel, slots)
            err = max_lsb(torch, out, one(x))
            row["runs"].append({"run": f"sharded_chain_fn ({kernel})", "launches": got,
                                "max_lsb_vs_one_device": err,
                                "ms": time_ms(torch, lambda: sharded(x), 10),
                                "one_device_ms": time_ms(torch, lambda: one(x), 10)})
            if err != 0:
                fail(f"sharding: sharded_chain_fn ({kernel}) differs by {err} LSB")
        out, got = counted(lambda: sharded_gaussian_blur(x, BLUR_RADIUS, mesh).gather(),
                           "blur_separable", slots)
        err = max_lsb(torch, out, gaussian_blur(x, BLUR_RADIUS))
        row["runs"].append({
            "run": "sharded_gaussian_blur r 1.5", "launches": got, "max_lsb_vs_one_device": err,
            "ms": time_ms(torch, lambda: sharded_gaussian_blur(x, BLUR_RADIUS, mesh), 10),
            "one_device_ms": time_ms(torch, lambda: gaussian_blur(x, BLUR_RADIUS), 10)})
        if err != 0:
            fail(f"sharding: sharded_gaussian_blur differs by {err} LSB")
        # evaluation over the mesh (each shape warmed up first: cuDNN picks
        # its algorithms at a batch size's first call)
        hs.evaluate_sharded(model, space, xte, yte, mesh)
        hs.evaluate_batched(model, space, xte, yte, device="cuda")
        ms_s, res = once_ms(torch, lambda: hs.evaluate_sharded(model, space, xte, yte, mesh))
        ms_1, ref = once_ms(torch, lambda: hs.evaluate_batched(model, space, xte, yte,
                                                               device="cuda"))
        budget = logits_budget(torch, res["logits"], ref["logits"].float().cpu(),
                               "evaluate_sharded against evaluate_batched")
        d_acc = abs(res["accuracy"] - ref["accuracy"])
        if d_acc > budget["argmax_differs_close_top2"] / len(xte) + 1e-12:
            fail(f"sharding: evaluate_sharded accuracy {res['accuracy']} against {ref['accuracy']}")
        row["evaluate"] = {"images": len(xte), "accuracy": res["accuracy"],
                           "one_device_accuracy": ref["accuracy"], "ms": ms_s,
                           "one_device_ms": ms_1, **budget}
        # the sweep's mesh path on three cells
        reset_launches(mk)
        sweep = {}
        for name, sev in MESH_SWEEP_CELLS:
            kw = dict(seed=SEED, corruption_names=(name,), severities=(sev,), device="cuda")
            hs.corruption_sweep(model, space, xte, yte, mesh=mesh, **kw)  # warm-up
            reset_launches(mk)
            ms_s, got_c = once_ms(torch, lambda: hs.corruption_sweep(
                model, space, xte, yte, mesh=mesh, **kw)[name][sev])
            sweep_launches = {k: v for k in mk.LAUNCHES if (v := row_launches(mk.LAUNCHES, k))}
            ms_1, want_c = once_ms(torch, lambda: hs.corruption_sweep(model, space, xte, yte,
                                                                      **kw)[name][sev])
            da = abs(got_c["accuracy"] - want_c["accuracy"])
            du = max(abs(got_c["auroc"][m] - want_c["auroc"][m]) for m in want_c["auroc"])
            sweep[f"{name} {sev}"] = {"accuracy": got_c["accuracy"], "d_accuracy": da,
                                      "max_d_auroc": du, "ms": ms_s, "one_device_ms": ms_1}
            if da > SHARD_EVAL_REL_ACC or du > SHARD_AUROC_ABS:
                fail(f"sharding: sweep cell {name} {sev} on the mesh: |d accuracy| {da}, "
                     f"|d AUROC| {du}")
            for k, v in sweep_launches.items():
                total[k] = total.get(k, 0) + v
            reset_launches(mk)
        row["sweep_cells"] = sweep
        rows.append(row)
    # one CLI row: the sweep over a mesh of 4 slots on the card
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        argv = ["sweep", f"--data-root={tmp}", f"--out-dir={tmp}/out", "--severities=1",
                "--device=cuda", "--data-parallel=true", f"--mesh-slots={MESH_SLOTS}", "--stats"]
        buf = _io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli_main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        text = buf.getvalue().strip().splitlines()
    line = f"data-parallel sweep over {MESH_SLOTS} devices"
    cli_row = {"phase": "sharding", "command": " ".join(argv[:1] + argv[3:]), "wall_s": wall,
               "printed_mesh_line": line in text, "stats": json.loads(text[-1])}
    if not cli_row["printed_mesh_line"] or cli_row["stats"]["cells"] != 15:
        fail(f"sharding: the sweep --data-parallel command printed {text[:3]} ... {text[-1]}")
    for row in rows:
        row["launches"] = dict(total)
        emit(row)
    emit(cli_row)
    first = rows[0]
    ms = {r["run"].split("(")[-1].rstrip(")"): r["ms"] for r in first["runs"][:len(chains)]}
    ms["blur"] = first["runs"][len(chains)]["ms"]
    ms["evaluate"] = first["evaluate"]["ms"]
    ms.update({f"sweep {k}": v["ms"] for k, v in first["sweep_cells"].items()})
    return total, ms


# phase processes: 4 gloo ranks on the one card (the shard count of phase
# sharding), 2 for the CLI row. A TENT step's logits as in phase tent
# (TENT_LOGITS_REL); its BatchNorm parameters within lr/20 a step, as
# tests/test_torch_process_mesh.py holds them against JAX
PROCESS_RANKS, PROCESS_CLI_RANKS, PROCESS_TIMEOUT_S = 4, 2, 300
PROCESS_BMA_PROB, PROCESS_FGSM_SHARE, PROCESS_TRAIN_REL = 1e-4, 1e-3, 1e-5
PROCESS_TENT_BN_LR_SHARE = 1 / 20
# two f32 runs that each stray d from exact arithmetic may lie 2d apart,
# and the largest difference over steps and entries varies by about as much
# again between runs: |ranks - one device| / |one device - f64| measured
# 0.1-2.9 over the card runs of PR 18 (losses, gradients, parameters);
# PERF.md section 5 has the reading of a planted fault against this budget
PROCESS_FLOOR_FACTOR = 4


def torchrun(nproc: int, args: list) -> subprocess.Popen:
    """``python -m torch.distributed.run --standalone --nproc-per-node=nproc
    *args`` from the repository's root, started in a session of its own,
    its output captured (``finish`` waits for it)."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen([sys.executable, "-m", "torch.distributed.run", "--standalone",
                             f"--nproc-per-node={nproc}", *args], cwd=root, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)


def finish(proc: subprocess.Popen, timeout: float) -> tuple[str, str]:
    """(stdout, stderr) of ``proc``; its whole session (torchrun and its
    ranks) killed if it outlives ``timeout``."""
    try:
        return proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()


def processes_phase(torch, mk, model, space, xte, yte, one_process_ms: dict) -> dict:
    """The process mesh: ``tools/run_process_mesh.py`` under ``torchrun``,
    4 gloo ranks on ``cuda:0`` (NCCL refuses two ranks on one GPU), on
    ``make_inputs("full")`` with the demo ResNet-20 and the 10 000 test
    images: the chains at 32x512x512x3 (#1, #3, #4, #5) and the halo blur
    (#6), each launched once on each rank and 0 LSB against one device;
    ``evaluate_sharded`` (logits within 1e-3 of max(1, max |logit|),
    accuracy equal: one device forwards batches of a shard's size) and 3
    mesh sweep cells (accuracy equal, AUROC within 1e-4; #12 in rotation on
    each rank); 4 ``make_train_step`` steps and 2 ``adversarial_train_step``
    steps (SGD with momentum, the first 256 test images):
    the ranks' gradients and parameters equal bit for bit, the first step's
    loss within rtol 1e-5 of one device's, and the first step's averaged
    gradients, the losses and the parameters within 1e-5 (relative; of the
    largest entry) of one device's or within 4 times the distance of the
    one-device f32 steps from the same steps in f64, where that is larger
    (training BatchNorm's gradient cancels in f32, so one device's f32
    parameters lie 6e-7-3e-5 of the largest entry from f64's, PERF.md); a TENT step
    of 256 (its logits within 1e-4 of the largest, the BatchNorm
    parameters within lr/20 a step) and ``evaluate_with_tent`` continuous
    over 4 batches of 256 (accuracy within 1/256); SWAG's BMA of 3 samples
    on 256 (probabilities within 1e-4); FGSM on 256 (<= 0.1% of values
    differ). The one-device run is the same ``run_all`` in this process,
    timed once the CLI row has ended and the 4 ranks wait, ready, for it to
    end. ms of each run (the slowest rank; host clock to a synchronize)
    beside the one-device run's and phase sharding's one-process ms (CUDA
    events). One ``sweep
    --data-parallel=true`` CLI row on 2 ranks: "data-parallel sweep over 2
    devices" printed once. Returns the ranks' launches (summed). Fails
    otherwise, after printing the row."""
    import tempfile

    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools"))
    import run_process_mesh as rpm

    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    inputs = rpm.make_inputs("full", SEED, PROCESS_RANKS, model_state=state, data=(xte, yte))
    row = {"phase": "processes", "ranks": PROCESS_RANKS, "shape": [*SHAPE_512, 3],
           "images": len(xte)}
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ranks_") as tmp:
        torch.save(inputs, os.path.join(tmp, "inputs.pt"))
        gate = os.path.join(tmp, "start")
        # the CLI row's 2 ranks and the 4 ranks start together; the 4 start
        # up while the CLI runs and wait at the gate. With the CLI ended and
        # the 4 ready, this process times the one-device reference on a card
        # that runs nothing else, then opens the gate
        t_cli = t0 = time.perf_counter()
        started = time.time()
        cli = torchrun(PROCESS_CLI_RANKS, ["-m", "imagetransformations_tpu_torch", "sweep",
                                           f"--data-root={tmp}/cli", f"--out-dir={tmp}/cli/out",
                                           "--severities=1", "--device=cuda",
                                           "--data-parallel=true", "--stats"])
        procs = [cli]
        try:
            procs.append(torchrun(PROCESS_RANKS, [
                os.path.join("tools", "run_process_mesh.py"), "--device=cuda",
                f"--inputs={tmp}/inputs.pt", f"--out={tmp}/out", f"--start-file={gate}"]))
            cli_out, cli_err = finish(cli, PROCESS_TIMEOUT_S)
            cli_wall = time.perf_counter() - t_cli
            deadline = time.perf_counter() + PROCESS_TIMEOUT_S
            while not all(os.path.exists(f"{gate}.rank{r}") for r in range(PROCESS_RANKS)):
                if procs[1].poll() is not None or time.perf_counter() > deadline:
                    break  # the ranks' exit code and output tell why, below
                time.sleep(0.05)
            row["one_device_start_s"] = time.perf_counter() - t0
            one = rpm.run_all(inputs, None, "cuda")
            # f32's own floor: the one-device training steps in f64
            exact = rpm.train_runs(inputs, None, "cuda", torch.float64)
            row["one_device_s"] = time.perf_counter() - t0 - row["one_device_start_s"]
            with open(gate, "w"):
                pass
            stdout, stderr = finish(procs[1], PROCESS_TIMEOUT_S)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    os.killpg(proc.pid, signal.SIGKILL)
                    proc.communicate()
        row["ranks_wall_s"] = time.perf_counter() - t0
        if procs[1].returncode != 0:
            print(stdout[-4000:], stderr[-8000:], file=sys.stderr, flush=True)
            fail(f"processes: the ranks exited with {procs[1].returncode}")
        ranks = [torch.load(os.path.join(tmp, "out", f"rank{r}.pt"), weights_only=False)
                 for r in range(PROCESS_RANKS)]
    row["backend"] = sorted({r["backend"] for r in ranks})
    row["rank_stages_s"] = [{**{k: v for k, v in r["stages"].items() if k != "started"},
                             "start_s": r["stages"]["started"] - started,
                             "run_all_marks_s": r["marks"]} for r in ranks]
    row["devices"] = [r["device"] for r in ranks]
    print(f"processes: {PROCESS_RANKS} ranks on {row['devices']}, backend {row['backend']}",
          flush=True)
    got, want = ranks[0]["out"], one["out"]
    errors = []
    row["runs"] = {run: {"ms": max(r["ms"][run] for r in ranks), "one_device_ms": ms,
                         "one_process_mesh_ms": one_process_ms.get(run),
                         "launches": [r["launches"][run] for r in ranks]}
                   for run, ms in one["ms"].items()}

    def counts(rank, run) -> dict:
        full = dict.fromkeys(mk.LAUNCHES, 0)
        full.update(rank["launches"][run])
        return full

    raw = dict.fromkeys(mk.LAUNCHES, 0)
    for r in ranks:
        for run in r["launches"]:
            for k, v in counts(r, run).items():
                raw[k] += v
    total = {k: v for k in raw if (v := row_launches(raw, k))}
    row["launches"] = total
    for kernel in [*rpm.CHAINS, "blur"]:
        name = "blur_separable" if kernel == "blur" else kernel
        launched = [row_launches(counts(r, kernel), name) for r in ranks]
        shards = torch.cat([r["out"][kernel] for r in ranks],
                           dim=1 if kernel == "blur" else 0)
        err = max_lsb(torch, shards, want[kernel])
        row["runs"][kernel]["max_lsb_vs_one_device"] = err
        if err != 0 or launched != [1] * PROCESS_RANKS:
            errors.append(f"{kernel}: {err} LSB, launched {launched} on the ranks")
    rot = [counts(r, "sweep rotation 3")["pil_rotate_nearest"] for r in ranks]
    if min(rot) < 1:
        errors.append(f"the rotation cell launched #12 {rot} times on the ranks")
    lg, lg1 = got["evaluate"]["logits"], want["evaluate"]["logits"].float()
    row["evaluate"] = {"accuracy": got["evaluate"]["accuracy"],
                       "one_device_accuracy": want["evaluate"]["accuracy"],
                       "max_abs": float((lg - lg1).abs().max()),
                       "budget": 1e-3 * max(1.0, float(lg1.abs().max()))}
    if (row["evaluate"]["max_abs"] > row["evaluate"]["budget"]
            or got["evaluate"]["accuracy"] != want["evaluate"]["accuracy"]):
        errors.append(f"evaluate_sharded: {row['evaluate']}")
    for name, sev in rpm.SWEEP_CELLS:
        k = f"sweep {name} {sev}"
        da = abs(got[k]["accuracy"] - want[k]["accuracy"])
        du = max(abs(got[k]["auroc"][m] - want[k]["auroc"][m]) for m in want[k]["auroc"])
        row["runs"][k].update(d_accuracy=da, max_d_auroc=du)
        if da != 0 or du > SHARD_AUROC_ABS:
            errors.append(f"{k}: |d accuracy| {da}, |d AUROC| {du}")
    # the first step's loss (the forward with the global BatchNorm
    # statistics) within PROCESS_TRAIN_REL; the first step's averaged
    # gradients, and later the losses and parameters: the one-device f32
    # steps part from the f64 ones by their rounding (training BatchNorm's
    # gradient cancels in f32), and the ranks may part from one device by
    # PROCESS_FLOOR_FACTOR times that, or by PROCESS_TRAIN_REL where larger

    def losses_of(res, run):
        return [float(v[0]) if run == "train" else float(v)
                for v in res[run]["loss_acc" if run == "train" else "loss"]]

    def params_apart(a, b) -> float:
        """max |a - b| over every parameter, over the largest |entry| of b."""
        return (max(float((a[k].double() - v).abs().max()) for k, v in b.items())
                / max(float(v.abs().max()) for v in b.values()))

    def within_floor(d, floor) -> bool:
        return d <= max(PROCESS_TRAIN_REL, PROCESS_FLOOR_FACTOR * floor)

    grad = params_apart(got["train"]["grads"], want["train"]["grads"])
    grad_floor = params_apart(want["train"]["grads"], exact["train"]["grads"])
    grads_same = all(torch.equal(r["out"]["train"]["grads"][k], v) for r in ranks[1:]
                     for k, v in got["train"]["grads"].items())
    row["runs"]["train"].update(first_grads_rel=grad, first_grads_rel_f32_vs_f64=grad_floor,
                                first_grads_ranks_bit_equal=grads_same)
    if not within_floor(grad, grad_floor) or not grads_same:
        errors.append(f"train: the first step's averaged gradients {grad} of the largest entry "
                      f"from one device's (f32 against f64 {grad_floor}), ranks equal "
                      f"{grads_same}")
    for run in ("train", "adv_train"):
        losses, losses1, losses64 = (losses_of(r, run) for r in (got, want, exact))
        loss_d = max(abs(a - b) / abs(b) for a, b in zip(losses, losses1))
        loss_floor = max(abs(a - b) / abs(b) for a, b in zip(losses1, losses64))
        par = params_apart(got[run]["params"], want[run]["params"])
        par_floor = params_apart(want[run]["params"], exact[run]["params"])
        same = all(torch.equal(r["out"][run]["params"][k], v) for r in ranks[1:]
                   for k, v in got[run]["params"].items())
        first = abs(losses[0] - losses1[0]) / abs(losses1[0])
        row["runs"][run].update(
            losses=losses, losses_one_device=losses1, first_loss_rel=first, loss_rel=loss_d,
            loss_rel_f32_vs_f64=loss_floor, params_rel=par,
            params_rel_f32_vs_f64=par_floor, ranks_bit_equal=same)
        if (first > PROCESS_TRAIN_REL or not within_floor(loss_d, loss_floor)
                or not within_floor(par, par_floor) or not same):
            errors.append(f"{run}: loss rel {loss_d} (f32 against f64 {loss_floor}), params "
                          f"{par} of the largest entry (f32 against f64 {par_floor}), ranks "
                          f"equal {same}")
    # TENT: each step's logits (the forward with the global statistics,
    # before the update) and the BatchNorm parameters after the steps
    tg, tw = got["tent_steps"], want["tent_steps"]
    steps = len(tw["bn"])
    logit_d = max(float((a - b).abs().max()) / float(b.abs().max())
                  for a, b in zip(tg["logits"], tw["logits"]))
    bn = max(float((tg["bn"][-1][k] - v).abs().max()) for k, v in tw["bn"][-1].items())
    bn_budget = PROCESS_TENT_BN_LR_SHARE * rpm.TENT_LR * steps
    dacc = abs(got["tent_accuracy"] - want["tent_accuracy"])
    row["runs"]["tent_steps"].update(logits_rel=logit_d, bn_max_abs=bn, bn_budget=bn_budget)
    row["runs"]["tent_accuracy"].update(accuracy=got["tent_accuracy"], d_accuracy=dacc)
    if (len(tg["logits"]) != steps or logit_d > TENT_LOGITS_REL or bn > bn_budget
            or dacc > 1 / 256 + 1e-12):
        errors.append(f"TENT: logits {logit_d} of the largest apart, BatchNorm parameters {bn} "
                      f"apart, accuracy {dacc}")
    dp = float((torch.softmax(got["bma"], -1) - torch.softmax(want["bma"], -1)).abs().max())
    share = float((got["fgsm"] != want["fgsm"]).float().mean())
    row["runs"]["bma"].update(max_d_prob=dp)
    row["runs"]["fgsm"].update(differing_share=share)
    if dp > PROCESS_BMA_PROB or share > PROCESS_FGSM_SHARE:
        errors.append(f"BMA probabilities {dp} apart, FGSM {share} of values differ")
    text = cli_out.strip().splitlines()
    line = f"data-parallel sweep over {PROCESS_CLI_RANKS} devices"
    row["cli"] = {"command": f"torchrun x{PROCESS_CLI_RANKS} sweep --data-parallel=true "
                             "--severities=1", "wall_s": cli_wall, "rc": cli.returncode,
                  "mesh_lines": sum(t == line for t in text)}
    if cli.returncode == 0:
        row["cli"]["stats"] = json.loads(text[-1])
    if (cli.returncode != 0 or row["cli"]["mesh_lines"] != 1
            or row["cli"]["stats"]["cells"] != 15):
        print(cli_out[-3000:], cli_err[-6000:], file=sys.stderr, flush=True)
        errors.append(f"the sweep CLI on {PROCESS_CLI_RANKS} ranks: {row['cli']}")
    row["phase_s"] = time.perf_counter() - t_phase
    row["nvidia_smi"] = nvidia_smi()
    emit(row)
    if errors:
        fail("processes: " + "; ".join(errors))
    return total


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

    # ---- the trig on the card equals the CPU's; the folder commands -------
    trig_phase(torch)
    folder_launches = {}
    for row in folder_phase(torch, mk):
        for k, v in row["launches"].items():
            folder_launches[k] = folder_launches.get(k, 0) + v

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
            row["route"] = luma_route(mk, h, w, p)
            row["geometry"] = list(mk._resident_geometry(h, w, p) or g)
            row["other_geometry"] = list(other)
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
            row["route"] = luma_route(mk, h, w, p)
            row["geometry"] = list(mk._resident_geometry(h, w, p) or g)
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

    # each entry point's output (routing checked by its counter)
    def routed(kernel, entry):
        before = mk.LAUNCHES[kernel]
        out = entry()
        if mk.LAUNCHES[kernel] != before + 1:
            fail(f"{kernel}: the entry point did not route to it: {mk.LAUNCHES}")
        return out

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
            row = {"phase": "parity", "kernel": "shear_bicubic", "shape": [*shape, 3],
                   "factors": factors, "max_lsb": err}
            if factors is SHEAR_GRID:
                # the sweep's route: int32 canvas shifts from the grid's f64 table
                idx = torch.round(f * 10.0).to(torch.int64)
                row["max_lsb_table_shifts"] = max_lsb(
                    torch, routed("shear_bicubic", lambda: batch._shear_pil(x, idx, f)),
                    rs.shear_bicubic_plain(x, f, sweep_shear_shifts(torch, batch, f, shape[1])))
            emit(row)
            err = max(v for k, v in row.items() if k.startswith("max_lsb"))
            if err != 0:
                fail(f"parity shear_bicubic {shape} {factors} differs by {err} LSB")
            errs["shear_bicubic"] = max(errs["shear_bicubic"], err)
        del x, out

    # row shift, zoom and NEAREST rotation: the parameters are computed once
    # on the card and fed to the kernel and to its plain version; each entry
    # point's output (routing checked by its counter) must equal the kernel's.
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
        # the sweep's route: integer rows gathered from the grid table by index
        idx = torch.round(radii * 2.0).to(torch.int64)
        parity_row("blur_separable_batched", row,
                   routed("blur_separable_batched", lambda: batch._blur_grid(xb, idx, radii)),
                   want)
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
    # launches of each kernel over the folder commands, phase corrupt and the runs below
    launches = {k: folder_launches.get(k, 0) for k in mk.LAUNCHES}
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
            b_ms, b_by = bound_blur(x, taps)
            # the yardstick: one grouped conv2d of the KxK outer-product taps
            # (as f32, over 2^16) on the reflect-padded f32 NCHW batch,
            # padded outside the timing
            p = k // 2
            xf = torch.nn.functional.pad(x.permute(0, 3, 1, 2).to(torch.float32), (p, p, p, p),
                                         mode="reflect").contiguous()
            tf = taps.to(torch.float32) / 256.0
            weight = torch.outer(tf, tf).expand(3, 1, k, k).contiguous()
            lib = lambda: torch.nn.functional.conv2d(xf, weight, groups=3)
            library_ms, library_note = time_ms(torch, lib, 20), BLUR_LIBRARY_NOTE
            mode = f"r {BLUR_RADIUS} ({k} taps)"
        elif kernel == "blur_separable_batched":
            # the default sweep's blur at 32x512x512: the radii it drew
            shape = SHAPE_512
            n, h, w = shape
            x = images(torch, shape, SEED + 100)
            radii = drawn_radii
            # the sweep's route: each image's int32 row gathered from the
            # grid table by its grid index (0.5 steps)
            idx = torch.round(radii * 2.0).to(torch.int64)
            taps = batch._blur_table(batch._grid_f64("blur"), x.device)[idx].contiguous()
            # the kernel on tap rows made outside the timing; the entry
            # point with the gather is timed apart
            run = lambda: bl._launch(x, taps, taps.shape[1], "blur_separable_batched")
            plain = lambda: st.blur_batched_plain(x, radii)
            b_ms, b_by = bound_blur_batched(torch, x, taps)
            extra = {"entry_ms": time_ms(torch, lambda: batch._blur_grid(x, idx, radii), 20)}
            if not torch.equal(run(), plain()):
                fail("blur_separable_batched differs from its plain version on the drawn radii")
            p = (taps.shape[1] - 1) // 2
            xf = torch.nn.functional.pad(x.permute(0, 3, 1, 2).to(torch.float32), (p, p, p, p),
                                         mode="reflect").reshape(1, 3 * n, h + 2 * p, w + 2 * p)
            xf = xf.contiguous()
            tf = taps.to(torch.float32) / 256.0
            weight = (tf[:, :, None] * tf[:, None, :]).repeat_interleave(3, 0)[:, None]
            weight = weight.contiguous()
            lib = lambda: torch.nn.functional.conv2d(xf, weight, groups=3 * n)
            library_ms, library_note = time_ms(torch, lib, 5), BLUR_BATCHED_LIBRARY_NOTE
            first = (taps != 0).int().argmax(1)
            ks = sorted(set((taps.shape[1] - 2 * first).tolist()))
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
            m = sweep_shear_shifts(torch, batch, f, shape[1])  # outside the timing
            run = lambda: rs.shear_bicubic(x, f, m)
            plain = lambda: rs.shear_bicubic_plain(x, f, m)
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
                extra = {"luma_route": luma_route(mk, h, w, p)}
                if kernel == "luma_blur_rotate":
                    extra["modes"] = luma_modes(torch, mk, run_launches_by_label)
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

    # ---- the corruption generators: phase corrupt and the folder command --
    # after the kernels' device_ms: a profiled corrupt folder run (tens of
    # thousands of small launches) left torch.profiler recording about half
    # the device time of later sessions in one process. Their launches join
    # the kernels line's counts.
    for k, v in corrupt_phase(torch, mk).items():
        for e in entries:
            if e["name"] == k:
                e["launches"] += v
    emit(folder_corrupt_run(torch, mk))

    # ---- the classifiers, and the evaluation sweep with its CLI ------------
    # the models and the sweep under a user's flags, TF32 on by the caller:
    # full_f32 has to hold inside every forward and backward of the port
    with caller_tf32(torch, True):
        models_phase(torch)
        backward_tf32_row(torch)
        for k, v in sweep_phase(torch, mk).items():
            for e in entries:
                if e["name"] == k:
                    e["launches"] += v
        sweep_cli_rows(torch, mk)
        # the posteriors, the attacks and the refinement (no kernel of
        # csrc/ runs in them: they launch nothing the kernels line counts)
        from imagetransformations_tpu_torch.pipeline.datasets import synthetic

        xtr, ytr = synthetic(UQ_TRAIN_IMAGES, seed=SEED)
        xte, yte = synthetic(UQ_TEST_IMAGES, seed=SEED + 1)
        swag_phase(torch, mk, xtr, ytr, xte)
        refine_phase(torch, mk, xtr, ytr, xte, yte)
        # TENT with its entropy gate, TTA, MATTA, calibration and AugMix: the
        # gated chain runs #1 / #2, AugMix and the sweep's rotation cells #12
        for phase in (tent_phase, tta_phase):
            for k, v in phase(torch, mk, xtr, ytr, xte, yte).items():
                for e in entries:
                    if e["name"] == k:
                        e["launches"] += v
        # angelic patches, the evolutionary search (#3 through the blur
        # genes) and the one-process mesh (#1, #3-#6, #12 on 4 shards)
        model, space = demo_model(torch, xtr, ytr)
        launches = [patches_phase(torch, mk, model, space, xtr, ytr, xte, yte),
                    evolution_phase(torch, mk, model, space, xte)]
        shard_launches, shard_ms = sharding_phase(torch, mk, model, space, xte, yte)
        launches += [shard_launches,
                     processes_phase(torch, mk, model, space, xte, yte, shard_ms)]
        for launched in launches:
            for k, v in launched.items():
                for e in entries:
                    if e["name"] == k:
                        e["launches"] += v

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
