"""The port's BICUBIC shear and LANCZOS scale against the JAX package.

``shear_bicubic_batched`` (kernel #11's plain version on the CPU) is held
against the JAX Pallas kernel in interpret mode and against the exact op
``apply_shear(...)[:, :, :w]``, as tests/test_pallas_kernels.py holds the
JAX kernel; ``apply_scale_batched`` against the numpy PIL oracle
``oracle/warp.apply_scale`` per image. Budget: 0 LSB for both (the shear
repeats affine_warp's f32 op order with every op rounded, and takes its
canvas shift in f64 as apply_shear does, where the JAX kernel takes it in
f32: one pixel apart at some (s, h); the scale is integer arithmetic, exact
in f64).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagetransformations_tpu.core.grids import PARAM_GRIDS as JGRIDS
from imagetransformations_tpu.oracle import warp as oww
from imagetransformations_tpu.ops import warp as jwp
from imagetransformations_tpu.ops.pallas import resample as jrs

from imagetransformations_tpu_torch.ops import warp as twp
from imagetransformations_tpu_torch.ops.hopper import megakernel as mk
from imagetransformations_tpu_torch.ops.hopper import resample as rs

SHEAR_GRID = [float(v) for v in JGRIDS["shear"].values()]
SCALE_GRID = tuple(float(v) for v in JGRIDS["scale"].values())


@pytest.mark.parametrize(
    "shape,factors",
    [
        ((3, 48, 40, 3), [0.0, 0.4, 1.0]),
        ((4, 32, 32, 3), [0.1, 0.7, 0.9, 0.3]),
        ((2, 56, 40, 1), [0.5, 0.2]),
        ((11, 24, 20, 3), SHEAR_GRID),
    ],
)
def test_shear_bicubic_matches_jax_kernel_and_apply_shear(rng, shape, factors):
    imgs = rng.integers(0, 256, shape, dtype=np.uint8)
    f = np.asarray(factors, np.float32)
    out = rs.shear_bicubic_batched(torch.from_numpy(imgs), f).numpy()
    assert out.shape == imgs.shape and out.dtype == np.uint8
    want = np.asarray(jrs.shear_bicubic_batched(jnp.asarray(imgs), jnp.asarray(f)))
    assert np.array_equal(out, want)
    w = shape[2]
    ref = np.concatenate([np.asarray(jwp.apply_shear(imgs[i : i + 1], float(v)))[:, :, :w]
                          for i, v in enumerate(f)])
    assert np.array_equal(out, ref)


def test_shear_bicubic_f32_canvas_shift_follows_the_jax_kernel(rng):
    """The canvas shift ceil(s*h) is taken in f64, as PIL's caller and
    apply_shear take it; the JAX kernel takes it in f32. Where h is a
    multiple of 10, s*h of an f32 grid value can round down onto an integer
    in f32 and not in f64 (h = 40, s = 0.2f: 8 against 9), so the JAX kernel
    is one pixel off there. The port equals JAX apply_shear (f64) at every
    grid value, and the JAX kernel wherever the two rules agree; at s = 0.2
    the JAX kernel's output is the port's moved by one pixel (<= 1 LSB:
    xx + 1 may round differently in f32)."""
    imgs = rng.integers(0, 256, (11, 40, 24, 3), dtype=np.uint8)
    f = np.asarray(SHEAR_GRID, np.float32)
    out = rs.shear_bicubic_batched(torch.from_numpy(imgs), f).numpy()
    ref = np.concatenate([np.asarray(jwp.apply_shear(imgs[i : i + 1], float(v)))[:, :, :24]
                          for i, v in enumerate(f)])
    np.testing.assert_array_equal(out, ref)
    want = np.asarray(jrs.shear_bicubic_batched(jnp.asarray(imgs), jnp.asarray(f)))
    f32_rule = np.ceil(f * np.float32(40)).astype(int)
    f64_rule = np.asarray([np.ceil(float(v) * 40) for v in f]).astype(int)
    agree = f32_rule == f64_rule
    assert not agree[2] and agree.sum() >= 5  # s = 0.2: ceil 8 in f32, 9 in f64
    np.testing.assert_array_equal(out[agree], want[agree])
    assert np.abs(out[2:3, :, 1:].astype(int) - want[2:3, :, :-1].astype(int)).max() <= 1


def test_shear_bicubic_matches_f64_oracle(rng):
    """Against the numpy f64 oracle the f32 Horner may flip a truncation
    boundary: <= 1 LSB on <= 2.5% (tests/test_models_pipeline.py's budget)."""
    imgs = rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    f = np.asarray([0.1, 0.3, 0.6, 1.0], np.float32)
    out = rs.shear_bicubic_batched(torch.from_numpy(imgs), f).numpy()
    ref = np.stack([oww.apply_shear(imgs[i], float(v))[:, :32] for i, v in enumerate(f)])
    err = np.abs(out.astype(int) - ref.astype(int))
    assert err.max() <= 1 and (err > 0).mean() <= 0.025


def test_shear_bicubic_scalar_factor_and_cpu_counts_no_launch(rng):
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 24, 20, 3), dtype=np.uint8))
    before = dict(mk.LAUNCHES)
    one = rs.shear_bicubic_batched(imgs, 0.3)
    assert torch.equal(one, rs.shear_bicubic_batched(imgs, torch.tensor([0.3, 0.3])))
    assert mk.LAUNCHES == before
    with pytest.raises(ValueError):
        rs.shear_bicubic_batched(imgs.float(), 0.3)
    with pytest.raises(ValueError):
        rs.shear_bicubic(imgs.to("meta"), torch.zeros(2, device="meta"))


def test_resize_coeffs_equal_oracle():
    for in_size, out_size in ((32, 28), (32, 44), (512, 716), (48, 43), (40, 40)):
        for method in ("lanczos", "bilinear", "box"):
            b1, k1 = twp.resize_coeffs(in_size, out_size, method)
            b2, k2 = oww.resize_coeffs(in_size, out_size, method)
            assert np.array_equal(b1, b2) and np.array_equal(k1, k2)
    assert twp.PRECISION_BITS == oww.PRECISION_BITS
    for size in (32, 40):
        assert np.array_equal(twp._scale_canvas_matrices(size, SCALE_GRID),
                              jwp._scale_canvas_matrices(size, SCALE_GRID))


@pytest.mark.parametrize(
    "shape,factors",
    [
        ((6, 32, 32, 3), list(SCALE_GRID)),
        ((3, 48, 40, 3), [0.9, 1.2, 1.4]),
        ((2, 40, 56, 1), [1.3, 1.0]),
    ],
)
def test_apply_scale_batched_matches_oracle(rng, shape, factors):
    imgs = rng.integers(0, 256, shape, dtype=np.uint8)
    f = np.asarray(factors, np.float32)
    out = twp.apply_scale_batched(torch.from_numpy(imgs), f, SCALE_GRID).numpy()
    assert out.shape == imgs.shape and out.dtype == np.uint8
    ref = np.stack([oww.apply_scale(imgs[i], float(v)) for i, v in enumerate(f)])
    assert np.array_equal(out, ref)


def test_apply_scale_batched_matches_jax_and_snaps_to_grid(rng):
    imgs = rng.integers(0, 256, (3, 40, 48, 3), dtype=np.uint8)
    f = np.asarray([1.14, 0.96, 1.36], np.float32)  # nearest: 1.1, 1.0, 1.4
    out = twp.apply_scale_batched(torch.from_numpy(imgs), f, SCALE_GRID).numpy()
    want = np.asarray(jwp.apply_scale_batched(jnp.asarray(imgs), jnp.asarray(f), SCALE_GRID))
    assert np.array_equal(out, want)
    snapped = np.asarray([1.1, 1.0, 1.4], np.float32)
    ref = twp.apply_scale_batched(torch.from_numpy(imgs), snapped, SCALE_GRID).numpy()
    assert np.array_equal(out, ref)
