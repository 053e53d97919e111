"""The port's row shifts (kernels #7, #8) and 3-shear rotations against the
JAX package.

``imagetransformations_tpu_torch/ops/hopper/shear.py`` ``shear_rows`` (one
shift a row for the batch, optional grayscale post-op),
``shear_rows_per_image``, ``rotate_3shear`` and ``blur_rotate_fused`` are
held against the JAX functions (Pallas kernels in interpret mode on the CPU)
and the numpy oracle (``oracle/fast_warp.py``). On the CPU the port runs
the kernel's plain version; the CUDA kernel is compared with it on the card
(tests/test_torch_cuda_kernels.py and chip_smoke.py).

Budgets: 0 LSB against JAX and ``fast_warp`` (both sides round every f32
operation on its own here); ``blur_rotate_fused`` blurs as cv2 does (0 LSB
against cv2.GaussianBlur, then ``fast_warp``), and the JAX function, whose
blur is f32, within a measured budget.
"""

import numpy as np
import pytest
import torch

import cv2
import jax.numpy as jnp

from imagetransformations_tpu.oracle import elementwise as oe
from imagetransformations_tpu.oracle import fast_warp as ofw
from imagetransformations_tpu.oracle import stencil as ost
from imagetransformations_tpu.ops.pallas import shear as jshear

from imagetransformations_tpu_torch.ops.hopper import _lib
from imagetransformations_tpu_torch.ops.hopper import megakernel as mk
from imagetransformations_tpu_torch.ops.hopper import shear as tshear


@pytest.fixture
def batch(rng):
    return rng.integers(0, 256, (2, 48, 40, 3), dtype=np.uint8)


def _t(x):
    return torch.from_numpy(x)


def test_shear_rows_vs_jax_and_oracle(batch, rng):
    shifts = (rng.random(48).astype(np.float32) - 0.5) * 20.0
    out = tshear.shear_rows(_t(batch), shifts).numpy()
    np.testing.assert_array_equal(out, ofw.shear_rows(batch, shifts))
    np.testing.assert_array_equal(out, np.asarray(jshear.shear_rows(jnp.asarray(batch), shifts)))


@pytest.mark.parametrize("fill", [0, 9, 255])
def test_shear_rows_fill_and_tensor_shifts_vs_jax(batch, rng, fill):
    shifts = (rng.random(48).astype(np.float32) - 0.5) * 60.0  # beyond the 40-px rows too
    out = tshear.shear_rows(_t(batch), torch.from_numpy(shifts), fill=fill).numpy()
    want = np.asarray(jshear.shear_rows(jnp.asarray(batch), shifts, fill=fill))
    np.testing.assert_array_equal(out, want)


def test_shear_zero_shift_identity(batch):
    out = tshear.shear_rows(_t(batch), np.zeros(48, np.float32)).numpy()
    np.testing.assert_array_equal(out, batch)


@pytest.mark.parametrize("fill", [0, 77])
def test_shear_rows_grayscale_postop_vs_jax(batch, rng, fill):
    shifts = (rng.random(48).astype(np.float32) - 0.5) * 20.0
    out = tshear.shear_rows(_t(batch), shifts, fill=fill, postop="grayscale").numpy()
    want = np.asarray(jshear.shear_rows(jnp.asarray(batch), shifts, fill=fill,
                                        postop="grayscale"))
    np.testing.assert_array_equal(out, want)
    sheared = ofw.shear_rows(batch, shifts, fill=fill)
    np.testing.assert_array_equal(out, np.stack([oe.grayscale_rgb(im) for im in sheared]))


def test_shear_rows_explicit_pad_saturates(batch, rng):
    """Shifts beyond an explicit pad_px saturate at +-pad_px (the Pallas
    lane roll wraps there: undefined). Within it, the JAX output."""
    shifts = (rng.random(48).astype(np.float32) - 0.5) * 20.0
    out = tshear.shear_rows(_t(batch), shifts, fill=5, pad_px=4).numpy()
    k = np.floor(shifts)
    saturated = (np.clip(k, -4, 4) + (shifts - k)).astype(np.float32)
    np.testing.assert_array_equal(out, ofw.shear_rows(batch, saturated, fill=5))
    inside = np.clip(shifts, -3.5, 3.5).astype(np.float32)
    np.testing.assert_array_equal(
        tshear.shear_rows(_t(batch), inside, pad_px=4).numpy(),
        np.asarray(jshear.shear_rows(jnp.asarray(batch), inside, pad_px=4)))


def test_shear_rows_per_image_vs_jax_and_oracle(batch, rng):
    shifts = ((rng.random((2, 48)) - 0.5) * 20.0).astype(np.float32)
    out = tshear.shear_rows_per_image(_t(batch), shifts, fill=9).numpy()
    np.testing.assert_array_equal(
        out, np.asarray(jshear.shear_rows_per_image(jnp.asarray(batch), shifts, fill=9)))
    for i in range(2):
        np.testing.assert_array_equal(out[i : i + 1],
                                      ofw.shear_rows(batch[i : i + 1], shifts[i], fill=9))


def test_shear_rows_per_image_saturation_vs_jax(batch, rng):
    shifts = ((rng.random((2, 48)) - 0.5) * 20.0).astype(np.float32)
    out = tshear.shear_rows_per_image(_t(batch), shifts, fill=9, pad_px=3).numpy()
    want = np.asarray(jshear.shear_rows_per_image(jnp.asarray(batch), shifts, fill=9, pad_px=3))
    np.testing.assert_array_equal(out, want)
    assert not np.array_equal(out, tshear.shear_rows_per_image(_t(batch), shifts, fill=9).numpy())
    with pytest.raises(ValueError, match="pad_px"):
        tshear.shear_rows_per_image(_t(batch), torch.from_numpy(shifts))


@pytest.mark.parametrize("angle", [0.0, 5.0, -15.0, 22.5, -22.5, 44.0, 60.0, -80.0])
def test_rotate_3shear_vs_jax_and_oracle(batch, angle):
    out = tshear.rotate_3shear(_t(batch), angle, fill=7).numpy()
    np.testing.assert_array_equal(out, ofw.rotate_3shear(batch, angle, fill=7))
    np.testing.assert_array_equal(
        out, np.asarray(jshear.rotate_3shear(jnp.asarray(batch), angle, fill=7)))


@pytest.mark.parametrize("angle", [15.0, -44.0])
def test_rotate_3shear_grayscale_vs_jax(batch, angle):
    out = tshear.rotate_3shear(_t(batch), angle, grayscale_out=True).numpy()
    want = np.asarray(jshear.rotate_3shear(jnp.asarray(batch), angle, grayscale_out=True))
    np.testing.assert_array_equal(out, want)


@pytest.mark.parametrize("angle,gray", [(15.0, True), (-44.0, False)])
def test_rotate_3shear_equals_strict_radius0_megakernel(batch, angle, gray):
    """Both equal fast_warp.rotate_3shear (then PIL gray): the row-shift
    passes and the strict rgb_blur_rotate kernel at radius 0 agree at 0 LSB."""
    out = tshear.rotate_3shear(_t(batch), angle, grayscale_out=gray)
    fused = mk.fused_blur_rotate_image(_t(batch), 0.0, angle, grayscale_out=gray, stream=False)
    assert torch.equal(out, fused)


def test_blur_rotate_fused_vs_jax_and_oracle(rng):
    """cv2's blur (the port's ``blur_separable``), then the 3-shear rotation
    and PIL gray: 0 LSB against cv2.GaussianBlur -> fast_warp.rotate_3shear
    -> grayscale_rgb; the JAX function, whose blur is f32, within <= 2 LSB
    on <= 10% of values (measured: 1 LSB on 7.2%)."""
    img = rng.integers(0, 256, (2, 64, 128, 3), dtype=np.uint8)
    out = tshear.blur_rotate_fused(_t(img), 1.5, 15.0, grayscale_out=True).numpy()
    want = np.asarray(jshear.blur_rotate_fused(jnp.asarray(img), 1.5, 15.0, grayscale_out=True))
    err = np.abs(out.astype(int) - want.astype(int))
    assert err.max() <= 2 and (err > 0).mean() <= 0.10, (err.max(), (err > 0).mean())
    k = ost.cv2_gaussian_ksize(1.5)
    blurred = np.stack([cv2.GaussianBlur(im, (k, k), 1.5) for im in img])
    ref = np.stack([oe.grayscale_rgb(im) for im in ofw.rotate_3shear(blurred, 15.0)])
    np.testing.assert_array_equal(out, ref)
    out0 = tshear.blur_rotate_fused(_t(img), 0.0, -10.0).numpy()  # radius 0 skips the blur
    np.testing.assert_array_equal(out0, ofw.rotate_3shear(img, -10.0))


def test_cpu_runs_plain_and_counts_no_launch(batch):
    before = dict(_lib.LAUNCHES)
    tshear.rotate_3shear(_t(batch), 15.0)
    tshear.blur_rotate_fused(_t(batch), 1.5, 15.0, grayscale_out=True)
    tshear.shear_rows_per_image(_t(batch), np.zeros((2, 48), np.float32))
    assert _lib.LAUNCHES == before


def test_bad_inputs_raise(batch):
    x = _t(batch)
    with pytest.raises(ValueError, match="shifts"):
        tshear.shear_rows(x, np.zeros(40, np.float32))
    with pytest.raises(ValueError, match="postop"):
        tshear.shear_rows(x, np.zeros(48, np.float32), postop="sepia")
    with pytest.raises(ValueError, match="3 channels"):
        tshear.shear_rows(x[..., :1], np.zeros(48, np.float32), postop="grayscale")
    with pytest.raises(ValueError, match="u8"):
        tshear.rotate_3shear(x, 10.0, fill=300)
    with pytest.raises(ValueError):
        tshear.shear_rows(x.to("meta"), np.zeros(48, np.float32))
