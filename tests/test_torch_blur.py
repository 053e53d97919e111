"""The port's separable Gaussian blur (kernel #6) against the JAX package.

``imagetransformations_tpu_torch/ops/hopper/blur.py`` ``blur_separable`` and
``blur_to_sheared_rows`` are held against a numpy f32 transcription of the
kernel's op order, the JAX functions (the Pallas kernel in interpret mode on
the CPU) and the f64 oracle (``oracle/stencil.gaussian_blur``). On the CPU
the port runs the kernel's plain version (``stencil.gaussian_blur_plain``);
the CUDA kernel is compared with it on the card
(tests/test_torch_cuda_kernels.py and chip_smoke.py).

Budgets: 0 LSB against the numpy f32 transcription (both round every
operation on its own) and against the JAX kernel on these inputs (measured:
0 LSB at every case here, tools/port_parity_report.py); <= 1 LSB on <= 0.1%
of values against the f64 oracle (measured: 1 LSB on 0.004% at 2x64x128 r 5,
none elsewhere).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagetransformations_tpu.oracle import stencil as ost
from imagetransformations_tpu.ops import stencil as jst
from imagetransformations_tpu.ops.pallas import blur as jblur

from imagetransformations_tpu_torch.ops import stencil as tst
from imagetransformations_tpu_torch.ops.hopper import _lib
from imagetransformations_tpu_torch.ops.hopper import blur as tblur

SHAPES = [(2, 48, 40, 3), (2, 40, 48, 3), (2, 64, 128, 3)]
RADII = [0.5, 1.5, 5.0]


def numpy_blur_f32(x: np.ndarray, radius: float) -> np.ndarray:
    """The kernel's op order in numpy f32: reflect-101 pad, vertical taps
    then horizontal, t = 0..K-1 as acc + x*tap, rint, clip."""
    k = ost.cv2_gaussian_ksize(radius)
    taps = ost.gaussian_taps(k, radius).astype(np.float32)
    p = k // 2
    n, h, w, c = x.shape
    xp = np.pad(x.astype(np.float32), [(0, 0), (p, p), (p, p), (0, 0)], mode="reflect")
    v = None
    for t in range(k):
        term = xp[:, t : t + h] * taps[t]
        v = term if v is None else v + term
    o = None
    for t in range(k):
        term = v[:, :, t : t + w] * taps[t]
        o = term if o is None else o + term
    return np.clip(np.rint(o), 0, 255).astype(np.uint8)


def _err(a, b):
    e = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
    return int(e.max()), float((e > 0).mean())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("radius", RADII)
def test_blur_separable_equals_numpy_f32(rng, shape, radius):
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    out = tblur.blur_separable(torch.from_numpy(x), radius).numpy()
    np.testing.assert_array_equal(out, numpy_blur_f32(x, radius))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("radius", RADII)
def test_blur_separable_vs_jax_and_oracle(rng, shape, radius):
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    out = tblur.blur_separable(torch.from_numpy(x), radius).numpy()
    want = np.asarray(jblur.blur_separable(jnp.asarray(x), radius))
    assert _err(out, want)[0] == 0
    ref = np.stack([ost.gaussian_blur(im, radius) for im in x])
    lsb, frac = _err(out, ref)
    assert lsb <= 1 and frac <= 0.001, (lsb, frac)


def test_blur_zero_radius_is_identity(rng):
    x = torch.from_numpy(rng.integers(0, 256, (2, 24, 20, 3), dtype=np.uint8))
    assert tblur.blur_separable(x, 0.0) is x
    assert tst.gaussian_blur(x, 0) is x


@pytest.mark.parametrize("shape", [(4, 5, 7, 3), (1, 1, 9, 3), (2, 3, 2, 1)])
def test_tiny_images_match_jax_gaussian_blur(rng, shape):
    """Images narrower than the window: reflect-101 reflects again."""
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    out = tblur.blur_separable(torch.from_numpy(x), 1.5).numpy()
    np.testing.assert_array_equal(out, np.asarray(jst.gaussian_blur(jnp.asarray(x), 1.5)))
    np.testing.assert_array_equal(out, numpy_blur_f32(x, 1.5))


@pytest.mark.parametrize("radius", [0.0, 1.5])
def test_blur_to_sheared_rows_byte_equal_to_jax(rng, radius):
    x = rng.integers(0, 256, (2, 64, 128, 3), dtype=np.uint8)
    out = tblur.blur_to_sheared_rows(torch.from_numpy(x), radius, 12, 512, 9).numpy()
    want = np.asarray(jblur.blur_to_sheared_rows(jnp.asarray(x), radius, 12, 512, 9))
    assert out.shape == want.shape == (64, 2, 512)
    np.testing.assert_array_equal(out, want)


def test_blur_to_sheared_rows_any_layout(rng):
    """No 128-lane alignment: any width, any margins that fit."""
    x = rng.integers(0, 256, (3, 10, 7, 3), dtype=np.uint8)
    out = tblur.blur_to_sheared_rows(torch.from_numpy(x), 1.0, 5, 40, 200).numpy()
    blurred = numpy_blur_f32(x, 1.0).transpose(1, 0, 2, 3).reshape(10, 3, 21)
    assert (out[:, :, :5] == 200).all() and (out[:, :, 26:] == 200).all()
    np.testing.assert_array_equal(out[:, :, 5:26], blurred)
    with pytest.raises(ValueError, match="fit"):
        tblur.blur_to_sheared_rows(torch.from_numpy(x), 1.0, 30, 40, 0)


def test_cpu_runs_plain_and_counts_no_launch(rng):
    x = torch.from_numpy(rng.integers(0, 256, (2, 24, 20, 3), dtype=np.uint8))
    before = dict(_lib.LAUNCHES)
    out = tblur.blur_separable(x, 1.5)
    assert torch.equal(out, tst.gaussian_blur_plain(x, 1.5))
    assert torch.equal(tst.gaussian_blur(x, 1.5), out)
    assert _lib.LAUNCHES == before


def test_wrapper_raises_off_cpu_and_cuda_and_on_bad_input():
    with pytest.raises(ValueError):
        tblur.blur_separable(torch.zeros((1, 8, 8, 3), dtype=torch.uint8, device="meta"), 1.5)
    with pytest.raises(ValueError, match="uint8"):
        tblur.blur_separable(torch.zeros((1, 8, 8, 3)), 1.5)
    with pytest.raises(ValueError, match="uint8"):
        tblur.blur_separable(torch.zeros((8, 8, 3), dtype=torch.uint8), 1.5)
