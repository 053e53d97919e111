"""The port's elementwise, stencil, noise, histogram and warp ops against the
JAX package (XLA on its CPU backend) and the numpy oracles.

Same numpy inputs on both sides. Budgets: 0 LSB where both sides round
alike. XLA-CPU contracts the blends of ``enhance_contrast``,
``enhance_color`` and ``sharpen`` (elementwise.py:97, stencil.py:163) into
FMAs, which the port, like PIL, rounds as two operations: those are held to
<= 1 LSB on <= 1% of values against JAX and to 0 LSB against a numpy f32
transcription. Float inputs give float outputs, held to 2e-3 on the [0, 255]
scale (FMA and accumulation order).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagetransformations_tpu import ops as jops
from imagetransformations_tpu.ops import histogram as jhg
from imagetransformations_tpu.ops import noise as jnz
from imagetransformations_tpu.ops import stencil as jst
from imagetransformations_tpu.ops import warp as jwp
from imagetransformations_tpu.oracle import elementwise as oe
from imagetransformations_tpu.oracle import stencil as ost

from imagetransformations_tpu_torch.ops import elementwise as ew
from imagetransformations_tpu_torch.ops import histogram as hg
from imagetransformations_tpu_torch.ops import noise as nz
from imagetransformations_tpu_torch.ops import stencil as st
from imagetransformations_tpu_torch.ops import warp as wp


def _err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, a.dtype, b.shape, b.dtype)
    e = np.abs(a.astype(np.float64) - b.astype(np.float64))
    return float(e.max()), float((e > 0).mean())


@pytest.fixture
def imgs(rng):
    return rng.integers(0, 256, (2, 40, 48, 3), dtype=np.uint8)


# (port fn, JAX fn, budget): "exact" 0 LSB, "fma" <= 1 LSB on <= 1%
OPS = {
    "grayscale": (ew.grayscale, jops.grayscale, "exact"),
    "grayscale keep_rgb=False": (lambda x: ew.grayscale(x, keep_rgb=False),
                                 lambda x: jops.grayscale(x, keep_rgb=False), "exact"),
    "invert": (ew.invert, jops.invert, "exact"),
    "enhance_contrast 1.3": (lambda x: ew.enhance_contrast(x, 1.3),
                             lambda x: jops.enhance_contrast(x, 1.3), "fma"),
    "enhance_contrast 0.4": (lambda x: ew.enhance_contrast(x, 0.4),
                             lambda x: jops.enhance_contrast(x, 0.4), "fma"),
    "enhance_color 0.6": (lambda x: ew.enhance_color(x, 0.6),
                          lambda x: jops.enhance_color(x, 0.6), "fma"),
    "sharpen 1.5": (lambda x: st.sharpen(x, 1.5), lambda x: jst.sharpen(x, 1.5), "fma"),
    "sharpen 0.3": (lambda x: st.sharpen(x, 0.3), lambda x: jst.sharpen(x, 0.3), "fma"),
    "motion_blur 5": (lambda x: st.motion_blur(x, 5), lambda x: jst.motion_blur(x, 5), "exact"),
    "motion_blur 4": (lambda x: st.motion_blur(x, 4), lambda x: jst.motion_blur(x, 4), "exact"),
    "histogram_equalization": (hg.histogram_equalization, jhg.histogram_equalization,
                               "exact"),
    "apply_translation 5,-3": (lambda x: wp.apply_translation(x, 5, -3),
                               lambda x: jwp.apply_translation(x, 5, -3), "exact"),
    "apply_translation -2.7": (lambda x: wp.apply_translation(x, -2.7),
                               lambda x: jwp.apply_translation(x, -2.7), "exact"),
    "apply_translation 60": (lambda x: wp.apply_translation(x, 60),
                             lambda x: jwp.apply_translation(x, 60), "exact"),
    "flip_vertical": (wp.flip_vertical, jwp.flip_vertical, "exact"),
    "apply_scale 1.3": (lambda x: wp.apply_scale(x, 1.3), lambda x: jwp.apply_scale(x, 1.3),
                        "exact"),
    "apply_scale 0.7": (lambda x: wp.apply_scale(x, 0.7), lambda x: jwp.apply_scale(x, 0.7),
                        "exact"),
    "apply_scale 1.0": (lambda x: wp.apply_scale(x, 1.0), lambda x: jwp.apply_scale(x, 1.0),
                        "exact"),
}


def _check(out, want, budget):
    lsb, frac = _err(out, want)
    if budget == "exact":
        assert lsb == 0, (lsb, frac)
    else:
        assert lsb <= 1 and frac <= 0.01, (lsb, frac)


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_matches_jax_u8(imgs, name):
    port, jax_fn, budget = OPS[name]
    out = port(torch.from_numpy(imgs)).numpy()
    _check(out, np.asarray(jax_fn(jnp.asarray(imgs))), budget)


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_matches_jax_hwc(imgs, name):
    port, jax_fn, budget = OPS[name]
    out = port(torch.from_numpy(imgs[1])).numpy()
    _check(out, np.asarray(jax_fn(jnp.asarray(imgs[1]))), budget)


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_matches_jax_float(rng, name):
    port, jax_fn, _ = OPS[name]
    x = (rng.random((2, 24, 20, 3)) * 255).astype(np.float32)
    out = port(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_fn(jnp.asarray(x)))
    assert out.dtype == want.dtype == np.float32
    assert _err(out, want)[0] <= 2e-3


def _numpy_blend(base, x, factor):
    """base + (x - base) * factor in numpy f32, each op rounded on its own."""
    return base + (x - base) * np.float32(factor)


@pytest.mark.parametrize("factor", [1.3, 0.4])
def test_enhance_blends_equal_numpy_f32(imgs, factor):
    """The port rounds the blends as PIL does: 0 LSB against numpy f32."""
    xf = imgs.astype(np.float32)
    luma = np.stack([oe.grayscale_l24(im) for im in imgs]).astype(np.int64)[..., None]
    gray = luma.astype(np.float32)
    want = np.clip(np.trunc(_numpy_blend(gray, xf, factor)), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(ew.enhance_color(torch.from_numpy(imgs), factor).numpy(), want)
    npix = 40 * 48
    mean = ((2 * luma.sum(axis=(1, 2, 3), keepdims=True) + npix) // (2 * npix)).astype(np.float32)
    want = np.clip(np.trunc(_numpy_blend(mean, xf, factor)), 0, 255).astype(np.uint8)
    np.testing.assert_array_equal(ew.enhance_contrast(torch.from_numpy(imgs), factor).numpy(),
                                  want)


def test_sharpen_equals_pil_oracle(imgs):
    out = st.sharpen(torch.from_numpy(imgs), 1.5).numpy()
    np.testing.assert_array_equal(out, np.stack([ost.sharpness(im, 1.5) for im in imgs]))


def test_per_image_factors_match_jax(imgs):
    f = np.asarray([0.5, 1.7], np.float32)
    for port, jax_fn in ((ew.enhance_color, jops.enhance_color), (st.sharpen, jst.sharpen),
                         (ew.enhance_contrast, jops.enhance_contrast)):
        _check(port(torch.from_numpy(imgs), torch.from_numpy(f)).numpy(),
               np.asarray(jax_fn(jnp.asarray(imgs), jnp.asarray(f))), "fma")


def test_histogram_pieces_match_jax(imgs):
    x = jnp.asarray(imgs)
    np.testing.assert_array_equal(hg.pixel_histogram(torch.from_numpy(imgs)).numpy(),
                                  np.asarray(jhg.pixel_histogram(x)))
    chan = imgs[..., 1]
    np.testing.assert_array_equal(hg.equalize_channel(torch.from_numpy(chan)).numpy(),
                                  np.asarray(jhg.equalize_channel(jnp.asarray(chan))))
    np.testing.assert_array_equal(hg.equalize_channel(torch.from_numpy(chan[0])).numpy(),
                                  np.asarray(jhg.equalize_channel(jnp.asarray(chan[0]))))
    flat = np.zeros((1, 8, 8, 3), np.uint8) + 17  # one bin: the denominator clamps to 1
    np.testing.assert_array_equal(hg.histogram_equalization(torch.from_numpy(flat)).numpy(),
                                  np.asarray(jhg.histogram_equalization(jnp.asarray(flat))))


def test_histogram_equalization_near_cv2_oracle(imgs):
    """The f32 YUV conversion stands in for cv2's integer one: a mean
    difference under 3 LSB, the budget of the JAX package's own test
    (tests/test_noise_histogram.py)."""
    out = hg.histogram_equalization(torch.from_numpy(imgs)).numpy()
    ref = np.stack([oe.histogram_equalization_yuv(im) for im in imgs])
    assert np.abs(out.astype(int) - ref.astype(int)).mean() < 3.0


def test_translation_with_per_image_shifts_matches_jax(imgs):
    tx = np.asarray([3.0, -4.6], np.float32)
    out = wp.apply_translation(torch.from_numpy(imgs), torch.from_numpy(tx), 2.0).numpy()
    want = np.asarray(jwp.apply_translation(jnp.asarray(imgs), jnp.asarray(tx), 2.0))
    np.testing.assert_array_equal(out, want)


def test_impulse_noise_with_explicit_draw_matches_jax(imgs, rng):
    u = rng.random((2, 40, 48), dtype=np.float32)
    for amount in (0.09, np.asarray([0.03, 0.27], np.float32)):
        out = nz.impulse_noise(torch.from_numpy(imgs), torch.as_tensor(amount), u=u).numpy()
        want = np.asarray(jnz.impulse_noise(jnp.asarray(imgs), jnp.asarray(amount), u=u))
        np.testing.assert_array_equal(out, want)
        np.testing.assert_array_equal(
            out[0], oe.impulse_noise(imgs[0], float(np.atleast_1d(amount)[0]), u[0]))
    hwc = nz.impulse_noise(torch.from_numpy(imgs[0]), 0.2, u=u[0]).numpy()
    np.testing.assert_array_equal(hwc, np.asarray(jnz.impulse_noise(jnp.asarray(imgs[0]), 0.2,
                                                                    u=u[0])))


def test_impulse_noise_from_generator(imgs):
    x = torch.from_numpy(imgs)
    a = nz.impulse_noise(x, 0.2, generator=torch.Generator().manual_seed(3))
    b = nz.impulse_noise(x, 0.2, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    hit = (a != x).any(-1)
    assert 0.1 < float(hit.float().mean()) < 0.25
    assert set(np.unique(a.numpy()[hit.numpy()])) <= {0, 255}


def test_shot_noise_determinism_zero_and_mean(rng):
    x = torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8))
    a = nz.shot_noise(x, 30.0, generator=torch.Generator().manual_seed(5))
    b = nz.shot_noise(x, 30.0, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and a.dtype == torch.uint8
    zero = torch.zeros((1, 16, 16, 3), dtype=torch.uint8)
    assert torch.equal(nz.shot_noise(zero, 5.0, generator=torch.Generator().manual_seed(1)), zero)
    big = nz.shot_noise(x, 1e5, generator=torch.Generator().manual_seed(2))
    assert abs(float(big.float().mean() - x.float().mean())) < 0.5
    assert int((big.to(torch.int16) - x.to(torch.int16)).abs().max()) <= 4
    per_image = nz.shot_noise(x, torch.tensor([3.0, 60.0]), generator=torch.Generator())
    assert per_image.shape == x.shape


def test_shot_noise_matches_the_oracle_on_one_draw(rng, monkeypatch):
    """With the Poisson draw fixed, the rest is the oracle's formula."""
    x = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
    draw = rng.poisson(x.astype(np.float64) / 255.0 * 10.0).astype(np.float32)
    monkeypatch.setattr(torch, "poisson", lambda rate, generator=None: torch.from_numpy(draw))
    out = nz.shot_noise(torch.from_numpy(x), 10.0, generator=torch.Generator()).numpy()
    np.testing.assert_array_equal(out, oe.shot_noise(x, 10.0, draw))
