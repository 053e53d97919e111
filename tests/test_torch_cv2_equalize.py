"""The port's ``histogram_equalization`` is cv2's YUV equalization, bit for bit.

The reference (pipenline/cifar_image_transformations.py:122-129) runs cv2
RGB2YUV, equalizeHist on Y and YUV2RGB on uint8 images. cv2's u8
conversions are 14-bit fixed point; ``numpy_equalize`` below writes them
out from cv2's description (not from the port), with equalizeHist's own
LUT (``lut = rint(f32(cdf - cdf_min) * f32(255 / (total - hist_min)))``,
an image of one level kept as it is). The port's op (plain PyTorch; it has
no kernel) is held to cv2 and to the model at 0 LSB on random, narrow-range,
ramp, one-level and two-level images down to 1x7, and on one channel
(Y = L, U = V = 128).

The JAX package converts in f32, and a flipped Y level moves the CDF:
against it the port is within <= 32 LSB on <= 35% of values on random
images (measured here: 21-28 LSB, on 29.6-29.7% of values).
"""

import numpy as np
import pytest
import torch

import cv2
import jax.numpy as jnp

from imagetransformations_tpu.ops import histogram as jhg

from imagetransformations_tpu_torch.ops import histogram as hg

SHAPES = [(64, 64), (23, 37), (37, 15), (15, 38), (1, 7), (3, 1)]
KINDS = ["random", "narrow", "ramp", "flat", "two"]
JAX_BUDGET = (32, 0.35)


def _image(kind, shape, seed):
    rng = np.random.default_rng(seed)
    h, w = shape
    if kind == "random":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == "narrow":
        return rng.integers(100, 140, (h, w, 3), dtype=np.uint8)
    if kind == "ramp":
        return (np.arange(h * w * 3) % 256).reshape(h, w, 3).astype(np.uint8)
    if kind == "flat":
        return np.full((h, w, 3), int(rng.integers(0, 256)), np.uint8)
    return rng.integers(0, 2, (h, w, 3)).astype(np.uint8) * 200


def cv2_equalize(img):
    yuv = cv2.cvtColor(img, cv2.COLOR_RGB2YUV)
    yuv[..., 0] = cv2.equalizeHist(yuv[..., 0])
    return cv2.cvtColor(yuv, cv2.COLOR_YUV2RGB)


def numpy_equalize(img):
    x = img.astype(np.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    half = 1 << 13
    y = (r * 4899 + g * 9617 + b * 1868 + half) >> 14
    u = np.clip(((b - y) * 8061 + (128 << 14) + half) >> 14, 0, 255) - 128
    v = np.clip(((r - y) * 14369 + (128 << 14) + half) >> 14, 0, 255) - 128
    hist = np.bincount(y.ravel(), minlength=256)
    lo = int(np.nonzero(hist)[0][0])
    if hist[lo] == y.size:
        lut = np.full(256, lo)
    else:
        scale = np.float32(255) / np.float32(y.size - hist[lo])
        cdf = np.cumsum(hist) - hist[lo]
        lut = np.clip(np.rint(cdf.astype(np.float32) * scale), 0, 255).astype(np.int64)
    y = lut[y]
    out = (y + ((v * 18678 + half) >> 14), y + ((u * -6472 + v * -9519 + half) >> 14),
           y + ((u * 33292 + half) >> 14))
    return np.clip(np.stack(out, -1), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_equals_cv2_and_the_integer_model(kind, shape):
    img = _image(kind, shape, sum(shape) + len(kind))
    got = hg.histogram_equalization(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got, cv2_equalize(img))
    np.testing.assert_array_equal(got, numpy_equalize(img))


def test_a_batch_equalizes_each_image_on_its_own():
    imgs = np.stack([_image(k, (21, 30), i) for i, k in enumerate(KINDS)])
    got = hg.histogram_equalization(torch.from_numpy(imgs)).numpy()
    np.testing.assert_array_equal(got, np.stack([cv2_equalize(im) for im in imgs]))


@pytest.mark.parametrize("kind", ["random", "narrow", "flat"])
def test_one_channel_is_its_own_luma(kind):
    img = _image(kind, (19, 26), 5)[..., :1]
    got = hg.histogram_equalization(torch.from_numpy(img)).numpy()
    assert got.shape == (19, 26, 3)
    np.testing.assert_array_equal(got, cv2_equalize(np.repeat(img, 3, axis=-1)))


def test_cv2_lut_rounds_where_the_jax_lut_does_not():
    """equalizeHist's LUT scales before it rounds; the JAX rule divides
    after the product. At 23x37 they part by one level on random Y."""
    y = cv2.cvtColor(_image("random", (23, 37), 0), cv2.COLOR_RGB2YUV)[..., 0]
    cv2_lut = hg.equalize_channel_cv2(torch.from_numpy(y)[None]).numpy()[0]
    np.testing.assert_array_equal(cv2_lut, cv2.equalizeHist(y))
    assert not np.array_equal(hg.equalize_channel(torch.from_numpy(y)).numpy(), cv2_lut)


@pytest.mark.parametrize("shape", [(40, 48), (23, 37), (64, 64)])
def test_jax_within_its_budget(shape):
    imgs = np.stack([_image("random", shape, s) for s in range(2)])
    got = hg.histogram_equalization(torch.from_numpy(imgs)).numpy()
    want = np.asarray(jhg.histogram_equalization(jnp.asarray(imgs)))
    err = np.abs(got.astype(int) - want.astype(int))
    assert err.max() <= JAX_BUDGET[0] and (err > 0).mean() <= JAX_BUDGET[1], (
        err.max(), (err > 0).mean())


def test_float_input_keeps_the_f32_conversion():
    x = np.random.default_rng(2).random((2, 20, 24, 3)).astype(np.float32) * 255
    got = hg.histogram_equalization(torch.from_numpy(x)).numpy()
    want = np.asarray(jhg.histogram_equalization(jnp.asarray(x)))
    assert got.dtype == np.float32 and np.abs(got - want).max() <= 2e-3
