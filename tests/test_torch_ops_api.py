"""The rest of the per-op API (ROADMAP A.2) in the port, on the CPU.

``imagetransformations_tpu_torch.ops`` exports the JAX package's 31 names.
Gates: ``pil_resize`` (every ``resize_coeffs`` filter), ``pil_box_blur``,
``pil_gaussian_blur`` and ``sobel_edges("wrap_u8")`` at 0 LSB against PIL /
scipy themselves and against the JAX package and its oracles;
``sobel_edges("float")`` within 1e-5 of JAX; ``center_crop`` equal to JAX;
``perspective_coeffs`` within 1e-6 of JAX; ``perspective_warp`` /
``apply_perspective`` within 1 LSB on at most 1% of values against JAX
(XLA-CPU contracts FMAs, ROADMAP C.3); ``gaussian_noise_01`` with an
explicit draw within 1 LSB of JAX, and from a generator deterministic with
the right moments; ``image_entropy`` within 1e-5 relative of JAX in both
bases; ``apply_shear`` raises ``ValueError`` on a negative canvas width, as
PIL and the oracle do.
"""

import numpy as np
import pytest
import torch
from PIL import Image, ImageFilter

import jax.numpy as jnp

import imagetransformations_tpu.ops as jops
from imagetransformations_tpu.ops import warp as jwp
from imagetransformations_tpu.oracle import stencil as ost
from imagetransformations_tpu.oracle import warp as ow

import imagetransformations_tpu_torch.ops as tops
from imagetransformations_tpu_torch.ops import warp as twp


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _lsb(a, b):
    return np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64))


def _pil(img, fn):
    """``fn`` of each image through PIL (mode L for one channel)."""
    outs = []
    for im in img:
        pim = Image.fromarray(im[..., 0] if im.shape[-1] == 1 else im)
        out = np.asarray(fn(pim))
        outs.append(out[..., None] if out.ndim == 2 else out)
    return np.stack(outs)


def test_ops_exports_the_jax_names():
    def names(mod):
        return sorted(k for k in dir(mod) if not k.startswith("_") and callable(getattr(mod, k))
                      and not isinstance(getattr(mod, k), type(np)))

    assert names(tops) == names(jops)
    assert len(names(tops)) == 31


@pytest.mark.parametrize("method", ["lanczos", "bilinear", "box"])
@pytest.mark.parametrize("c", [1, 3])
@pytest.mark.parametrize("size", [(13, 9), (53, 41)], ids=["down", "up"])
def test_pil_resize_exact(rng, method, c, size):
    img = rng.integers(0, 256, (2, 23, 31, c), dtype=np.uint8)
    ow_, oh = size
    got = twp.pil_resize(_t(img), ow_, oh, method).numpy()
    flt = {"lanczos": Image.LANCZOS, "bilinear": Image.BILINEAR, "box": Image.BOX}[method]
    np.testing.assert_array_equal(got, _pil(img, lambda p: p.resize((ow_, oh), flt)))
    np.testing.assert_array_equal(got, np.asarray(jwp.pil_resize(jnp.asarray(img), ow_, oh,
                                                                 method)))
    oracle = ow.pil_resize(img[0], ow_, oh, method)
    np.testing.assert_array_equal(got[0], oracle.reshape(got[0].shape))


@pytest.mark.parametrize("radius", [0.5, 1.0, 2.7])
@pytest.mark.parametrize("c", [1, 3])
def test_pil_box_and_gaussian_blur_exact(rng, radius, c):
    img = rng.integers(0, 256, (2, 19, 27, c), dtype=np.uint8)
    box = tops.pil_box_blur(_t(img), radius).numpy()
    np.testing.assert_array_equal(box, _pil(img, lambda p: p.filter(ImageFilter.BoxBlur(radius))))
    np.testing.assert_array_equal(box, np.asarray(jops.pil_box_blur(jnp.asarray(img), radius)))
    gauss = tops.pil_gaussian_blur(_t(img), radius).numpy()
    np.testing.assert_array_equal(
        gauss, _pil(img, lambda p: p.filter(ImageFilter.GaussianBlur(radius))))
    np.testing.assert_array_equal(gauss[0], ost.pil_gaussian_blur(img[0], radius)
                                  .reshape(gauss[0].shape))
    np.testing.assert_array_equal(gauss, np.asarray(jops.pil_gaussian_blur(jnp.asarray(img),
                                                                          radius)))


def test_sobel_edges_wrap_u8_and_float(rng):
    from scipy import ndimage

    gray = rng.integers(0, 256, (3, 17, 22), dtype=np.uint8)
    got = tops.sobel_edges(_t(gray)).numpy()
    np.testing.assert_array_equal(got, np.stack([ndimage.sobel(g) for g in gray]))
    np.testing.assert_array_equal(got, np.asarray(jops.sobel_edges(jnp.asarray(gray))))
    rgb = rng.integers(0, 256, (2, 17, 22, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tops.sobel_edges(_t(rgb)).numpy(),
                                  np.asarray(jops.sobel_edges(jnp.asarray(rgb))))
    one = tops.sobel_edges(_t(gray[0])).numpy()
    np.testing.assert_array_equal(one, ndimage.sobel(gray[0]))
    flt = tops.sobel_edges(_t(rgb), mode="float").numpy()
    np.testing.assert_allclose(flt, np.asarray(jops.sobel_edges(jnp.asarray(rgb), mode="float")),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("crop", [(10, 16), (17, 22), (1, 1)])
def test_center_crop_equals_jax(rng, crop):
    img = rng.integers(0, 256, (2, 17, 22, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tops.center_crop(_t(img), *crop).numpy(),
                                  np.asarray(jops.center_crop(jnp.asarray(img), *crop)))
    np.testing.assert_array_equal(tops.center_crop(_t(img[0]), *crop).numpy(),
                                  np.asarray(jops.center_crop(jnp.asarray(img[0]), *crop)))


QUADS = [
    ([[0, 0], [31, 0], [31, 23], [0, 23]], [[3, 2], [29, 0], [31, 21], [1, 23]]),
    ([[0, 0], [31, 0], [31, 23], [0, 23]], [[0, 4], [27, 1], [30, 23], [5, 20]]),
    ([[1, 1], [30, 2], [29, 22], [2, 21], [15, 11]], [[2, 1], [28, 3], [30, 20], [3, 22],
                                                      [16, 11]]),
]


@pytest.mark.parametrize("quad", range(len(QUADS)))
def test_perspective_within_budget_of_jax(rng, quad):
    sp, ep = QUADS[quad]
    np.testing.assert_allclose(tops.perspective_coeffs(sp, ep), jops.perspective_coeffs(sp, ep),
                               atol=1e-6, rtol=0)
    img = rng.integers(0, 256, (2, 24, 32, 3), dtype=np.uint8)
    for fill in (0.0, 255.0):
        got = tops.apply_perspective(_t(img), sp, ep, fill=fill).numpy()
        want = np.asarray(jops.apply_perspective(jnp.asarray(img), sp, ep, fill=fill))
        d = _lsb(got, want)
        assert d.max() <= 1 and (d > 0).mean() <= 0.01
    # one row of coefficients an image, and float input
    cf = np.stack([tops.perspective_coeffs(*QUADS[0]), tops.perspective_coeffs(*QUADS[1])])
    got = tops.perspective_warp(_t(img.astype(np.float32)), cf).numpy()
    want = np.asarray(jops.perspective_warp(jnp.asarray(img.astype(np.float32)), jnp.asarray(cf)))
    assert np.abs(got - want).max() <= 1e-3


def test_gaussian_noise_01_explicit_draw_and_generator(rng):
    img = rng.integers(0, 256, (3, 16, 20, 3), dtype=np.uint8)
    noise = rng.standard_normal(img.shape).astype(np.float32)
    for s in (0.08, [0.04, 0.2, 0.38]):
        got = tops.gaussian_noise_01(_t(img), s, noise=_t(noise)).numpy()
        want = np.asarray(jops.gaussian_noise_01(jnp.asarray(img), jnp.asarray(s, jnp.float32),
                                                 noise=jnp.asarray(noise)))
        assert _lsb(got, want).max() <= 1
    flat = np.full((2, 64, 64, 3), 128, np.uint8)
    a = tops.gaussian_noise_01(_t(flat), 0.1, generator=torch.Generator().manual_seed(5))
    b = tops.gaussian_noise_01(_t(flat), 0.1, generator=torch.Generator().manual_seed(5))
    c = tops.gaussian_noise_01(_t(flat), 0.1, generator=torch.Generator().manual_seed(6))
    assert torch.equal(a, b) and not torch.equal(a, c)
    d = a.numpy().astype(np.float64) - 128.0
    assert abs(d.mean()) < 0.5 and abs(d.std() - 25.5) < 0.5


@pytest.mark.parametrize("base2", [True, False])
def test_image_entropy_matches_jax(rng, base2):
    imgs = [rng.integers(0, 256, (3, 16, 24, 3), dtype=np.uint8),
            rng.integers(100, 104, (2, 16, 24, 1), dtype=np.uint8),
            np.zeros((1, 8, 8, 3), np.uint8)]
    for img in imgs:
        got = tops.image_entropy(_t(img), base2=base2).numpy()
        want = np.asarray(jops.image_entropy(jnp.asarray(img), base2=base2))
        assert got.dtype == np.float32 and got.shape == (img.shape[0],)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_apply_shear_negative_canvas_raises_value_error():
    img = np.zeros((2, 5, 1, 3), np.uint8)
    with pytest.raises(ValueError, match="canvas width"):
        tops.apply_shear(_t(img), -0.4)
    with pytest.raises(ValueError):  # PIL and the oracle refuse it too
        ow.apply_shear(img[0], -0.4)
