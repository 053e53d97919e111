"""The port's ``ops/composite.py`` against the JAX package's, on the CPU.

Gates: ``apply_background_change``, ``apply_camera_distance`` and
``apply_xy_translation_3d`` at 0 LSB; ``apply_background_change_simple``
within 1 LSB (XLA-CPU may contract its blend into a multiply-add);
``apply_rotation_3d`` is Pillow's NEAREST rotation in the port (ROADMAP
C.1.4), within C.2.9's 0.5% of pixels of JAX's. ``random_crop`` with an
explicit offset equals numpy's reflect pad cropped there; from a generator
one offset serves the whole batch, and every offset in 0..2*pad is drawn.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from imagetransformations_tpu.ops import composite as jcp

from imagetransformations_tpu_torch.ops import composite as tcp


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _lsb(a, b):
    return np.abs(np.asarray(a).astype(np.int64) - np.asarray(b).astype(np.int64))


def _smooth_batch(rng, n=2, h=24, w=30):
    """Images with edges and flat regions, so the edge mask is not trivial."""
    base = rng.integers(0, 256, (n, h // 4, w // 5, 3), dtype=np.uint8)
    big = np.stack([np.asarray(Image.fromarray(b).resize((w, h), Image.BILINEAR)) for b in base])
    return big


@pytest.mark.parametrize("bg", [(0.0, 0.5, 1.0), (0.93, 0.1, 0.27)])
def test_background_change_equals_jax(rng, bg):
    for img in (_smooth_batch(rng), rng.integers(0, 256, (3, 17, 23, 3), dtype=np.uint8)):
        got = tcp.apply_background_change(_t(img), bg).numpy()
        want = np.asarray(jcp.apply_background_change(jnp.asarray(img), jnp.asarray(bg)))
        np.testing.assert_array_equal(got, want)
        simple = tcp.apply_background_change_simple(_t(img), bg).numpy()
        want = np.asarray(jcp.apply_background_change_simple(jnp.asarray(img), jnp.asarray(bg)))
        assert _lsb(simple, want).max() <= 1
    one = _smooth_batch(rng, n=1)[0]
    np.testing.assert_array_equal(
        tcp.apply_background_change(_t(one), bg).numpy(),
        np.asarray(jcp.apply_background_change(jnp.asarray(one), jnp.asarray(bg))))


def test_dilate3x3_equals_jax_and_scipy(rng):
    from scipy import ndimage

    mask = rng.random((2, 15, 19)) > 0.93
    got = tcp._dilate3x3(_t(mask), 3).numpy()
    np.testing.assert_array_equal(got, np.asarray(jcp._dilate3x3(jnp.asarray(mask), 3)))
    want = np.stack([ndimage.binary_dilation(m, np.ones((3, 3)), iterations=3) for m in mask])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pad", [1, 4])
def test_random_crop_offset_and_generator(rng, pad):
    img = rng.integers(0, 256, (3, 12, 14, 3), dtype=np.uint8)
    padded = np.pad(img, [(0, 0), (pad, pad), (pad, pad), (0, 0)], mode="reflect")
    for y0, x0 in ((0, 0), (2 * pad, 2 * pad), (pad, 0), (1, 2 * pad - 1)):
        got = tcp.random_crop(_t(img), pad=pad, offset=(y0, x0)).numpy()
        np.testing.assert_array_equal(got, padded[:, y0 : y0 + 12, x0 : x0 + 14])
    offsets = {padded[:, y : y + 12, x : x + 14].tobytes(): (y, x)
               for y in range(2 * pad + 1) for x in range(2 * pad + 1)}
    g = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(1500):  # 81 offsets at pad 4: all drawn unless p < 1e-6
        got = tcp.random_crop(_t(img), g, pad=pad).numpy().tobytes()
        assert got in offsets, "the crop is not one offset shared by the batch"
        seen.add(offsets[got])
    assert seen == set(offsets.values())
    # JAX draws one offset for the batch as well
    out = np.asarray(jcp.random_crop(jnp.asarray(img), jax.random.key(3), pad=pad))
    assert any(np.array_equal(out, padded[:, y : y + 12, x : x + 14])
               for y in range(2 * pad + 1) for x in range(2 * pad + 1))


@pytest.mark.parametrize("d", [2.5, 3.0])
def test_camera_distance_and_translation_equal_jax(rng, d):
    img = rng.integers(0, 256, (2, 20, 26, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tcp.apply_camera_distance(_t(img), d).numpy(),
                                  np.asarray(jcp.apply_camera_distance(jnp.asarray(img), d)))
    for tx, ty in ((0.1, -0.25), (-0.5, 0.3)):
        np.testing.assert_array_equal(
            tcp.apply_xy_translation_3d(_t(img), tx, ty).numpy(),
            np.asarray(jcp.apply_xy_translation_3d(jnp.asarray(img), tx, ty)))


@pytest.mark.parametrize("angle", [10.0, -22.5])
def test_rotation_3d_is_pillow_and_near_jax(rng, angle):
    img = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    got = tcp.apply_rotation_3d(_t(img), angle).numpy()
    pil = np.stack([np.asarray(Image.fromarray(im).rotate(-angle, Image.NEAREST)) for im in img])
    np.testing.assert_array_equal(got, pil)
    want = np.asarray(jcp.apply_rotation_3d(jnp.asarray(img), angle))
    assert (got != want).any(axis=-1).mean() <= 0.005
