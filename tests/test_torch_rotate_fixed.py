"""The port's NEAREST rotation against Pillow, a numpy integer model and JAX.

The reference's apply_rotation is Pillow's ``Image.rotate(-a, NEAREST)``,
which maps NEAREST affine transforms in 16.16 fixed point (its f64 path
where a corner coordinate reaches 32768). The port computes the same
integers (``rotate_gather.pil_rotate_coeffs``) and the same gather, so
every case here holds it to Pillow at 0 LSB:

- ``pil_rotate_coeffs`` against a numpy model of Pillow's coefficients,
  built here from the JAX package's f64 oracle matrix;
- the plain rotation against Pillow on modes L / RGB / RGBA, odd and tiny
  shapes, grid and other angles, and the f64 path at 2x40000;
- ``apply_rotation``, the CPU ``apply_all_transformations(...,
  pil_parity_rotation=True)`` and a strict ``blur>rotation>grayscale``
  chain's rotation stage.

Against the JAX package (CPU backend; its kernel in interpret mode), whose
f32 coordinates are not Pillow's: <= 0.5% of an image's pixels for
|a| <= 45, <= 2.5% beyond (measured: up to 2.35% at 5x17 +-60 degrees and
23x37 -60; ROADMAP C.2.9).
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from imagetransformations_tpu.oracle import warp as oww
from imagetransformations_tpu.ops import warp as jwp

import imagetransformations_tpu_torch as port
from imagetransformations_tpu_torch.core import grids
from imagetransformations_tpu_torch.ops import elementwise as ew
from imagetransformations_tpu_torch.ops import stencil as st
from imagetransformations_tpu_torch.ops.hopper import rotate_gather as rg
from imagetransformations_tpu_torch.pipeline import batch as pbatch

GRID = [-22.5 + 2.5 * i for i in range(19)]
#: the grid, its edges and beyond, wrap-around and a value off the grid (f32)
ANGLES = GRID + [45.0, -45.0, 60.0, -60.0, 90.0, 135.0, -135.0, 179.0, 180.0, -180.0, 390.0,
                 float(np.float32(13.37))]
MODES = {1: "L", 3: "RGB", 4: "RGBA"}
JAX_BUDGET_45, JAX_BUDGET_BEYOND = 0.005, 0.025


def _pil(im, a, fill=None):
    """Pillow's rotate(-a, NEAREST) of one HWC u8 image (c = 1, 3 or 4)."""
    c = im.shape[-1]
    src = Image.fromarray(im[..., 0] if c == 1 else im, MODES[c])
    out = np.asarray(src.rotate(-float(a), resample=Image.NEAREST, fillcolor=fill))
    return out.reshape(im.shape)


def _model_coeffs(a, w, h):
    """Pillow's coefficients in numpy: FIX = floor(v * 65536 + 0.5) of the
    oracle's f64 matrix (a2 / a5 with the half-pixel terms), the corners'
    check_fixed, and the f64 path's start and steps."""
    m = np.asarray(oww.pil_rotate_matrix(-a, w, h), np.float64)
    fix = lambda v: np.int64(np.floor(v * 65536.0 + 0.5))
    fixed = [fix(m[0]), fix(m[1]), fix(m[2] + m[0] * 0.5 + m[1] * 0.5),
             fix(m[3]), fix(m[4]), fix(m[5] + m[3] * 0.5 + m[4] * 0.5)]
    corners = np.asarray([(0, 0), (w, h), (0, h), (w, 0)], np.float64)
    cx = corners[:, 0] * m[0] + corners[:, 1] * m[1] + m[2]
    cy = corners[:, 0] * m[3] + corners[:, 1] * m[4] + m[5]
    flagged = not ((np.abs(cx) < 32768.0).all() and (np.abs(cy) < 32768.0).all())
    start = (m[2] + m[1] * 0.5 + m[0] * 0.5, m[5] + m[4] * 0.5 + m[3] * 0.5)
    return np.asarray(fixed, np.int64), flagged, start, (m[0], m[3], m[1], m[4])


def _model_rotate(im, a, fill=0):
    """The fixed-point gather in numpy int64 from ``_model_coeffs``."""
    h, w, _ = im.shape
    k, flagged, _, _ = _model_coeffs(a, w, h)
    assert not flagged
    ys, xs = np.mgrid[0:h, 0:w].astype(np.int64)
    xin = (k[2] + ys * k[1] + xs * k[0]) >> 16
    yin = (k[5] + ys * k[4] + xs * k[3]) >> 16
    ok = (xin >= 0) & (xin < w) & (yin >= 0) & (yin < h)
    out = np.full_like(im, fill)
    out[ok] = im[yin[ok], xin[ok]]
    return out


@pytest.mark.parametrize("w,h", [(5, 17), (37, 23), (48, 64), (60, 100), (1, 1), (1, 5),
                                 (40000, 2), (3, 70000)])
def test_pil_rotate_coeffs_match_the_numpy_model(w, h):
    co = rg.pil_rotate_coeffs(np.asarray(ANGLES, np.float32), w, h)
    assert co.fixed.dtype == np.int32 and co.fixed.shape == (len(ANGLES), 6)
    for i, a in enumerate(np.asarray(ANGLES, np.float32)):
        fixed, flagged, start, step = _model_coeffs(float(a), w, h)
        assert bool(co.flagged[i]) == flagged, a
        if not flagged:
            np.testing.assert_array_equal(co.fixed[i], fixed, err_msg=str(a))
        np.testing.assert_array_equal(co.start[i], start)
        np.testing.assert_array_equal(co.step[i], step)
    # an f32 angle is its exact f64 value; Python floats are taken as they are
    a = np.float32(0.1)
    assert rg.pil_rotate_coeffs(a, 64, 48).fixed.tolist() == \
        rg.pil_rotate_coeffs(float(a), 64, 48).fixed.tolist()
    with pytest.raises(ValueError, match="finite"):
        rg.pil_rotate_coeffs([np.nan], 8, 8)


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("h,w", [(17, 5), (23, 37), (64, 48), (100, 60), (1, 1), (5, 1)])
def test_plain_rotation_equals_pillow(rng, h, w, c):
    """One angle an image over ANGLES: Pillow and the numpy model, 0 LSB."""
    imgs = rng.integers(0, 256, (len(ANGLES), h, w, c), dtype=np.uint8)
    a = np.asarray(ANGLES, np.float32)
    out = rg.pil_rotate_nearest_batched(torch.from_numpy(imgs), a).numpy()
    assert out.shape == imgs.shape and out.dtype == np.uint8
    for i, ang in enumerate(a):
        np.testing.assert_array_equal(out[i], _pil(imgs[i], ang), err_msg=str(ang))
        np.testing.assert_array_equal(out[i], _model_rotate(imgs[i], float(ang)))


def test_float_path_equals_pillow(rng):
    """2x40000: every corner check fails, Pillow takes its f64 adds; the
    fixed-point rule alone would differ there (at 7 and 180 degrees)."""
    h, w = 2, 40000
    a = np.asarray([7.0, 180.0, -30.0], np.float32)
    imgs = rng.integers(0, 256, (3, h, w, 1), dtype=np.uint8)
    co = rg.pil_rotate_coeffs(a, w, h)
    assert co.flagged.all()
    out = rg.pil_rotate_nearest_batched(torch.from_numpy(imgs), a).numpy()
    fixed_only = rg.pil_rotate_nearest_plain(torch.from_numpy(imgs), torch.from_numpy(co.fixed),
                                             0).numpy()
    for i, ang in enumerate(a):
        want = _pil(imgs[i], ang)
        np.testing.assert_array_equal(out[i], want, err_msg=str(ang))
        if ang != -30.0:
            assert (fixed_only[i] != want).any(), ang


def test_fill_and_one_angle_for_the_batch(rng):
    imgs = rng.integers(0, 256, (3, 20, 28, 3), dtype=np.uint8)
    out = rg.pil_rotate_nearest_batched(torch.from_numpy(imgs), 30.0, fill=200).numpy()
    for i in range(3):
        np.testing.assert_array_equal(out[i], _pil(imgs[i], 30.0, fill=(200, 200, 200)))
    for angles in ([30.0, 30.0], np.zeros(4, np.float32)):
        with pytest.raises(ValueError, match="angle"):
            rg.pil_rotate_nearest_batched(torch.from_numpy(imgs), angles)


@pytest.mark.parametrize("h,w", [(32, 32), (37, 53)])
def test_against_jax_within_the_measured_budgets(rng, h, w):
    """JAX ``apply_rotation`` (its kernel within 45 degrees, its f32 warp
    beyond): <= 0.5% of pixels an image for |a| <= 45, <= 2.5% beyond."""
    angles = [-22.5, -10.0, 7.5, 22.5, 45.0, -45.0, 60.0, -60.0, 90.0, 135.0, -135.0, 179.0]
    imgs = rng.integers(0, 256, (1, h, w, 3), dtype=np.uint8)
    x = torch.from_numpy(imgs)
    for a in angles:
        out = port.apply_rotation(x, a).numpy()
        np.testing.assert_array_equal(out[0], _pil(imgs[0], a))
        want = np.asarray(jwp.apply_rotation(jnp.asarray(imgs), a))
        flips = (out != want).any(-1).mean()
        assert flips <= (JAX_BUDGET_45 if abs(a) <= 45 else JAX_BUDGET_BEYOND), (a, flips)


def test_apply_rotation_scalar_array_and_hwc_equal_pillow(rng):
    imgs = rng.integers(0, 256, (2, 23, 37, 4), dtype=np.uint8)
    x = torch.from_numpy(imgs)
    a = np.asarray([-60.0, 135.0], np.float32)
    arr = port.apply_rotation(x, a)
    for i in range(2):
        assert torch.equal(arr[i], port.apply_rotation(x[i], float(a[i])))
        np.testing.assert_array_equal(arr[i].numpy(), _pil(imgs[i], a[i]))
    assert torch.equal(port.apply_rotation(x, torch.from_numpy(a)), arr)


def test_apply_all_pil_rotation_equals_pillow(rng):
    """The sweep's PIL rotation (one grid angle an image, each image's
    coefficient row gathered by its drawn index) on the angles it drew."""
    imgs = rng.integers(0, 256, (12, 24, 28, 3), dtype=np.uint8)
    res = port.apply_all_transformations(imgs, 5, types=("rotation",), pil_parity_rotation=True,
                                         device="cpu")
    values, out = res["rotation"]
    assert len(set(values.tolist())) > 3
    for i, v in enumerate(values.tolist()):
        np.testing.assert_array_equal(out[i].numpy(), _pil(imgs[i], v))


def test_apply_per_value_rotation_takes_any_values_exactly(rng):
    """The per-value PIL rotation computes each value's own coefficients,
    so values off the rotation grid (and past 45 degrees) rotate exactly."""
    imgs = rng.integers(0, 256, (4, 21, 30, 3), dtype=np.uint8)
    vals = np.asarray([13.37, -1.25, 60.0, 13.37], np.float32)
    out = pbatch._apply_per_value(torch.from_numpy(imgs), "rotation_pil", torch.from_numpy(vals))
    for i, v in enumerate(vals):
        np.testing.assert_array_equal(out[i].numpy(), _pil(imgs[i], v), err_msg=str(v))


def test_sample_indices_draw_what_sample_params_draws():
    """The sweep's rotation takes the drawn grid indices: the same draws,
    and the values the indices name."""
    for name in ("rotation", "scale"):
        idx, vals = grids.sample_indices(torch.Generator().manual_seed(3), name, 64)
        assert torch.equal(vals, grids.sample_params(torch.Generator().manual_seed(3), name, 64))
        assert torch.equal(vals, torch.from_numpy(grids.PARAM_GRIDS[name].values())[idx])


@pytest.mark.parametrize("angle", [15.0, -60.0, 135.0])
def test_strict_chain_rotation_stage_equals_pillow(rng, angle):
    """strict blur > rotation > grayscale: the rotation stage is Pillow's on
    the port's blur, and the chain is grayscale of it."""
    imgs = rng.integers(0, 256, (2, 30, 26, 3), dtype=np.uint8)
    chain = [port.OpSpec("blur", {"radius": 1.5}), port.OpSpec("rotation", {"angle": angle}),
             port.OpSpec("grayscale")]
    out = port.build_chain_fn(chain, strict_parity=True, device="cpu")(imgs)
    blurred = st.apply_blur(torch.from_numpy(imgs), 1.5).numpy()
    rotated = np.stack([_pil(b, angle) for b in blurred])
    assert torch.equal(out, ew.grayscale(torch.from_numpy(rotated)))
