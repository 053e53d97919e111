"""The port's warps and their kernels' plain versions against the JAX package.

- ``shear_rows_logrouted`` (kernel #9's plain version) against the numpy
  oracle ``oracle/fast_warp.shear_rows`` and the JAX Pallas kernel
  (interpret mode): 0 LSB, saturation and all-fill cases included.
- ``zoom_bilinear_batched`` (kernel #10) against the JAX kernel and the f64
  oracle ``affine_bilinear(zoom_matrix)``: <= 1 LSB on <= 1% of values (the
  JAX side FMA-contracts the coordinates on XLA-CPU; the oracle is f64).
- ``pil_rotate_nearest_batched`` (kernel #12) against PIL's ``rotate(-a)``
  at 0 LSB (Pillow's 16.16 fixed point, as the port computes it), and
  against the JAX kernel and ``oracle/warp.apply_rotation`` (f32 / f64
  coordinates, not Pillow's): <= 0.5% of pixels differ (<= 1% for the JAX
  kernel at +-45 degrees).
- the matrices, ``affine_warp`` and the public ops ``apply_rotation``,
  ``random_zoom`` and ``apply_shear`` against their JAX counterparts.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from imagetransformations_tpu.core.grids import PARAM_GRIDS as JGRIDS
from imagetransformations_tpu.oracle import fast_warp as ofw
from imagetransformations_tpu.oracle import warp as oww
from imagetransformations_tpu.ops import warp as jwp
from imagetransformations_tpu.ops.pallas import resample as jrs
from imagetransformations_tpu.ops.pallas import rotate_gather as jrg
from imagetransformations_tpu.ops.pallas import shear as jsh

import imagetransformations_tpu_torch as port
from imagetransformations_tpu_torch.ops import warp as twp
from imagetransformations_tpu_torch.ops.hopper import _lib
from imagetransformations_tpu_torch.ops.hopper import resample as trs
from imagetransformations_tpu_torch.ops.hopper import rotate_gather as trg
from imagetransformations_tpu_torch.ops.hopper import shear as tsh

ROTATION_GRID = np.asarray(JGRIDS["rotation"].values(), np.float32)
# the scale grid and the fast scale's budget bounds (grid min/max -+ 0.05)
ZOOM_FACTORS = np.asarray([*JGRIDS["scale"].values(), 0.85, 1.45], np.float32)


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def _lsb(a, b):
    err = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
    return err.max(), (err > 0).mean()


def _pil(im, a):
    return np.asarray(Image.fromarray(im).rotate(-float(a), fillcolor=(0, 0, 0)))


# ---------------------------------------------------------------- matrices


@pytest.mark.parametrize("w,h", [(32, 32), (53, 37), (48, 64), (512, 512)])
def test_rotation_matrix_matches_jax(w, h):
    """Grid angles and +-45: 0 ulp against both JAX paths (numpy for host
    angles, XLA for traced). Off the grid, f32 sin may differ by 1 ulp
    between libraries (60 degrees); m2 and m5 cancel and carry that to up
    to 8 ulp (48x64), so they are held to the JAX op order instead: from
    JAX's own cos and sin the port's formula gives JAX's m2 and m5 exactly."""
    grid = np.concatenate([ROTATION_GRID, [45.0, -45.0]]).astype(np.float32)
    got = twp.rotation_matrix(grid, w, h).numpy()
    assert got.shape == (len(grid), 6) and got.dtype == np.float32
    assert _ulps(got, jwp.rotation_matrix(grid, w, h)).max() == 0
    assert _ulps(got, jwp.rotation_matrix(jnp.asarray(grid), w, h)).max() == 0

    off = np.asarray([60.0, 90.0, -60.0, 7.3, 137.0], np.float32)
    got = twp.rotation_matrix(off, w, h).numpy()
    want = np.asarray(jwp.rotation_matrix(off, w, h))
    assert _ulps(got[:, [0, 1, 3, 4]], want[:, [0, 1, 3, 4]]).max() <= 1
    m0, m1, m3, m4 = (torch.from_numpy(want[:, k]) for k in (0, 1, 3, 4))
    cx, cy = w / 2.0, h / 2.0
    assert _ulps((m0 * (-cx) + m1 * (-cy)) + cx, want[:, 2]).max() == 0
    assert _ulps((m3 * (-cx) + m4 * (-cy)) + cy, want[:, 5]).max() == 0
    assert np.array_equal(twp.rotation_matrix(12.5, w, h).numpy(),
                          np.asarray(jwp.rotation_matrix(12.5, w, h)))


def test_zoom_translation_and_composed_matrices_match_jax():
    f = np.asarray([*ZOOM_FACTORS, 0.5, 4.0, 0.3], np.float32)
    for w, h in ((32, 32), (53, 37)):
        got = twp.zoom_matrix(f, w, h).numpy()
        assert _ulps(got, jwp.zoom_matrix(f, w, h)).max() == 0
        assert _ulps(got, jwp.zoom_matrix(jnp.asarray(f), w, h)).max() == 0
    tx, ty = np.asarray([3.7, -2.2, 0.0], np.float32), np.float32(-5.5)
    assert np.array_equal(twp.translation_matrix(tx, ty).numpy(),
                          np.asarray(jwp.translation_matrix(tx, ty)))
    a = twp.rotation_matrix(np.asarray([30.0, -10.0], np.float32), 40, 30)
    b = twp.zoom_matrix(np.asarray([1.2, 0.9], np.float32), 40, 30)
    want = jwp.compose_matrices(jnp.asarray(a.numpy()), jnp.asarray(b.numpy()))
    assert _ulps(twp.compose_matrices(a, b), want).max() == 0


def test_host_matrix_helpers_equal_oracle():
    for a in (-60.0, 0.0, 12.5, 90.0, 361.0):
        assert twp.pil_rotate_matrix(a, 53, 37) == oww.pil_rotate_matrix(a, 53, 37)
    for s in (-0.2, 0.0, 0.3, 1.0):
        assert twp.shear_matrix(s, 40) == oww.shear_matrix(s, 40)
        assert twp.shear_out_width(s, 24, 40) == oww.shear_out_width(s, 24, 40)


# ---------------------------------------------------------------- #9 row shift


def _shear_oracle(imgs, shifts, fill):
    return np.concatenate([ofw.shear_rows(imgs[i : i + 1], shifts[i], fill=fill)
                           for i in range(len(imgs))])


@pytest.mark.parametrize("shape,fill", [((3, 64, 48, 3), 255), ((2, 37, 53, 3), 0),
                                        ((4, 32, 32, 1), 128)])
def test_shear_rows_matches_oracle_and_jax_kernel(rng, shape, fill):
    """Uniform random shifts within the budget: 0 LSB against the numpy
    oracle and the JAX kernel, border fill-lerps included."""
    imgs = rng.integers(0, 256, shape, dtype=np.uint8)
    shifts = rng.uniform(-20, 20, shape[:2]).astype(np.float32)
    out = tsh.shear_rows_logrouted(torch.from_numpy(imgs), torch.from_numpy(shifts), fill=fill,
                                   max_shift_px=22).numpy()
    assert out.shape == imgs.shape and out.dtype == np.uint8
    assert np.array_equal(out, _shear_oracle(imgs, shifts, fill))
    want = jsh.shear_rows_logrouted(jnp.asarray(imgs), jnp.asarray(shifts), fill=fill,
                                    max_shift_px=22)
    assert np.array_equal(out, np.asarray(want))


def test_shear_rows_saturation_and_all_fill(rng):
    """Shifts beyond max_shift_px saturate at b_px = bound + 1 (bound 4,
    shift -12 -> -5); a shift beyond the canvas gives fill everywhere.
    Both 0 LSB against the JAX kernel."""
    imgs = rng.integers(0, 256, (1, 16, 24, 3), dtype=np.uint8)
    shifts = np.zeros((1, 16), np.float32)
    shifts[0, :8], shifts[0, 8:] = 3.0, -12.0
    out = tsh.shear_rows_logrouted(torch.from_numpy(imgs), shifts, fill=255, max_shift_px=4)
    sat = shifts.copy()
    sat[0, 8:] = -5.0
    assert np.array_equal(out.numpy(), ofw.shear_rows(imgs, sat[0], fill=255))
    want = jsh.shear_rows_logrouted(jnp.asarray(imgs), jnp.asarray(shifts), fill=255,
                                    max_shift_px=4)
    assert np.array_equal(out.numpy(), np.asarray(want))

    far = np.full((1, 16), 100.0, np.float32)
    out = tsh.shear_rows_logrouted(torch.from_numpy(imgs[:, :, :16]), far, fill=255,
                                   max_shift_px=101)
    assert (out.numpy() == 255).all()
    want = jsh.shear_rows_logrouted(jnp.asarray(imgs[:, :, :16]), jnp.asarray(far), fill=255,
                                    max_shift_px=101)
    assert np.array_equal(out.numpy(), np.asarray(want))


def test_shear_rows_bound_from_numpy_shifts_and_errors(rng):
    """max_shift_px=None takes ceil(max|s|) + 1 of numpy shifts, as the JAX
    docstring and code say (under its own jit the JAX function sees numpy
    shifts as traced and raises, so it is given that bound here); tensor
    shifts need the bound. One row of shifts serves the whole batch."""
    imgs = rng.integers(0, 256, (2, 12, 20, 3), dtype=np.uint8)
    shifts = rng.uniform(-6, 6, (1, 12)).astype(np.float32)
    out = tsh.shear_rows_logrouted(torch.from_numpy(imgs), shifts, fill=7).numpy()
    bound = int(np.ceil(np.abs(shifts).max())) + 1
    with pytest.raises(ValueError, match="max_shift_px"):
        jsh.shear_rows_logrouted(jnp.asarray(imgs), shifts, fill=7)
    want = jsh.shear_rows_logrouted(jnp.asarray(imgs), np.broadcast_to(shifts, (2, 12)), fill=7,
                                    max_shift_px=bound)
    assert np.array_equal(out, np.asarray(want))
    with pytest.raises(ValueError, match="max_shift_px"):
        tsh.shear_rows_logrouted(torch.from_numpy(imgs), torch.from_numpy(shifts))
    with pytest.raises(ValueError, match="u8"):
        tsh.shear_rows_logrouted(torch.from_numpy(imgs), shifts, fill=300)


# ---------------------------------------------------------------- #10 zoom


def _zoom_f32(imgs, factors):
    """The JAX kernels' zoom (resample.py ``_coords``, H pass, V pass) in
    numpy f32, every op rounded on its own."""
    f32 = np.float32
    out = np.empty_like(imgs)
    h, w = imgs.shape[1:3]
    for i, f in enumerate(factors):
        inv = f32(1.0) / f32(f)

        def axis(dim):
            pos = np.arange(dim, dtype=f32) + f32(0.5)
            half = f32(dim / 2.0)
            src = inv * pos + (half - inv * half)
            sm = src - f32(0.5)
            s0 = np.floor(sm)
            return (np.clip(s0, 0, dim - 1).astype(int), np.clip(s0 + 1, 0, dim - 1).astype(int),
                    sm - s0, (src >= 0) & (src < dim))

        x0, x1, fx, vx = axis(w)
        y0, y1, fy, vy = axis(h)
        v = imgs[i].astype(f32)

        def hpass(rows):
            a, b = v[rows][:, x0], v[rows][:, x1]
            return np.where(vx[None, :, None], a + fx[None, :, None] * (b - a), f32(0.0))

        top, bot = hpass(y0), hpass(y1)
        o = np.clip(np.trunc(top + fy[:, None, None] * (bot - top)), 0, 255)
        out[i] = np.where(vy[:, None, None], o, 0).astype(np.uint8)
    return out


@pytest.mark.parametrize("shape", [(8, 64, 48, 3), (8, 32, 32, 3)])
def test_zoom_bilinear_matches_jax_kernel_and_oracle(rng, shape):
    """The scale grid and the budget bounds 0.85/1.45: 0 LSB against the JAX
    kernels' arithmetic in numpy f32; <= 1 LSB on <= 1% of values against
    the JAX kernel (XLA-CPU contracts m = half - inv*half and src = inv*pos
    + m into FMAs) and against the f64 oracle."""
    imgs = rng.integers(0, 256, shape, dtype=np.uint8)
    out = trs.zoom_bilinear_batched(torch.from_numpy(imgs), ZOOM_FACTORS).numpy()
    assert out.shape == imgs.shape and out.dtype == np.uint8
    assert np.array_equal(out, _zoom_f32(imgs, ZOOM_FACTORS))
    want = np.asarray(jrs.zoom_bilinear_batched(jnp.asarray(imgs), jnp.asarray(ZOOM_FACTORS)))
    lsb, frac = _lsb(out, want)
    assert lsb <= 1 and frac <= 0.01, (lsb, frac)
    h, w = shape[1:3]
    ref = np.stack([oww.affine_bilinear(imgs[i], np.asarray(jwp.zoom_matrix(float(f), w, h),
                                                            np.float64)[0])
                    for i, f in enumerate(ZOOM_FACTORS)])
    lsb, frac = _lsb(out, ref)
    assert lsb <= 1 and frac <= 0.01, (lsb, frac)


def test_zoom_bilinear_odd_width_no_farther_from_f64_than_jax(rng):
    """An odd, non-square shape (w * c not a multiple of 128: the JAX
    kernel pads lanes the clamped taps never read). Against the JAX kernel
    <= 1 LSB on <= 1%. Against the f64 oracle both f32 kernels lose more
    here (factor 1.2 lands many source coordinates on dyadic fractions
    that f32 rounds just below); the port must be no farther from it than
    the JAX kernel is."""
    imgs = rng.integers(0, 256, (8, 37, 53, 3), dtype=np.uint8)
    out = trs.zoom_bilinear_batched(torch.from_numpy(imgs), ZOOM_FACTORS).numpy()
    assert np.array_equal(out, _zoom_f32(imgs, ZOOM_FACTORS))
    want = np.asarray(jrs.zoom_bilinear_batched(jnp.asarray(imgs), jnp.asarray(ZOOM_FACTORS)))
    lsb, frac = _lsb(out, want)
    assert lsb <= 1 and frac <= 0.01, (lsb, frac)
    ref = np.stack([oww.affine_bilinear(imgs[i], np.asarray(jwp.zoom_matrix(float(f), 53, 37),
                                                            np.float64)[0])
                    for i, f in enumerate(ZOOM_FACTORS)])
    lsb, frac = _lsb(out, ref)
    lsb_jax, frac_jax = _lsb(want, ref)
    assert lsb <= 1 and frac <= frac_jax, (lsb, frac, frac_jax)


def test_zoom_kernel_route_equals_the_bilinear_warp(rng):
    """The kernel's per-axis coordinates are the bilinear warp's of
    zoom_matrix with the zero terms dropped, every op rounded alike: the
    two routes of random_zoom give the same bits."""
    imgs = torch.from_numpy(rng.integers(0, 256, (8, 37, 53, 3), dtype=np.uint8))
    out = trs.zoom_bilinear_batched(imgs, ZOOM_FACTORS)
    warp = twp.affine_warp(imgs, twp.zoom_matrix(ZOOM_FACTORS, 53, 37), method="bilinear")
    assert torch.equal(out, warp)


# ---------------------------------------------------------------- #12 rotation


@pytest.mark.parametrize(
    "shape,angles",
    [
        ((4, 32, 32), [-20.0, 0.0, 10.0, 22.5]),
        ((2, 37, 53), [7.0, -44.0]),  # odd, non-square
        ((1, 96, 64), [22.5]),
        ((3, 40, 24), [-7.5, 2.5, 17.5]),
    ],
)
def test_pil_rotate_nearest_matches_jax_pil_and_oracle(rng, shape, angles):
    """0 pixels differ from PIL; <= 0.5% in each image against the JAX
    kernel (f32 coordinates; its roll routing may move a floor tie to a
    neighbour) and the f64 oracle (direct f64 evaluation, not PIL's fixed
    point)."""
    n, h, w = shape
    imgs = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    a = np.asarray(angles, np.float32)
    out = trg.pil_rotate_nearest_batched(torch.from_numpy(imgs), a).numpy()
    assert out.shape == imgs.shape and out.dtype == np.uint8
    want = np.asarray(jrg.pil_rotate_nearest_batched(jnp.asarray(imgs), jnp.asarray(a)))
    for i, ang in enumerate(a):
        np.testing.assert_array_equal(out[i], _pil(imgs[i], ang), err_msg=str(ang))
        for ref in (want[i], oww.apply_rotation(imgs[i], float(ang))):
            assert (out[i] != ref).any(-1).mean() <= 0.005, (i, ang)


def test_pil_rotate_nearest_at_45_degrees(rng):
    """+-45 degrees on even sizes puts many source coordinates on exact
    pixel edges: PIL's fixed point decides them, and the port equals PIL
    (0 pixels differ); the JAX kernel (whose routing moves ties to
    neighbours, <= 1% by its own bounds check) stays within 1% of it; the
    f64 oracle is the odd one out there (direct f64 evaluation, not PIL's
    incremental one: 1.8% of pixels at 32x32)."""
    imgs = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    a = np.asarray([45.0, -45.0], np.float32)
    out = trg.pil_rotate_nearest_batched(torch.from_numpy(imgs), a).numpy()
    want = np.asarray(jrg.pil_rotate_nearest_batched(jnp.asarray(imgs), jnp.asarray(a)))
    for i, ang in enumerate(a):
        np.testing.assert_array_equal(out[i], _pil(imgs[i], ang), err_msg=str(ang))
        assert (out[i] != want[i]).any(-1).mean() <= 0.01, ang


def test_pil_rotate_nearest_fill_and_one_angle_for_the_batch(rng):
    """One angle for the batch and fill 200: PIL's rotate with that
    fillcolor (0 LSB), the JAX kernel (<= 0.5% of values)."""
    imgs = rng.integers(0, 256, (3, 20, 28, 1), dtype=np.uint8)
    out = trg.pil_rotate_nearest_batched(torch.from_numpy(imgs), 30.0, fill=200)
    want = jrg.pil_rotate_nearest_batched(jnp.asarray(imgs), jnp.asarray(30.0, jnp.float32),
                                          fill=200)
    assert (out.numpy() != np.asarray(want)).mean() <= 0.005
    assert (out.numpy()[:, 0, 0] == 200).all()  # a corner maps outside the image
    for i in range(3):
        pil = Image.fromarray(imgs[i, ..., 0]).rotate(-30.0, fillcolor=200)
        np.testing.assert_array_equal(out.numpy()[i, ..., 0], np.asarray(pil))
    with pytest.raises(ValueError, match="u8"):
        trg.pil_rotate_nearest_batched(torch.from_numpy(imgs), 30.0, fill=-1)


# ---------------------------------------------------------------- affine_warp


def _matrices(w, h):
    rot = np.asarray(jwp.rotation_matrix(33.0, w, h), np.float32)[0]
    zoom = np.asarray(jwp.zoom_matrix(1.3, w, h), np.float32)[0]
    shear = np.asarray(oww.shear_matrix(0.4, h), np.float32)
    both = np.array(jwp.compose_matrices(jnp.asarray(rot), jnp.asarray(zoom)))[0]
    return {"rotation": rot, "zoom": zoom, "shear": shear, "composed": both}


@pytest.mark.parametrize("method", ["nearest", "bilinear", "bicubic"])
def test_affine_warp_matches_oracle_and_jax(rng, method):
    """Against JAX's affine_warp on the same f32 matrix: nearest <= 0.5% of
    pixels, bilinear and bicubic <= 1 LSB on <= 1% of values. Against the
    f64 oracles: nearest <= 0.5% of pixels, bilinear and bicubic <= 1 LSB
    and no more values off than JAX's own warp (for the 0.4 shear the
    weights fall on fifths, which f32 cannot hold: 14.5% (bilinear) and
    8.2% (bicubic) of values sit 1 LSB off in both packages; <= 1% for the
    others)."""
    imgs = rng.integers(0, 256, (2, 37, 53, 3), dtype=np.uint8)
    oracle = {"nearest": oww.affine_nearest, "bilinear": oww.affine_bilinear,
              "bicubic": oww.affine_bicubic}[method]
    for name, m in _matrices(53, 37).items():
        out = twp.affine_warp(torch.from_numpy(imgs), torch.from_numpy(m), method=method,
                              fill=9.0).numpy()
        want = np.asarray(jwp.affine_warp(jnp.asarray(imgs), jnp.asarray(m), method=method,
                                          fill=9.0))
        ref = np.stack([oracle(im, m.astype(np.float64), fill=9) for im in imgs])
        if method == "nearest":
            assert (out != want).any(-1).mean() <= 0.005, name
            assert (out != ref).any(-1).mean() <= 0.005, name
            continue
        lsb, frac = _lsb(out, want)
        assert lsb <= 1 and frac <= 0.01, (name, lsb, frac)
        lsb, frac = _lsb(out, ref)
        budget = _lsb(want, ref)[1] if name == "shear" else 0.01
        assert lsb <= 1 and frac <= budget, (name, lsb, frac)


def test_affine_warp_float_input_out_size_and_batch_matrices(rng):
    """Float images stay f32 and unquantized; out_size widens the canvas;
    one matrix an image. Against JAX: within 1e-3 (FMA on the JAX side)."""
    imgs = rng.random((2, 20, 24, 3), dtype=np.float32) * 255
    m = np.stack([np.asarray(jwp.rotation_matrix(a, 24, 20), np.float32)[0]
                  for a in (15.0, -70.0)])
    for method in ("nearest", "bilinear", "bicubic"):
        out = twp.affine_warp(torch.from_numpy(imgs), torch.from_numpy(m),
                              out_size=(20, 30), method=method)
        assert out.dtype == torch.float32 and out.shape == (2, 20, 30, 3)
        want = np.asarray(jwp.affine_warp(jnp.asarray(imgs), jnp.asarray(m), out_size=(20, 30),
                                          method=method))
        close = np.isclose(out.numpy(), want, atol=1e-3)
        assert close.mean() >= 0.995, method  # nearest: floor boundary flips
    one = twp.affine_warp(torch.from_numpy(imgs[0]), torch.from_numpy(m[0]), method="bilinear")
    assert one.shape == (20, 24, 3)
    with pytest.raises(ValueError, match="method"):
        twp.affine_warp(torch.from_numpy(imgs), torch.from_numpy(m), method="area")


# ---------------------------------------------------------------- public ops


def test_apply_rotation_routes_like_jax(rng):
    """u8 at any angle, static or array, runs Pillow's fixed-point gather:
    the scalar route equals the array route equals PIL (0 LSB). Against
    JAX (its kernel within 45 degrees, its f32 warp beyond): <= 0.5% of
    pixels for |angle| <= 45, <= 2.5% beyond (ROADMAP C.2.9)."""
    imgs = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    x = torch.from_numpy(imgs)
    cases = [12.5, np.asarray([-22.5, 17.5], np.float32), 90.0, -60.0,
             np.asarray([90.0, -60.0], np.float32)]
    for angle in cases:
        out = port.apply_rotation(x, angle).numpy()
        want = np.asarray(jwp.apply_rotation(jnp.asarray(imgs), angle))
        a = np.broadcast_to(np.asarray(angle, np.float32), (2,))
        for i in range(2):
            budget = 0.005 if abs(float(a[i])) <= 45 else 0.025
            assert (out[i] != want[i]).any(-1).mean() <= budget, angle
            np.testing.assert_array_equal(out[i], _pil(imgs[i], a[i]), err_msg=str(angle))
            scalar = port.apply_rotation(x[i : i + 1], float(a[i])).numpy()[0]
            np.testing.assert_array_equal(out[i], scalar, err_msg=str(angle))
    assert torch.equal(port.apply_rotation(x[0], 12.5), port.apply_rotation(x, 12.5)[0])


def test_apply_rotation_budget_routes_only_within_45(rng, monkeypatch):
    """Which route runs: the gather for every u8 call, whatever the angle
    or the budget (it needs none); the warp for a float image."""
    imgs = torch.from_numpy(rng.integers(0, 256, (1, 16, 16, 3), dtype=np.uint8))
    calls = []
    real = twp.pil_rotate_nearest_batched
    monkeypatch.setattr(twp, "pil_rotate_nearest_batched",
                        lambda x, a, *r, **k: calls.append(float(a)) or real(x, a, *r, **k))
    twp.apply_rotation(imgs, 10.0)
    twp.apply_rotation(imgs, 10.0, max_angle_deg=20.0)
    twp.apply_rotation(imgs, 30.0, max_angle_deg=20.0)
    twp.apply_rotation(imgs, 10.0, max_angle_deg=50.0)
    twp.apply_rotation(imgs, 135.0)
    twp.apply_rotation(imgs.float(), 10.0)
    assert calls == [10.0, 10.0, 30.0, 10.0, 135.0]


def test_random_zoom_routes_like_jax(rng):
    """In-range Python factors run the kernel; 0.3 and array factors take
    the bilinear warp. Against JAX <= 1 LSB on <= 1% of all values (one
    factor alone can reach 3%: 1.2 at 37x53 puts many coordinates on
    dyadic fractions, where XLA's FMA and the unfused f32 round apart)."""
    imgs = rng.integers(0, 256, (2, 37, 53, 3), dtype=np.uint8)
    x = torch.from_numpy(imgs)
    errs = []
    for factor in (1.2, 0.9, 0.3, 4.0, 1.45, np.asarray([1.1, 1.3], np.float32)):
        out = port.random_zoom(x, factor).numpy()
        want = np.asarray(jwp.random_zoom(jnp.asarray(imgs), factor))
        errs.append(np.abs(out.astype(int) - want.astype(int)))
    errs = np.stack(errs)
    assert errs.max() <= 1 and (errs > 0).mean() <= 0.01, (errs > 0).mean()
    before = dict(_lib.LAUNCHES)
    assert torch.equal(port.random_zoom(x, 1.2),
                       twp.affine_warp(x, twp.zoom_matrix(1.2, 53, 37), method="bilinear"))
    assert _lib.LAUNCHES == before  # the CPU runs the plain versions: no launch counted


@pytest.mark.parametrize("factor", [0.0, 0.3, 0.7, 1.0, -0.2])
def test_apply_shear_matches_jax(rng, factor):
    """Widened canvas, BICUBIC, white fill: <= 1 LSB on <= 1% of values
    against the JAX op (the same f32 op order; XLA-CPU may contract FMAs)."""
    imgs = rng.integers(0, 256, (2, 24, 20, 3), dtype=np.uint8)
    out = port.apply_shear(torch.from_numpy(imgs), factor).numpy()
    want = np.asarray(jwp.apply_shear(jnp.asarray(imgs), factor))
    assert out.shape == want.shape
    lsb, frac = _lsb(out, want)
    assert lsb <= 1 and frac <= 0.01, (lsb, frac)


def test_kernel_wrappers_reject_other_devices(rng):
    x = torch.zeros((1, 8, 8, 3), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        trs.zoom_bilinear(x, torch.ones(1, device="meta"))
    with pytest.raises(ValueError):
        trg.pil_rotate_nearest(x, torch.zeros((1, 6), device="meta"))
    with pytest.raises(ValueError):
        tsh.shear_rows_logrouted(x, torch.zeros((1, 8), device="meta"), max_shift_px=2)
