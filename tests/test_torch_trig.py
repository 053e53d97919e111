"""The port's f32 trigonometry on the shift and matrix paths is correctly rounded.

``megakernel._traced_params`` (the per-image shifts of kernels #4 and #5)
takes ``tan(t/2)`` and ``sin(t)``, and ``warp.rotation_matrix`` takes
``cos`` and ``sin``, in f64 on the tensor's device and rounds them to f32
(``core.image.trig_f32``): the correctly rounded f32 values, the same on the
CPU and on the card (chip_smoke.py holds the card's to the CPU's bit for
bit). Held here against numpy's f64 functions rounded to f32 on 2000
seeded random angles, every other f32 op in the JAX order, and against the
JAX package on the rotation grid: bit for bit.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagetransformations_tpu.ops import warp as jwp

from imagetransformations_tpu_torch.core.image import trig_f32
from imagetransformations_tpu_torch.ops import warp as twp
from imagetransformations_tpu_torch.ops.hopper import megakernel as mk

GRID_ANGLES = np.arange(-22.5, 22.51, 2.5).astype(np.float32)
CPU = torch.device("cpu")


def _random_angles(n=2000, lim=180.0):
    return np.random.default_rng(2024).uniform(-lim, lim, n).astype(np.float32)


def _f32_of_f64(fn, x):
    return fn(np.asarray(x, np.float32).astype(np.float64)).astype(np.float32)


def _traced_model(angles, h, w, max_angle):
    """_traced_params in numpy: f32 ops in the JAX order, the trig in f64
    rounded to f32."""
    ang = np.clip(angles.astype(np.float32), np.float32(-max_angle), np.float32(max_angle))
    t = torch.deg2rad(-torch.from_numpy(ang)).numpy()  # PyTorch's f32 multiply
    a = -_f32_of_f64(np.tan, t / np.float32(2.0))
    b = _f32_of_f64(np.sin, t)
    ys = (np.arange(h, dtype=np.float32) + np.float32(0.5)) - np.float32(h / 2.0)
    xs = (np.arange(w, dtype=np.float32) + np.float32(0.5)) - np.float32(w / 2.0)
    sx, sy = a[:, None] * ys[None, :], b[:, None] * xs[None, :]
    k1, k2 = np.floor(sx), np.floor(sy)
    return k1.astype(np.int32), sx - k1, k2.astype(np.int32), sy - k2, (t == 0).astype(np.int32)


def test_trig_f32_is_the_f64_value_rounded():
    x = torch.from_numpy(_random_angles() / np.float32(57.0))
    for fn, nfn in ((torch.tan, np.tan), (torch.sin, np.sin), (torch.cos, np.cos)):
        got = trig_f32(fn, x)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), _f32_of_f64(nfn, x.numpy()))


@pytest.mark.parametrize("max_angle", [23.0, 180.0])
def test_traced_params_on_random_angles(max_angle):
    angles = _random_angles()
    n, h, w = angles.size, 9, 14
    got = mk._traced_params(torch.from_numpy(angles), n, h, w, max_angle, CPU)
    for g, want, name in zip(got, _traced_model(angles, h, w, max_angle),
                             ("k1", "f1", "k2", "f2", "identity")):
        assert g.numpy().dtype == want.dtype, name
        np.testing.assert_array_equal(g.numpy(), want, err_msg=name)


def test_traced_params_equal_jax_on_the_grid():
    n, h, w = GRID_ANGLES.size, 40, 56
    got = mk._traced_params(torch.from_numpy(GRID_ANGLES), n, h, w, 23.0, CPU)
    t = jnp.deg2rad(-jnp.clip(jnp.asarray(GRID_ANGLES), -23.0, 23.0))
    a, b = -jnp.tan(t / 2.0), jnp.sin(t)
    want = _traced_model(GRID_ANGLES, h, w, 23.0)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    # XLA's f32 tan and sin are correctly rounded at every grid angle
    np.testing.assert_array_equal(np.asarray(a), -_f32_of_f64(np.tan, np.asarray(t) / 2))
    np.testing.assert_array_equal(np.asarray(b), _f32_of_f64(np.sin, np.asarray(t)))
    for g, v in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), v)


def _matrix_model(angles, w, h):
    a = torch.deg2rad(torch.from_numpy(angles.astype(np.float32))).numpy()
    cos, sin = _f32_of_f64(np.cos, a), _f32_of_f64(np.sin, a)
    cx, cy = np.float32(w / 2.0), np.float32(h / 2.0)
    m2 = (cos * -cx + sin * -cy) + cx
    m5 = (-sin * -cx + cos * -cy) + cy
    return np.stack([cos, sin, m2, -sin, cos, m5], axis=-1)


@pytest.mark.parametrize("w,h", [(48, 40), (512, 512), (37, 23)])
def test_rotation_matrix_on_random_angles(w, h):
    angles = _random_angles()
    got = twp.rotation_matrix(torch.from_numpy(angles), w, h).numpy()
    np.testing.assert_array_equal(got, _matrix_model(angles, w, h))


@pytest.mark.parametrize("w,h", [(48, 40), (32, 32), (512, 512)])
def test_rotation_matrix_equals_jax_on_the_grid(w, h):
    angles = np.concatenate([GRID_ANGLES, np.float32([45.0, 60.0, 90.0, -135.0, 180.0])])
    got = twp.rotation_matrix(torch.from_numpy(angles), w, h).numpy()
    np.testing.assert_array_equal(got, np.asarray(jwp.rotation_matrix(jnp.asarray(angles), w, h)))
    np.testing.assert_array_equal(got, _matrix_model(angles, w, h))


def test_traced_shifts_of_the_jax_kernels_equal_the_port_on_the_grid():
    """The JAX traced kernels' own shift formulas (megakernel.py:1101-1116)
    give the port's arrays on the grid angles."""
    n, h, w = GRID_ANGLES.size, 64, 48
    got = mk._traced_params(torch.from_numpy(GRID_ANGLES), n, h, w, 23.0, CPU)
    t = jnp.deg2rad(-jnp.clip(jnp.asarray(GRID_ANGLES), -23.0, 23.0))
    ys = jnp.arange(h, dtype=jnp.float32) + 0.5 - h / 2.0
    sx = (-jnp.tan(t / 2.0))[:, None] * ys[None, :]
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(jnp.floor(sx)).astype(np.int32))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(sx - jnp.floor(sx)))
