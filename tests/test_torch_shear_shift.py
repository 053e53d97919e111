"""The BICUBIC shear's canvas shift is PIL's f64 ``ceil(s*h)``.

The reference (transformation.py:212-226) hands PIL a Python float ``s``
and widens the canvas by ``ceil(s*h)`` in f64. The JAX kernel #11 takes
that shift in f32, which moves whole rows by a pixel at some (s, h): at
h = 100 and s = 0.3 up to 255 LSB on about a quarter of the values. The
port computes the shift as an int32 on the host in f64: the sweep from the
shear grid's Python floats (``resample.shear_shift_table``, gathered by
each image's drawn index), a direct call from the f64 value of each f32
factor (``resample.canvas_shifts``); kernel and plain version take the same
integers, and the sampling stays f32.

Held here: #11's plain version against PIL ``Image.transform(AFFINE,
BICUBIC)`` within apply_shear's PIL budget (<= 1 LSB on <= 0.03% of values:
f32 sampling against PIL's f64), at h = 100 (s = 0.3) and h = 720 (s = 0.3,
0.6), where the f32 rule fails; the sweep's table against f64 ``math.ceil``
on every grid value at h = 10, 40, 80, 100, 480 and 512.
"""

import math

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from imagetransformations_tpu.ops.pallas import resample as jrs

import imagetransformations_tpu_torch as port
from imagetransformations_tpu_torch.ops.hopper import resample as rs

GRID = tuple(float(v) for v in port.PARAM_GRIDS["shear"].values_f64())
PIL_BUDGET = (1, 0.0003)


def pil_shear(img, s):
    """The reference's apply_shear in PIL, cropped back to the input width."""
    h, w = img.shape[:2]
    shift = int(math.ceil(s * h))
    out = Image.fromarray(img).transform(
        (w + shift, h), Image.AFFINE, (1, s, -shift if s > 0 else 0, 0, 1, 0),
        resample=Image.BICUBIC, fillcolor=(255, 255, 255))
    return np.asarray(out)[:, :w]


@pytest.mark.parametrize("h,s", [(100, 0.3), (720, 0.3), (720, 0.6)])
def test_plain_version_within_the_pil_budget(h, s):
    img = np.random.default_rng(h).integers(0, 256, (h, 16, 3), dtype=np.uint8)
    f = torch.tensor([s], dtype=torch.float32)
    shifts = rs.shear_shift_table((s,), h, torch.device("cpu"))
    got = rs.shear_bicubic_plain(torch.from_numpy(img[None]), f, shifts).numpy()[0]
    want = pil_shear(img, s)
    err = np.abs(got.astype(int) - want.astype(int))
    assert err.max() <= PIL_BUDGET[0] and (err > 0).mean() <= PIL_BUDGET[1], (
        err.max(), (err > 0).mean())
    # the f32 rule (the JAX kernel's) shifts whole rows here
    assert math.ceil(s * h) != int(np.ceil(np.float32(s) * np.float32(h)))
    jax_out = np.asarray(jrs.shear_bicubic_batched(jnp.asarray(img[None]), jnp.asarray(f)))[0]
    assert np.abs(jax_out.astype(int) - want.astype(int)).max() > 100


@pytest.mark.parametrize("h", [10, 40, 80, 100, 480, 512])
def test_sweep_table_is_the_f64_ceil(h):
    table = rs.shear_shift_table(GRID, h, torch.device("cpu"))
    assert table.dtype == torch.int32
    assert table.tolist() == [math.ceil(v * h) if v > 0 else 0 for v in GRID]


def test_direct_calls_take_the_f64_value_of_each_f32():
    f = torch.tensor([0.1, 0.3, 0.0, -0.2, 1.0], dtype=torch.float32)
    got = rs.canvas_shifts(f, 40)
    want = [math.ceil(float(v) * 40) if v > 0 else 0 for v in f.tolist()]
    assert got.dtype == torch.int32 and got.tolist() == want
    assert got.tolist()[1] == 13  # f64(f32(0.3)) * 40 = 12.0000005: the grid's 0.3 gives 12


def test_the_sweep_shear_equals_pil_on_the_values_it_drew():
    """apply_all's shear: the drawn grid values' Python floats, as the
    reference hands them to PIL, at h = 40 (where the f32 rule and the f64
    rule on f32 values part on several grid values)."""
    imgs = np.random.default_rng(8).integers(0, 256, (12, 40, 16, 3), dtype=np.uint8)
    values, out = port.apply_all_transformations(imgs, 2, types=("shear",),
                                                 device="cpu")["shear"]
    grid32 = port.PARAM_GRIDS["shear"].values()
    assert len(set(values.tolist())) > 4
    want = np.stack([pil_shear(im, GRID[int(np.nonzero(grid32 == v)[0][0])])
                     for im, v in zip(imgs, values.numpy())])
    err = np.abs(out.numpy().astype(int) - want.astype(int))  # measured: 1 value of 23040
    assert err.max() <= PIL_BUDGET[0] and (err > 0).mean() <= PIL_BUDGET[1], (
        err.max(), (err > 0).mean())


def test_the_plain_version_takes_the_shifts_it_is_given():
    """One more pixel of shift moves the output one pixel right (<= 1 LSB:
    xx - 1 may round differently in f32); the default is canvas_shifts."""
    img = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (1, 20, 11, 3),
                                                              dtype=np.uint8))
    f = torch.tensor([0.3])
    a = rs.shear_bicubic_plain(img, f, torch.tensor([6], dtype=torch.int32))
    b = rs.shear_bicubic_plain(img, f, torch.tensor([7], dtype=torch.int32))
    assert not torch.equal(a, b)
    assert (b[:, :, 1:].int() - a[:, :, :-1].int()).abs().max() <= 1
    assert torch.equal(rs.shear_bicubic(img, f),
                       rs.shear_bicubic_plain(img, f, torch.tensor([7])))
    with pytest.raises(ValueError, match="shifts"):
        rs.shear_bicubic_plain(img, f, torch.tensor([1, 2, 3]))
