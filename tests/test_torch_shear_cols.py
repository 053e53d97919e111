"""The column pass of the port's 3-shear rotation (``shear_cols_plain``,
the plain version of the ``shear_cols`` kernel) against the numpy oracle.

``imagetransformations_tpu_torch/ops/hopper/shear.py`` runs the middle
shear of ``rotate_3shear`` as a shift of each column along y, where the
JAX package and the oracle shift the rows of the transposed batch. The
plain column pass is held here at 0 LSB against ``oracle/fast_warp.
shear_rows`` on the transposed batch and against the port's own row pass
between two transposes, over channel counts 1, 3 and 4, saturation,
all-fill columns and both border fill-lerps. The CUDA kernel is held
against it on the card (tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""

import math

import numpy as np
import pytest
import torch

from imagetransformations_tpu.oracle import fast_warp as ofw

from imagetransformations_tpu_torch.ops.hopper import _lib
from imagetransformations_tpu_torch.ops.hopper import shear as tshear


def _oracle_cols(x: np.ndarray, shifts: np.ndarray, fill: int) -> np.ndarray:
    """The oracle's row shift of the transposed batch, transposed back."""
    return ofw.shear_rows(x.transpose(0, 2, 1, 3), shifts, fill).transpose(0, 2, 1, 3)


def _bound(shifts: np.ndarray) -> int:
    return int(math.ceil(float(np.abs(shifts).max()))) + 1


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("fill", [0, 9, 255])
def test_shear_cols_plain_vs_oracle_on_the_transposed_batch(rng, c, fill):
    x = rng.integers(0, 256, (2, 30, 21, c), dtype=np.uint8)
    shifts = ((rng.random(21) - 0.5) * 70.0).astype(np.float32)  # beyond h on some columns
    out = tshear.shear_cols_plain(torch.from_numpy(x), torch.from_numpy(shifts), fill,
                                  _bound(shifts)).numpy()
    np.testing.assert_array_equal(out, _oracle_cols(x, shifts, fill))


@pytest.mark.parametrize("c", [1, 3, 4])
@pytest.mark.parametrize("b_px", [1, 3, None])
def test_shear_cols_plain_equals_the_transposed_row_pass(rng, c, b_px):
    """Any shift vector and saturation bound: the column pass equals the
    row pass between two transposes, and, saturated, the oracle on the
    saturated shifts."""
    x = torch.from_numpy(rng.integers(0, 256, (3, 17, 26, c), dtype=np.uint8))
    shifts = ((rng.random(26) - 0.5) * 24.0).astype(np.float32)
    b = _bound(shifts) if b_px is None else b_px
    s = torch.from_numpy(shifts)
    out = tshear.shear_cols_plain(x, s, 7, b)
    want = tshear._swap_hw(tshear.shear_rows_plain(tshear._swap_hw(x), s, 7, b))
    assert torch.equal(out, want)
    k = np.floor(shifts)
    saturated = (np.clip(k, -b, b) + (shifts - k)).astype(np.float32)
    np.testing.assert_array_equal(out.numpy(), _oracle_cols(x.numpy(), saturated, 7))


@pytest.mark.parametrize("c", [1, 3, 4])
def test_shear_cols_plain_fill_columns_and_border_lerps(rng, c):
    """Columns shifted past the image are all fill; a half-pixel shift
    lerps the top row (shift -0.5) or the bottom row (+0.5) against fill."""
    h, fill = 12, 200
    x = rng.integers(0, 256, (2, h, 5, c), dtype=np.uint8)
    shifts = np.array([-(h + 0.5), h + 0.25, -0.5, 0.5, 0.0], np.float32)
    out = tshear.shear_cols_plain(torch.from_numpy(x), torch.from_numpy(shifts), fill,
                                  _bound(shifts)).numpy()
    np.testing.assert_array_equal(out, _oracle_cols(x, shifts, fill))
    assert (out[:, :, 0] == fill).all() and (out[:, :, 1] == fill).all()
    v = x.astype(np.float32)
    top = np.trunc(np.float32(fill) + np.float32(0.5) * (v[:, 0, 2] - np.float32(fill)))
    np.testing.assert_array_equal(out[:, 0, 2], top.astype(np.uint8))
    bottom = np.trunc(v[:, h - 1, 3] + np.float32(0.5) * (np.float32(fill) - v[:, h - 1, 3]))
    np.testing.assert_array_equal(out[:, h - 1, 3], bottom.astype(np.uint8))
    np.testing.assert_array_equal(out[:, :, 4], x[:, :, 4])


@pytest.mark.parametrize("angle", [15.0, -44.0, 70.0])
def test_rotate_3shear_runs_the_column_pass_and_no_transpose(rng, monkeypatch, angle):
    """On the CPU too rotate_3shear takes its middle shear from the column
    pass: with the transposes removed it still equals its plain version
    (which keeps them) and the oracle."""
    x = rng.integers(0, 256, (2, 24, 31, 3), dtype=np.uint8)
    want = tshear.rotate_3shear_plain(torch.from_numpy(x), angle, fill=5)

    def no_transpose(_):
        raise AssertionError("rotate_3shear transposed the batch")

    monkeypatch.setattr(tshear, "_swap_hw", no_transpose)
    before = dict(_lib.LAUNCHES)
    out = tshear.rotate_3shear(torch.from_numpy(x), angle, fill=5)
    assert _lib.LAUNCHES == before  # the CPU runs plain versions
    assert torch.equal(out, want)
    np.testing.assert_array_equal(out.numpy(), ofw.rotate_3shear(x, angle, fill=5))


def test_col_shift_checks_its_inputs(rng):
    x = torch.from_numpy(rng.integers(0, 256, (1, 6, 5, 3), dtype=np.uint8))
    with pytest.raises(ValueError, match="column shifts"):
        tshear._col_shift(x, torch.zeros(6), 0, 1)
    with pytest.raises(ValueError, match="u8"):
        tshear._col_shift(x, torch.zeros(5), 256, 1)
    with pytest.raises(ValueError):
        tshear._col_shift(x.to("meta"), torch.zeros(5, device="meta"), 0, 1)
