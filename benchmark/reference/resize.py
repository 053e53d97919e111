"""PIL's resampling in plain PyTorch: frozen copy of the port's
``ops/warp.py`` resize path (``resize_coeffs``, ``pil_resize``,
``apply_scale_batched``).

PIL's 22-bit fixed-point filter coefficients, a horizontal pass, PIL's
rounding to u8 (``clip((acc + 2^21) >> 22)``), then the vertical pass and
the same rounding. Each pass is an f64 matrix product whose partial sums
are integers below 2^31, so exact in any order."""

from __future__ import annotations

import functools

import numpy as np
import torch

from .image import as_batch, restore_layout

PRECISION_BITS = 22  # PIL: 32 - 8 - 2


def _sinc(x):
    out = np.ones_like(x)
    nz = x != 0
    px = np.pi * x[nz]
    out[nz] = np.sin(px) / px
    return out


def lanczos_filter(x, a=3.0):
    x = np.asarray(x, np.float64)
    return np.where(np.abs(x) < a, _sinc(x) * _sinc(x / a), 0.0)


def bilinear_filter(x):
    x = np.abs(np.asarray(x, np.float64))
    return np.maximum(1.0 - x, 0.0)


def box_filter(x):
    x = np.asarray(x, np.float64)
    return np.where((x > -0.5) & (x <= 0.5), 1.0, 0.0)


FILTERS = {
    "lanczos": (lanczos_filter, 3.0),
    "bilinear": (bilinear_filter, 1.0),
    "box": (box_filter, 0.5),
}


def resize_coeffs(in_size: int, out_size: int, method: str = "lanczos"):
    """PIL Resample.c precompute_coeffs: per-output (xmin, taps[fixed-point])."""
    filt, support0 = FILTERS[method]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support0 * filterscale
    ss = 1.0 / filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    bounds = np.zeros((out_size, 2), np.int64)
    kk = np.zeros((out_size, ksize), np.int64)
    for xo in range(out_size):
        center = (xo + 0.5) * scale
        xmin = int(max(0, center - support + 0.5))
        xmax = int(min(in_size, center + support + 0.5)) - xmin
        w = filt((np.arange(xmax) + xmin - center + 0.5) * ss)
        w = w / w.sum()
        kk[xo, :xmax] = np.where(
            w < 0, w * (1 << PRECISION_BITS) - 0.5, w * (1 << PRECISION_BITS) + 0.5
        ).astype(np.int64)
        bounds[xo] = (xmin, xmax)
    return bounds, kk


def resize_matrix_fixed(in_size: int, out_size: int, method: str) -> np.ndarray:
    """Dense [out, in] int32 fixed-point (2^22) filter matrix (PIL coefficients)."""
    bounds, kk = resize_coeffs(in_size, out_size, method)
    mat = np.zeros((out_size, in_size), np.int32)
    for o in range(out_size):
        xmin, xmax = bounds[o]
        mat[o, xmin: xmin + xmax] = kk[o, :xmax]
    return mat


@functools.lru_cache(maxsize=32)
def scale_canvas_matrices(size: int, grid: tuple) -> np.ndarray:
    """[G, size, size] int32 LANCZOS matrices, one a grid factor, with the
    centre crop (factor > 1) or black pad (factor < 1) back to the canvas
    folded in as a selection of output rows."""
    mats = np.zeros((len(grid), size, size), np.int32)
    for g, v in enumerate(grid):
        nsize = int(size * v)
        m = resize_matrix_fixed(size, nsize, "lanczos")
        if v > 1.0:
            off = (nsize - size) // 2
            mats[g] = m[off: off + size]
        else:
            off = (size - nsize) // 2
            mats[g, off: off + nsize] = m
    return mats


def _round_shift(acc: torch.Tensor) -> torch.Tensor:
    """PIL's clip((acc + 2^21) >> 22, 0, 255) of an exact f64 integer sum."""
    q = (acc.to(torch.int64) + (1 << (PRECISION_BITS - 1))) >> PRECISION_BITS
    return q.clamp(0, 255)


def apply_scale_batched(img: torch.Tensor, factors, grid: tuple) -> torch.Tensor:
    """The reference's apply_scale (LANCZOS resize, then centre crop or black
    pad back to the canvas) with one factor an image from ``grid``: each
    image takes the matrices of its nearest grid value (f32 argmin)."""
    x, single = as_batch(img)
    n, h, w, c = x.shape
    dev = x.device
    gt = tuple(float(v) for v in grid)
    gv = torch.tensor(gt, dtype=torch.float32, device=dev)
    f = torch.as_tensor(factors, dtype=torch.float32, device=dev).reshape(-1)
    idx = torch.argmin(torch.abs(f[:, None] - gv[None, :]), dim=1)
    hsel = torch.from_numpy(scale_canvas_matrices(w, gt)).to(dev, torch.float64)[idx]
    vsel = torch.from_numpy(scale_canvas_matrices(h, gt)).to(dev, torch.float64)[idx]
    xi = torch.clamp(torch.trunc(x.to(torch.float64)), 0.0, 255.0)
    t = torch.bmm(hsel, xi.permute(0, 2, 1, 3).reshape(n, w, h * c))
    t = _round_shift(t).to(torch.float64).reshape(n, w, h, c).permute(0, 2, 1, 3)
    o = torch.bmm(vsel, t.reshape(n, h, w * c))
    o = _round_shift(o).reshape(n, h, w, c)
    out = o.to(torch.uint8) if img.dtype == torch.uint8 else o.to(torch.float32)
    return restore_layout(out, single)


def pil_resize(img: torch.Tensor, out_w: int, out_h: int, method: str = "lanczos") -> torch.Tensor:
    """PIL ``Image.resize((out_w, out_h), filter)``, bit-exact, for the
    filters of ``resize_coeffs``; u8 in, u8 out."""
    x, single = as_batch(img)
    n, h, w, c = x.shape
    hmat = torch.from_numpy(resize_matrix_fixed(w, int(out_w), method)).to(x.device, torch.float64)
    vmat = torch.from_numpy(resize_matrix_fixed(h, int(out_h), method)).to(x.device, torch.float64)
    xi = torch.clamp(torch.trunc(x.to(torch.float64)), 0.0, 255.0)
    t = torch.matmul(hmat, xi.permute(0, 2, 1, 3).reshape(n, w, h * c))
    t = _round_shift(t).to(torch.float64).reshape(n, out_w, h, c).permute(0, 2, 1, 3)
    o = torch.matmul(vmat, t.reshape(n, h, out_w * c))
    o = _round_shift(o).reshape(n, out_h, out_w, c)
    out = o.to(torch.uint8) if img.dtype == torch.uint8 else o.to(torch.float32)
    return restore_layout(out, single)
