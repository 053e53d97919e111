"""Exact PIL LANCZOS scale with one factor an image (PyTorch).

Counterpart of ``imagetransformations_tpu/ops/warp.py``
``apply_scale_batched`` (XLA einsums in the JAX package, no Pallas kernel):
the reference's apply_scale (LANCZOS resize, then centre crop up or black
pad down back to the canvas, transformation.py:173-196) as two fixed-point
matrix products an image. PIL accumulates pixel * 22-bit coefficient with a
pre-added half, shifts by 22, clips, and quantizes to u8 *between* the
horizontal and vertical passes (Resample.c); an f32 path drifts by 2 LSB.

Every partial sum is an integer below 2^31 in magnitude, so a float64
matrix product holds each one exactly (53-bit mantissa); the result is
converted to int64 and shifted. f32 (and TF32 above all) is not exact, and
CUDA has no int64 matrix product.

``resize_coeffs`` and its filters are this package's copy of the JAX
package's numpy oracle (``oracle/warp.py``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from imagetransformations_tpu_torch.core.image import as_batch, restore_layout

PRECISION_BITS = 22  # PIL: 32 - 8 - 2


# ---------------------------------------------------------------- PIL filters


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


_FILTERS = {
    "lanczos": (lanczos_filter, 3.0),
    "bilinear": (bilinear_filter, 1.0),
    "box": (box_filter, 0.5),
}


def resize_coeffs(in_size: int, out_size: int, method: str = "lanczos"):
    """PIL Resample.c precompute_coeffs: per-output (xmin, taps[fixed-point])."""
    filt, support0 = _FILTERS[method]
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


# ---------------------------------------------------------------- matrices


def _resize_matrix_fixed(in_size: int, out_size: int, method: str) -> np.ndarray:
    """Dense [out, in] int32 fixed-point (2^22) filter matrix (PIL coefficients)."""
    bounds, kk = resize_coeffs(in_size, out_size, method)
    mat = np.zeros((out_size, in_size), np.int32)
    for o in range(out_size):
        xmin, xmax = bounds[o]
        mat[o, xmin : xmin + xmax] = kk[o, :xmax]
    return mat


@functools.lru_cache(maxsize=32)
def _scale_canvas_matrices(size: int, grid: tuple) -> np.ndarray:
    """[G, size, size] int32 canvas-composed LANCZOS matrices, one a grid factor.

    Cropping (factor > 1) or black padding (factor < 1) back to the canvas
    selects output rows of each pass's matrix, and commutes with the other
    pass and with the u8 quantization between them, so the canvas-to-canvas
    op along one axis is one [size, size] matrix: the resize rows shifted to
    their canvas positions, zero rows where the canvas is padded black (a
    zero row quantizes to exactly 0)."""
    mats = np.zeros((len(grid), size, size), np.int32)
    for g, v in enumerate(grid):
        nsize = int(size * v)
        m = _resize_matrix_fixed(size, nsize, "lanczos")
        if v > 1.0:
            off = (nsize - size) // 2
            mats[g] = m[off : off + size]
        else:
            off = (size - nsize) // 2
            mats[g, off : off + nsize] = m
    return mats


@functools.lru_cache(maxsize=16)
def _canvas_matrices_on(size: int, grid: tuple, device: torch.device) -> torch.Tensor:
    """``_scale_canvas_matrices`` as f64 on ``device``, copied there once."""
    return torch.from_numpy(_scale_canvas_matrices(size, grid)).to(device, torch.float64)


def _round_shift(acc: torch.Tensor) -> torch.Tensor:
    """PIL's clip((acc + 2^21) >> 22, 0, 255) of an exact f64 integer sum."""
    q = (acc.to(torch.int64) + (1 << (PRECISION_BITS - 1))) >> PRECISION_BITS
    return q.clamp(0, 255)


def apply_scale_batched(img: torch.Tensor, factors, grid: tuple) -> torch.Tensor:
    """Per-image apply_scale over a fixed grid of factors, bit-exact.

    Each image takes the canvas matrices of its nearest grid value
    (``argmin |f - grid|`` in f32, the first on a tie) and runs the two
    fixed-point passes as float64 batched matrix products (exact, see the
    module note): horizontal, then PIL's between-pass rounding, then
    vertical and the same rounding."""
    x, single = as_batch(img)
    n, h, w, c = x.shape
    dev = x.device
    gt = tuple(float(v) for v in grid)
    gv = torch.tensor(gt, dtype=torch.float32, device=dev)
    f = torch.as_tensor(factors, dtype=torch.float32, device=dev).reshape(-1)
    idx = torch.argmin(torch.abs(f[:, None] - gv[None, :]), dim=1)
    hsel = _canvas_matrices_on(w, gt, dev)[idx]
    vsel = _canvas_matrices_on(h, gt, dev)[idx]
    xi = torch.clamp(torch.trunc(x.to(torch.float64)), 0.0, 255.0)
    # horizontal: t[n, h, o, c] = sum_w x[n, h, w, c] * H[n, o, w]
    t = torch.bmm(hsel, xi.permute(0, 2, 1, 3).reshape(n, w, h * c))  # [n, o=w, h*c]
    t = _round_shift(t).to(torch.float64).reshape(n, w, h, c).permute(0, 2, 1, 3)
    # vertical: o[n, o, w, c] = sum_h t[n, h, w, c] * V[n, o, h]
    o = torch.bmm(vsel, t.reshape(n, h, w * c))  # [n, o=h, w*c]
    o = _round_shift(o).reshape(n, h, w, c)
    out = o.to(torch.uint8) if img.dtype == torch.uint8 else o.to(torch.float32)
    return restore_layout(out, single)
