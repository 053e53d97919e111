"""Geometric warps (PyTorch): affine matrices, the inverse-map affine warp,
the reference's rotation, shear, zoom, translation and flip ops, and the
exact LANCZOS scale.

Counterpart of ``imagetransformations_tpu/ops/warp.py``. ``affine_warp``
is a plain PyTorch gather with PIL's sampling conventions (XLA code in the
JAX package, no Pallas kernel); ``random_zoom`` routes u8 batches in the
kernel's range to the hand-written CUDA kernel ``zoom_bilinear_batched``,
as the JAX package routes it to its Pallas kernel, and ``apply_rotation``
sends every u8 batch, at any angle, to Pillow's fixed-point NEAREST gather
``pil_rotate_nearest_batched`` (exact against Pillow; the JAX package's
f32 warps are not, ROADMAP C.2.9). Every op runs on the image tensor's
device.

The LANCZOS scale (``apply_scale_batched`` and, with one factor,
``apply_scale``; XLA einsums in the JAX package) is the reference's apply_scale (LANCZOS resize, then centre crop
up or black pad down back to the canvas, transformation.py:173-196) as two
fixed-point matrix products an image. PIL accumulates pixel * 22-bit
coefficient with a pre-added half, shifts by 22, clips, and quantizes to u8
*between* the horizontal and vertical passes (Resample.c); an f32 path
drifts by 2 LSB. Every partial sum is an integer below 2^31 in magnitude,
so a float64 matrix product holds each one exactly (53-bit mantissa); the
result is converted to int64 and shifted. f32 (and TF32 above all) is not
exact, and CUDA has no int64 matrix product.

``pil_rotate_matrix`` (defined beside the rotation kernel's wrapper),
``shear_matrix``, ``shear_out_width``, ``resize_coeffs`` and its filters
are this package's copies of the JAX package's numpy oracle
(``oracle/warp.py``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from imagetransformations_tpu_torch.core.image import as_batch, as_float, restore_layout
from imagetransformations_tpu_torch.ops.hopper.resample import zoom_bilinear_batched
from imagetransformations_tpu_torch.ops.hopper.rotate_gather import (  # noqa: F401
    pil_rotate_matrix,
    pil_rotate_nearest_batched,
)

PRECISION_BITS = 22  # PIL: 32 - 8 - 2
F32 = torch.float32


# ---------------------------------------------------------------- affine matrices


def _f32_vector(v, device) -> torch.Tensor:
    """A scalar or array as a 1-D f32 tensor (``atleast_1d``)."""
    return torch.as_tensor(v, dtype=F32, device=device).reshape(-1)


def rotation_matrix(angle_deg, w: int, h: int, device=None) -> torch.Tensor:
    """Inverse-map matrix [N, 6] f32 of the reference's apply_rotation(img,
    angle) for a scalar or [N] angles in degrees (PIL rotate(-angle): the
    two negations cancel into PIL's matrix convention). f32 throughout, in
    the JAX package's op order, every op rounded on its own:
    ``m2 = (m0*(-cx) + m1*(-cy)) + cx``. ``device``: where to compute it
    (cos and sin differ by an ulp between devices), by default the angles'."""
    a = torch.deg2rad(_f32_vector(angle_deg, device))
    cos, sin = torch.cos(a), torch.sin(a)
    cx, cy = w / 2.0, h / 2.0
    m0, m1, m3, m4 = cos, sin, -sin, cos
    m2 = (m0 * (-cx) + m1 * (-cy)) + cx
    m5 = (m3 * (-cx) + m4 * (-cy)) + cy
    return torch.stack([m0, m1, m2, m3, m4, m5], dim=-1)


def translation_matrix(tx, ty, device=None) -> torch.Tensor:
    """Integer-pixel shift [N, 6]: out(x, y) <- src(x - tx, y - ty), zero
    fill. Fractional shifts truncate toward zero (the reference's
    ``int(tx)``, transformation.py:288-289)."""
    tx, ty = torch.broadcast_tensors(_f32_vector(tx, device), _f32_vector(ty, device))
    one, zero = torch.ones_like(tx), torch.zeros_like(tx)
    return torch.stack([one, zero, -torch.trunc(tx), zero, one, -torch.trunc(ty)], dim=-1)


def zoom_matrix(factor, w: int, h: int, device=None) -> torch.Tensor:
    """Zoom about the image centre [N, 6] (keeps the canvas; factor > 1
    magnifies): ``inv = 1/f`` and ``c - inv*c`` in f32."""
    f = _f32_vector(factor, device)
    inv = 1.0 / f
    cx, cy = w / 2.0, h / 2.0
    zero = torch.zeros_like(f)
    return torch.stack([inv, zero, cx - inv * cx, zero, inv, cy - inv * cy], dim=-1)


def compose_matrices(m_outer: torch.Tensor, m_inner: torch.Tensor) -> torch.Tensor:
    """Compose two inverse-map [N, 6] affines: warping with ``m_outer`` and
    then with ``m_inner`` equals one warp with
    ``compose_matrices(m_inner, m_outer)``."""
    a, b = torch.atleast_2d(m_outer), torch.atleast_2d(m_inner)
    r0 = b[:, 0] * a[:, 0] + b[:, 1] * a[:, 3]
    r1 = b[:, 0] * a[:, 1] + b[:, 1] * a[:, 4]
    r2 = b[:, 0] * a[:, 2] + b[:, 1] * a[:, 5] + b[:, 2]
    r3 = b[:, 3] * a[:, 0] + b[:, 4] * a[:, 3]
    r4 = b[:, 3] * a[:, 1] + b[:, 4] * a[:, 4]
    r5 = b[:, 3] * a[:, 2] + b[:, 4] * a[:, 5] + b[:, 5]
    return torch.stack([r0, r1, r2, r3, r4, r5], dim=-1)


def shear_matrix(shear_factor: float, h: int) -> tuple:
    """transformation.py:212-226: (1, s, -ceil(s*h) if s > 0 else 0, 0, 1, 0)."""
    shift = int(math.ceil(shear_factor * h))
    return (1.0, shear_factor, float(-shift if shear_factor > 0 else 0), 0.0, 1.0, 0.0)


def shear_out_width(shear_factor: float, w: int, h: int) -> int:
    return w + int(math.ceil(shear_factor * h))


# ---------------------------------------------------------------- core warp


def _gather(x: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Clamped gather x[n, yi[n, h, w], xi[n, h, w], :] -> [N, H', W', C]."""
    n, h, w, _ = x.shape
    bidx = torch.arange(n, device=x.device).view(n, 1, 1)
    return x[bidx, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]


def _cubic(v1, v2, v3, v4, d):
    """PIL's BICUBIC polynomial (A = -1), every op rounded on its own."""
    p2 = -v1 + v3
    p3 = ((2 * (v1 - v2)) + v3) - v4
    p4 = ((-v1 + v2) - v3) + v4
    return v2 + d * (p2 + d * (p3 + d * p4))


def affine_warp(img: torch.Tensor, matrix, out_size: tuple[int, int] | None = None,
                method: str = "bilinear", fill: float = 0.0) -> torch.Tensor:
    """Inverse-mapping affine warp with PIL's sampling, on the image's device.

    ``matrix``: [6] or [N, 6] = (a, b, c, d, e, f) with
    ``src_x = (a*(x+.5) + b*(y+.5)) + c``, ``src_y = (d*(x+.5) + e*(y+.5)) + f``
    in f32. ``method``: "nearest" (floor), "bilinear" (clamped 2x2 window,
    trunc) or "bicubic" (PIL's A = -1 cubic, clamped 4x4 window, clip then
    trunc). Outside the source canvas: ``fill``. u8 in, u8 out; float in,
    f32 out unquantized. HWC or NHWC."""
    x, single = as_batch(img)
    n, h, w, _ = x.shape
    out_h, out_w = out_size or (h, w)
    m = torch.atleast_2d(torch.as_tensor(matrix, dtype=F32, device=x.device))
    m = m.expand(n, 6).reshape(n, 6, 1, 1)
    yo = torch.arange(out_h, dtype=F32, device=x.device).view(1, out_h, 1) + 0.5
    xo = torch.arange(out_w, dtype=F32, device=x.device).view(1, 1, out_w) + 0.5
    xx = m[:, 0] * xo + m[:, 1] * yo + m[:, 2]
    yy = m[:, 3] * xo + m[:, 4] * yo + m[:, 5]
    valid = ((xx >= 0) & (xx < w) & (yy >= 0) & (yy < h))[..., None]
    xf = as_float(x)

    if method == "nearest":
        out = _gather(xf, torch.floor(yy).to(torch.int64), torch.floor(xx).to(torch.int64))
        quant = None
    elif method in ("bilinear", "bicubic"):
        xin, yin = xx - 0.5, yy - 0.5
        xfl, yfl = torch.floor(xin), torch.floor(yin)
        x0, y0 = xfl.to(torch.int64), yfl.to(torch.int64)
        fx, fy = (xin - xfl)[..., None], (yin - yfl)[..., None]
        if method == "bilinear":
            a, b = _gather(xf, y0, x0), _gather(xf, y0, x0 + 1)
            c, d = _gather(xf, y0 + 1, x0), _gather(xf, y0 + 1, x0 + 1)
            v1 = a + fx * (b - a)
            v2 = c + fx * (d - c)
            out = v1 + fy * (v2 - v1)
            quant = "trunc"
        else:
            rows = []
            for j in range(-1, 3):
                cols = [_gather(xf, y0 + j, x0 + i) for i in range(-1, 3)]
                rows.append(_cubic(*cols, fx))
            out = _cubic(*rows, fy)
            quant = "clip_trunc"
    else:
        raise ValueError(f"unknown warp method {method!r}")

    if x.dtype == torch.uint8:
        if quant == "trunc":
            out = torch.clamp(torch.trunc(out), 0.0, 255.0)
        elif quant == "clip_trunc":
            out = torch.where(out <= 0, 0.0, torch.where(out >= 255, 255.0, torch.trunc(out)))
        out = torch.where(valid, out, float(fill)).to(torch.uint8)
    else:
        out = torch.where(valid, out, float(fill))
    return restore_layout(out, single)


# ---------------------------------------------------------------- public ops


def apply_rotation(img: torch.Tensor, angle, max_angle_deg: float | None = None) -> torch.Tensor:
    """Reference apply_rotation: PIL rotate(-angle), NEAREST, black fill.

    u8 images run Pillow's fixed-point NEAREST gather at any angle, a
    scalar and an array of angles alike (``pil_rotate_nearest_batched``;
    an angle tensor on the card costs one copy to the host). Float images
    take the f32 warp, as in the JAX package: a Python scalar with PIL's
    float64 matrix, an array with ``rotation_matrix`` (f32, on the image's
    device). ``max_angle_deg`` is the JAX signature's routing budget; the
    gather needs none, so it only documents the caller's range."""
    del max_angle_deg  # documentation only (see above)
    x, single = as_batch(img)
    h, w = x.shape[1], x.shape[2]
    if x.dtype == torch.uint8:
        return restore_layout(pil_rotate_nearest_batched(x, angle), single)
    if isinstance(angle, (int, float)):
        m = torch.tensor(pil_rotate_matrix(-float(angle), w, h), dtype=torch.float64).to(F32)
    else:
        m = rotation_matrix(angle, w, h, device=x.device)
    return restore_layout(affine_warp(x, m, method="nearest", fill=0.0), single)


def apply_shear(img: torch.Tensor, shear_factor: float) -> torch.Tensor:
    """Reference apply_shear: widened canvas (w + ceil(s*h)), AFFINE
    BICUBIC, white fill."""
    x, single = as_batch(img)
    h, w = x.shape[1], x.shape[2]
    s = float(shear_factor)
    m = torch.tensor(shear_matrix(s, h), dtype=torch.float64).to(F32)
    out = affine_warp(x, m, out_size=(h, shear_out_width(s, w, h)), method="bicubic",
                      fill=255.0)
    return restore_layout(out, single)


def random_zoom(img: torch.Tensor, factor) -> torch.Tensor:
    """Centre zoom keeping the canvas (fall_2025/transformations_code:50).

    A Python-number factor in [0.5, 4] on u8 images runs the bilinear zoom
    kernel (budget factor -+ 0.01, as the JAX package calls it); anything
    else takes the bilinear warp of ``zoom_matrix``. Both give the same
    bits where both apply."""
    x, single = as_batch(img)
    h, w = x.shape[1], x.shape[2]
    if isinstance(factor, (int, float)) and x.dtype == torch.uint8 and 0.5 <= factor <= 4.0:
        f = float(factor)
        out = zoom_bilinear_batched(x, f, min_factor=f - 0.01, max_factor=f + 0.01)
        return restore_layout(out, single)
    m = zoom_matrix(factor, w, h, device=x.device)
    return restore_layout(affine_warp(x, m, method="bilinear", fill=0.0), single)


def apply_translation(img: torch.Tensor, tx, ty=None) -> torch.Tensor:
    """Reference apply_translation: integer shift, black fill. Python-number
    shifts are a zero canvas and one slice copy, fractional shifts
    truncated toward zero like the reference's ``int(tx)``
    (transformation.py:288-289); anything else (one shift an image) takes
    the NEAREST warp of ``translation_matrix``."""
    if ty is None:
        ty = tx
    x, single = as_batch(img)
    if isinstance(tx, (int, float)) and isinstance(ty, (int, float)):
        sx, sy = int(tx), int(ty)
        h, w = x.shape[1], x.shape[2]
        hh, ww = h - abs(sy), w - abs(sx)
        out = torch.zeros_like(x)
        if hh > 0 and ww > 0:
            dy0, sy0 = max(sy, 0), max(-sy, 0)
            dx0, sx0 = max(sx, 0), max(-sx, 0)
            out[:, dy0 : dy0 + hh, dx0 : dx0 + ww] = x[:, sy0 : sy0 + hh, sx0 : sx0 + ww]
        return restore_layout(out, single)
    m = translation_matrix(tx, ty, device=x.device)
    return restore_layout(affine_warp(x, m, method="nearest", fill=0.0), single)


def flip_vertical(img: torch.Tensor) -> torch.Tensor:
    """Vertical flip (fall_2025/transformations_code:39)."""
    x, single = as_batch(img)
    return restore_layout(torch.flip(x, dims=(1,)), single)


def apply_scale(img: torch.Tensor, scale_factor: float) -> torch.Tensor:
    """Reference apply_scale: LANCZOS resize, then centre crop (up) or black
    pad (down) back to the canvas (transformation.py:173-196). The exact
    ``apply_scale_batched`` with the one factor as its grid: the JAX package
    documents the two as bit-exact."""
    x, single = as_batch(img)
    f = float(scale_factor)
    return restore_layout(apply_scale_batched(x, [f] * x.shape[0], grid=(f,)), single)


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


# ---------------------------------------------------------------- LANCZOS matrices


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
