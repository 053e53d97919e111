"""The 8-type sweep at ``apply_all_transformations``' fast flags
(``pil_parity_scale_shear=False``, ``pil_parity_rotation=True``) in plain
PyTorch: the bilinear centre zoom, Pillow's fixed-point NEAREST rotation
and the row-shift shear, beside the five types the flags do not change
(``transforms.py``).

Frozen copies of the port's plain versions, which equal the CUDA kernels
byte for byte: ``ops/hopper/resample.py`` (``zoom_axis``,
``zoom_bilinear_plain``: kernel #10), ``ops/hopper/rotate_gather.py``
(``pil_rotate_matrix``, the coefficient rows, ``pil_rotate_nearest_plain``:
kernel #12) and ``ops/hopper/shear.py`` with ``pipeline/batch.py``'s fast
shear (``fast_shear_shifts``, ``fast_shear_budget``,
``shear_rows_plain``: kernel #9). Each float computation takes ``dtype``:
``torch.float32`` is the reference, ``torch.bfloat16`` the control. The
rotation is integer arithmetic and f64 on the host; it takes none.

The draws are ``transforms.sweep_draws``': the fast flags draw the same
values in the same order."""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import transforms as rt

F32 = torch.float32


# ------------------------------------------------------------- bilinear zoom


def zoom_axis(inv: torch.Tensor, dim: int, dtype=F32):
    """Source taps along one axis of size ``dim`` for ``inv = 1/f`` [n, 1]:
    (i0, i1 int64 [n, dim] clamped, frac [n, dim], valid bool [n, dim])."""
    inv = inv.to(dtype)
    pos = torch.arange(dim, dtype=dtype, device=inv.device) + 0.5
    half = dim / 2.0
    m = half - inv * half
    src = inv * pos + m
    sm = src - 0.5
    s0 = torch.floor(sm)
    frac = sm - s0
    i0 = torch.clamp(s0, 0.0, dim - 1.0).to(torch.int64)
    i1 = torch.clamp(s0 + 1.0, 0.0, dim - 1.0).to(torch.int64)
    return i0, i1, frac, (src >= 0) & (src < dim)


def zoom_bilinear(x: torch.Tensor, factors: torch.Tensor, dtype=F32) -> torch.Tensor:
    """Centre zoom, one f32 factor an image, zero fill: rows lerped along x
    (0 where x is not valid), then those lerped along y, trunc, clip, 0
    where y is not valid."""
    n, h, w, c = x.shape
    inv = 1.0 / factors.to(F32).reshape(n, 1)
    x0, x1, fx, vx = zoom_axis(inv, w, dtype)
    y0, y1, fy, vy = zoom_axis(inv, h, dtype)
    v = x.to(dtype)

    def hpass(rows: torch.Tensor) -> torch.Tensor:
        r = torch.gather(v, 1, rows[:, :, None, None].expand(n, h, w, c))
        a = torch.gather(r, 2, x0[:, None, :, None].expand(n, h, w, c))
        b = torch.gather(r, 2, x1[:, None, :, None].expand(n, h, w, c))
        out = a + fx[:, None, :, None] * (b - a)
        return torch.where(vx[:, None, :, None], out, 0.0)

    top, bot = hpass(y0), hpass(y1)
    out = (top + fy[:, :, None, None] * (bot - top)).to(F32)
    out = torch.clamp(torch.trunc(out), 0.0, 255.0)
    return torch.where(vy[:, :, None, None], out, 0.0).to(torch.uint8)


# ------------------------------------------------------------- NEAREST rotation


def pil_rotate_matrix(angle_deg: float, w: int, h: int) -> tuple:
    """PIL ``Image.rotate(angle, expand=False)``'s inverse-map matrix, f64."""
    angle = -math.radians(angle_deg % 360.0)
    m = [round(math.cos(angle), 15), round(math.sin(angle), 15), 0.0,
         round(-math.sin(angle), 15), round(math.cos(angle), 15), 0.0]
    cx, cy = w / 2.0, h / 2.0
    m[2] = m[0] * (-cx) + m[1] * (-cy) + cx
    m[5] = m[3] * (-cx) + m[4] * (-cy) + cy
    return tuple(m)


def _fix(v: float) -> int:
    return math.floor(v * 65536.0 + 0.5)


def _wrap32(v: int) -> int:
    return (v + 2**31) % 2**32 - 2**31


@functools.lru_cache(maxsize=256)
def rotate_coeffs(angle: float, w: int, h: int) -> tuple:
    """Pillow's six 16.16 coefficients of ``rotate(-angle, NEAREST)`` on a
    w x h image (Geometry.c ``affine_fixed``), wrapped to 32 bits; raises
    where a corner reaches 32768 (Pillow's float path, sides near 32768)."""
    m0, m1, m2, m3, m4, m5 = pil_rotate_matrix(-angle, w, h)
    for cx, cy in ((0, 0), (w, h), (0, h), (w, 0)):
        if not (abs(cx * m0 + cy * m1 + m2) < 32768.0 and abs(cx * m3 + cy * m4 + m5) < 32768.0):
            raise ValueError("Pillow's float path: not covered by this reference")
    fixed = (_fix(m0), _fix(m1), _fix(m2 + m0 * 0.5 + m1 * 0.5),
             _fix(m3), _fix(m4), _fix(m5 + m3 * 0.5 + m4 * 0.5))
    return tuple(_wrap32(v) for v in fixed)


def _wrap_shift(v: torch.Tensor) -> torch.Tensor:
    return (((v + 2**31) & 0xFFFFFFFF) - 2**31) >> 16


def pil_rotate_nearest(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Pillow's ``rotate(-a, NEAREST)``, black fill, one angle an image."""
    n, h, w, c = x.shape
    rows = [rotate_coeffs(float(a), w, h) for a in angles.cpu().tolist()]
    k = torch.tensor(rows, dtype=torch.int64, device=x.device).reshape(n, 6, 1, 1)
    xs = torch.arange(w, dtype=torch.int64, device=x.device).view(1, 1, w)
    ys = torch.arange(h, dtype=torch.int64, device=x.device).view(1, h, 1)
    xin = _wrap_shift(k[:, 2] + ys * k[:, 1] + xs * k[:, 0])
    yin = _wrap_shift(k[:, 5] + ys * k[:, 4] + xs * k[:, 3])
    valid = (xin >= 0) & (xin < w) & (yin >= 0) & (yin < h)
    out = x[torch.arange(n, device=x.device).view(n, 1, 1), torch.where(valid, yin, 0),
            torch.where(valid, xin, 0)]
    return torch.where(valid[..., None], out, torch.zeros((), dtype=torch.uint8,
                                                          device=x.device))


# ------------------------------------------------------------- row-shift shear


def fast_shear_shifts(values: torch.Tensor, h: int) -> torch.Tensor:
    """Row shifts [n, h] f32: row y of an image with factor v moves by
    ``v*(y + 0.5) - ceil(v*h)`` (v > 0; 0 otherwise), the widened canvas's
    crop."""
    v = values.to(F32).reshape(-1, 1)
    y = (torch.arange(h, dtype=F32, device=values.device) + 0.5).reshape(1, h)
    return v * y - torch.where(v > 0, torch.ceil(v * float(h)), 0.0)


def shear_rows(x: torch.Tensor, shifts: torch.Tensor, fill: int, b_px: int,
               dtype=F32) -> torch.Tensor:
    """Each row y of image i shifted by ``shifts[i, y]``: trunc of the lerp
    of taps floor(s) and floor(s) + 1, ``fill`` outside the row, the
    integer shift saturated at +-``b_px``, both border pixels lerped
    against ``fill``."""
    n, h, w, c = x.shape
    k = torch.floor(shifts)
    f = (shifts - k)[..., None, None].to(dtype)
    ki = torch.clamp(k, -b_px, b_px).to(torch.int64)[..., None]
    j = torch.arange(w, device=x.device).view(1, 1, w) + ki
    v = x.to(dtype)

    def tap(idx: torch.Tensor) -> torch.Tensor:
        got = torch.gather(v, 2, idx.clamp(0, w - 1)[..., None].expand(n, h, w, c))
        return torch.where(((idx >= 0) & (idx < w))[..., None], got,
                           torch.tensor(float(fill), dtype=dtype, device=x.device))

    a, b = tap(j), tap(j + 1)
    out = torch.trunc((a + f * (b - a)).to(F32))
    keep = ((j >= -1) & (j <= w - 1))[..., None]
    return torch.where(keep, out, float(fill)).to(torch.uint8)


def shear_fast(x: torch.Tensor, values: torch.Tensor, dtype=F32) -> torch.Tensor:
    """The fast shear: white fill, the budget ``ceil(max_shear*h) + 2`` of
    the grid's largest factor, saturating at ``min(budget + 1, w + 2)``."""
    h, w = x.shape[1], x.shape[2]
    budget = int(math.ceil(float(np.abs(rt.grid_f32("shear")).max()) * h)) + 2
    return shear_rows(x, fast_shear_shifts(values, h), 255, min(budget + 1, w + 2), dtype)


# ------------------------------------------------------------- the entry


def apply_all_fast(x: torch.Tensor, draws: dict, dtype=F32) -> dict:
    """{type: transformed [N, H, W, C] u8} of one call of the sweep at the
    fast flags, from the draws of ``transforms.sweep_draws``."""
    out = {}
    v = {t: draws[t][1] for t in rt.TYPES}
    idx = {t: draws[t][0] for t in rt.TYPES}
    out["scale"] = zoom_bilinear(x, v["scale"], dtype)
    out["rotation"] = pil_rotate_nearest(x, v["rotation"])
    out["lighten_darken"] = rt.brightness(x, v["lighten_darken"], dtype)
    out["gaussian_noise"] = rt.gaussian_noise(x, v["gaussian_noise"], draws["noise"], dtype)
    out["translation"] = rt.translate(x, v["translation"],
                                      int(np.abs(rt.grid_f32("translation")).max()))
    out["contrast"] = rt.contrast(x, v["contrast"], dtype)
    table = torch.from_numpy(rt.blur_tap_table(rt.grid_f64("blur"))).to(x.device)
    out["blur"] = rt.blur_8u(x, table[idx["blur"]])
    out["shear"] = shear_fast(x, v["shear"], dtype)
    return out
