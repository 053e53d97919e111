"""PIL-exact NEAREST rotation with one angle an image (PyTorch + CUDA).

Counterpart of ``imagetransformations_tpu/ops/pallas/rotate_gather.py``
``pil_rotate_nearest_batched``: the reference's apply_rotation, Pillow's
``Image.rotate(-angle)`` NEAREST with black fill (transformation.py:198-201).
Pillow maps NEAREST affine transforms in 16.16 fixed point (Geometry.c
``affine_fixed``), and so does this module, at any angle:

- ``pil_rotate_coeffs`` builds Pillow's f64 matrix on the host with Python
  ``math``, as ``Image.rotate`` does, and rounds it to six integers
  ``FIX(v) = floor(v * 65536 + 0.5)``: a0 = FIX(m0), a1 = FIX(m1),
  a2 = FIX(m2 + m0/2 + m1/2), a3 = FIX(m3), a4 = FIX(m4),
  a5 = FIX(m5 + m3/2 + m4/2).
- Output pixel (x, y) reads source pixel ``(xx >> 16, yy >> 16)`` with
  ``xx = a2 + y*a1 + x*a0`` and ``yy = a5 + y*a4 + x*a3`` in wrapping
  32-bit arithmetic (Pillow adds a0 / a3 a pixel and a1 / a4 a row in
  INT32), inside ``0 <= xin < w`` and ``0 <= yin < h``, else ``fill``.
- Where a corner coordinate reaches 32768 (Pillow's ``check_fixed`` fails;
  only widths or heights near 32768 get there), Pillow takes a float path:
  f64 coordinates from ``m2 + m1/2 + m0/2`` and ``m5 + m4/2 + m3/2``, one
  add of m0 / m3 a pixel and of m1 / m4 a row, in that order, and
  ``COORD(v) = v < 0 ? -1 : (int)v``. Such angles are flagged and run that
  route.

On the card the hand-written kernel ``csrc/rotate_nearest.cu`` runs both.
The Pallas kernel's two-pass roll routing and its host-side proof
(``_budgets``, ``_host_bounds_check``) exist only because Mosaic has no
vector gather, and are not ported; the JAX package computes f32
coordinates, which differ from Pillow on up to ~2.4% of pixels beyond 45
degrees (ROADMAP C.2.9).

Beside the wrapper sits its plain PyTorch version, which computes the same
integers and the same f64 adds. A CPU tensor runs the plain version, a
CUDA tensor the kernel (or the call raises); nothing falls back.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from imagetransformations_tpu_torch.ops.hopper import _lib

FIX_LIMIT = 32768.0  # Pillow's check_fixed: |corner coordinate| below this


def pil_rotate_matrix(angle_deg: float, w: int, h: int) -> tuple:
    """PIL Image.rotate(angle, expand=False) inverse-map matrix, float64 on
    the host (PIL negates the angle; the reference's apply_rotation(img, a)
    is ``pil_rotate_matrix(-a, ...)``)."""
    angle = -math.radians(angle_deg % 360.0)
    m = [
        round(math.cos(angle), 15),
        round(math.sin(angle), 15),
        0.0,
        round(-math.sin(angle), 15),
        round(math.cos(angle), 15),
        0.0,
    ]
    cx, cy = w / 2.0, h / 2.0
    m[2] = m[0] * (-cx) + m[1] * (-cy) + cx
    m[5] = m[3] * (-cx) + m[4] * (-cy) + cy
    return tuple(m)


class RotateCoeffs(NamedTuple):
    """Pillow's NEAREST rotation coefficients, one row an angle (host arrays).

    ``fixed``: int32 [k, 6] a0..a5 in 16.16 (wrapped to 32 bits where a
    flagged angle's do not fit); ``flagged``: bool [k], a corner fails
    ``check_fixed`` and the angle takes the float path; ``start``: f64
    [k, 2] that path's first coordinates (xo, yo); ``step``: f64 [k, 4]
    its steps m0, m3 (a pixel) and m1, m4 (a row)."""

    fixed: np.ndarray
    flagged: np.ndarray
    start: np.ndarray
    step: np.ndarray


class FloatPath(NamedTuple):
    """The flagged images of a batch and their f64 coordinates, on the
    images' device: ``images`` int32 [m] (ascending), ``rows`` f64
    [m, h, 2] each row's first (xx, yy), accumulated one row at a time on
    the host; ``steps`` f64 [m, 2] the per-pixel adds (m0, m3)."""

    images: torch.Tensor
    rows: torch.Tensor
    steps: torch.Tensor


def _fix(v: float) -> int:
    return math.floor(v * 65536.0 + 0.5)


def _wrap32(v: int) -> int:
    return (v + 2**31) % 2**32 - 2**31


def host_angles(angles_deg) -> np.ndarray:
    """Angles as f64 [k] on the host: a Python number, a numpy array or a
    tensor (a CUDA tensor costs one device-to-host copy). An f32 value is
    taken exactly (``float(v)``)."""
    if isinstance(angles_deg, torch.Tensor):
        angles_deg = angles_deg.detach().cpu().numpy()
    a = np.asarray(angles_deg).astype(np.float64).reshape(-1)
    if not np.isfinite(a).all():
        raise ValueError("rotation angles must be finite")
    return a


@functools.lru_cache(maxsize=4096)
def _coeff_row(angle: float, w: int, h: int) -> np.ndarray:
    """f64 [13] of one angle: fixed (6, exact in f64), flagged, start (2),
    step (4); see ``RotateCoeffs``."""
    m0, m1, m2, m3, m4, m5 = pil_rotate_matrix(-angle, w, h)
    fixed = (_fix(m0), _fix(m1), _fix(m2 + m0 * 0.5 + m1 * 0.5),
             _fix(m3), _fix(m4), _fix(m5 + m3 * 0.5 + m4 * 0.5))
    flagged = not all(abs(cx * m0 + cy * m1 + m2) < FIX_LIMIT
                      and abs(cx * m3 + cy * m4 + m5) < FIX_LIMIT
                      for cx, cy in ((0, 0), (w, h), (0, h), (w, 0)))
    row = np.array([*(_wrap32(v) for v in fixed), flagged, m2 + m1 * 0.5 + m0 * 0.5,
                    m5 + m4 * 0.5 + m3 * 0.5, m0, m3, m1, m4], np.float64)
    row.flags.writeable = False
    return row


def pil_rotate_coeffs(angles_deg, w: int, h: int) -> RotateCoeffs:
    """Pillow's coefficients of ``Image.rotate(-a, NEAREST)`` on a w x h
    image for each angle ``a`` (degrees; see ``host_angles``), computed in
    Python f64 as Pillow computes them (kept for each angle, w and h)."""
    t = np.array([_coeff_row(v, int(w), int(h)) for v in host_angles(angles_deg).tolist()],
                 np.float64).reshape(-1, 13)
    return RotateCoeffs(t[:, :6].astype(np.int32), t[:, 6] != 0, t[:, 7:9], t[:, 9:])


def float_path(co: RotateCoeffs, rows_of_images: np.ndarray, h: int, device) -> FloatPath | None:
    """The float path of a batch whose image i takes coefficient row
    ``rows_of_images[i]`` of ``co``; None when no image is flagged. Row
    starts are Pillow's sequential f64 sums (``np.add.accumulate``)."""
    images = np.nonzero(co.flagged[rows_of_images])[0]
    if images.size == 0:
        return None
    rows = np.empty((images.size, h, 2), np.float64)
    for j, r in enumerate(rows_of_images[images].tolist()):
        for axis, d in ((0, co.step[r, 2]), (1, co.step[r, 3])):
            seq = np.full(h, d)
            seq[0] = co.start[r, axis]
            rows[j, :, axis] = np.add.accumulate(seq)
    steps = co.step[rows_of_images[images], :2]
    return FloatPath(torch.from_numpy(images.astype(np.int32)).to(device),
                     torch.from_numpy(rows).to(device),
                     torch.from_numpy(np.ascontiguousarray(steps)).to(device))


def _wrap_shift(v: torch.Tensor) -> torch.Tensor:
    """int64 sums as Pillow's INT32 accumulators hold them, shifted right
    by 16 (arithmetic)."""
    return (((v + 2**31) & 0xFFFFFFFF) - 2**31) >> 16


def pil_rotate_nearest_plain(x: torch.Tensor, coeffs: torch.Tensor, fill: int,
                             fp: FloatPath | None = None) -> torch.Tensor:
    """Plain version of ``pil_rotate_nearest``: NHWC u8, int32 [n, 6] (or
    [1, 6]) coefficients, the float path's images where flagged."""
    n, h, w, c = x.shape
    k = coeffs.to(torch.int64).expand(n, 6).reshape(n, 6, 1, 1)
    xs = torch.arange(w, dtype=torch.int64, device=x.device).view(1, 1, w)
    ys = torch.arange(h, dtype=torch.int64, device=x.device).view(1, h, 1)
    xin = _wrap_shift(k[:, 2] + ys * k[:, 1] + xs * k[:, 0])
    yin = _wrap_shift(k[:, 5] + ys * k[:, 4] + xs * k[:, 3])
    valid = (xin >= 0) & (xin < w) & (yin >= 0) & (yin < h)
    if fp is not None and fp.images.numel():
        idx = fp.images.to(torch.int64)
        xf = torch.empty((idx.numel(), h, w), dtype=torch.float64, device=x.device)
        yf = torch.empty_like(xf)
        cx, cy = fp.rows[:, :, 0].clone(), fp.rows[:, :, 1].clone()
        sx, sy = fp.steps[:, 0:1], fp.steps[:, 1:2]
        for i in range(w):  # one f64 add a pixel along each row, as Pillow
            xf[:, :, i], yf[:, :, i] = cx, cy
            cx, cy = cx + sx, cy + sy
        # COORD(v) inside [0, dim) exactly where 0 <= v < dim
        ok = (xf >= 0) & (xf < w) & (yf >= 0) & (yf < h)
        xin[idx] = torch.where(ok, xf, 0.0).to(torch.int64)
        yin[idx] = torch.where(ok, yf, 0.0).to(torch.int64)
        valid[idx] = ok
    xi = torch.where(valid, xin, 0)
    yi = torch.where(valid, yin, 0)
    out = x[torch.arange(n, device=x.device).view(n, 1, 1), yi, xi]
    return torch.where(valid[..., None], out, torch.tensor(fill, dtype=torch.uint8,
                                                           device=x.device))


def pil_rotate_nearest(x: torch.Tensor, coeffs: torch.Tensor, fill: int = 0,
                       fp: FloatPath | None = None) -> torch.Tensor:
    """NHWC u8 -> NHWC u8 by Pillow's fixed-point NEAREST rotation.

    ``coeffs``: int32 [n, 6] a0..a5 of each image, or one row for the batch
    (``expand(n, 6)``, stride 0); ``fp``: the flagged images' float path.
    On CUDA: ``csrc/rotate_nearest.cu``; on the CPU: the plain version."""
    if not 0 <= int(fill) <= 255:
        raise ValueError(f"fill must be a u8 value, got {fill}")
    if x.device.type == "cpu":
        return pil_rotate_nearest_plain(x, coeffs, int(fill), fp)
    if x.device.type != "cuda":
        raise ValueError(f"kernel wrappers take CPU or CUDA tensors, got {x.device}")
    if x.dtype != torch.uint8 or x.ndim != 4 or not x.is_contiguous():
        raise ValueError("expected a contiguous NHWC uint8 tensor")
    n, h, w, c = x.shape
    if (coeffs.device != x.device or coeffs.dtype != torch.int32 or coeffs.shape != (n, 6)
            or coeffs.stride(1) != 1 or coeffs.stride(0) not in (0, 6)):
        raise ValueError("coeffs must be int32 [n, 6] on the image's device, rows 6 or 0 apart")
    m = 0 if fp is None else fp.images.numel()
    if m and (fp.images.device != x.device or fp.images.dtype != torch.int32
              or fp.rows.dtype != torch.float64 or fp.rows.shape != (m, h, 2)
              or fp.steps.dtype != torch.float64 or fp.steps.shape != (m, 2)
              or fp.rows.device != x.device or fp.steps.device != x.device
              or not (fp.images.is_contiguous() and fp.rows.is_contiguous()
                      and fp.steps.is_contiguous())):
        raise ValueError("fp must hold int32 [m], f64 [m, h, 2] and f64 [m, 2] contiguous "
                         "tensors on the image's device")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    name = "rotate_nearest"
    lib = _lib.load(name)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = 0
        if m < n:  # every image flagged: the float route writes them all
            err = lib.rotate_nearest(x.data_ptr(), out.data_ptr(), coeffs.data_ptr(),
                                     coeffs.stride(0), n, h, w, c, int(fill), stream)
        if err == 0 and m:
            err = lib.rotate_nearest_float(x.data_ptr(), out.data_ptr(), fp.images.data_ptr(),
                                           fp.rows.data_ptr(), fp.steps.data_ptr(), m, h, w, c,
                                           int(fill), stream)
    _lib.check(name, err)
    _lib.LAUNCHES["pil_rotate_nearest"] += 1
    return out


def pil_rotate_nearest_batched(img: torch.Tensor, angles_deg, fill: int = 0,
                               max_angle_deg: float = 45.0) -> torch.Tensor:
    """Pillow's ``rotate(-a, NEAREST)`` with one angle an image (or one for
    the batch), on the tensor's device. NHWC u8 -> u8.

    The coefficients are computed on the host in f64, once an angle value
    (``pil_rotate_coeffs``): Python numbers, numpy arrays and CPU tensors
    go there directly; a CUDA angle tensor costs one device-to-host copy.
    ``max_angle_deg`` is the JAX signature's routing budget: the integer
    gather is exact at any angle, so it only documents the range the
    caller promises."""
    if not isinstance(img, torch.Tensor) or img.ndim != 4 or img.dtype != torch.uint8:
        raise ValueError("expected an NHWC uint8 tensor")
    del max_angle_deg  # documentation only (see above)
    n, h, w, _ = img.shape
    a = host_angles(angles_deg)
    if a.size not in (1, n):
        raise ValueError(f"expected one angle or one an image ({n}), got {a.size}")
    values = np.unique(a)  # each value's coefficients once
    co = pil_rotate_coeffs(values, w, h)
    if values.size == 1:
        rows = np.zeros(n, np.int64)
        fixed = torch.from_numpy(co.fixed).to(img.device).expand(n, 6)
    else:
        rows = torch.searchsorted(torch.from_numpy(values), torch.from_numpy(a)).numpy()
        fixed = torch.from_numpy(np.take(co.fixed, rows, axis=0)).to(img.device)
    fp = float_path(co, rows, h, img.device) if co.flagged.any() else None
    return pil_rotate_nearest(img.contiguous(), fixed, fill, fp)
