"""Per-image resampling: PIL AFFINE BICUBIC shear and bilinear centre zoom,
one factor an image (PyTorch + CUDA).

Counterparts of ``imagetransformations_tpu/ops/pallas/resample.py``:

- ``shear_bicubic_batched``: the reference's apply_shear (widened canvas,
  white fill, transformation.py:212-226) cropped back to the input width;
  kernel ``csrc/shear_bicubic.cu``.
- ``zoom_bilinear_batched``: the centre zoom of random_zoom (bilinear,
  clamped 2x2 window, trunc, zero fill); kernel ``csrc/zoom_bilinear.cu``,
  which does the JAX package's two passes in one.

Beside each wrapper sits its plain PyTorch version, which repeats the
kernel's f32 arithmetic op for op. The shear's canvas shift ``ceil(s*h)``
is an integer made in f64 (``canvas_shifts``, ``shear_shift_table``), as
PIL's caller takes it, and handed to both. A CPU tensor runs the plain
version, a CUDA tensor the kernel (or the call raises); nothing falls back.
"""

from __future__ import annotations

import functools
import math

import torch

from imagetransformations_tpu_torch.ops.hopper import _lib


def _check(x: torch.Tensor, factors: torch.Tensor) -> None:
    """A kernel's arguments: a contiguous NHWC u8 CUDA tensor and its
    contiguous f32 [n] factors on the same device."""
    if x.device.type != "cuda":
        raise ValueError(f"kernel wrappers take CPU or CUDA tensors, got {x.device}")
    if x.dtype != torch.uint8 or x.ndim != 4 or not x.is_contiguous():
        raise ValueError("expected a contiguous NHWC uint8 tensor")
    if (factors.device != x.device or factors.dtype != torch.float32
            or factors.shape != (x.shape[0],) or not factors.is_contiguous()):
        raise ValueError("factors must be a contiguous f32 [n] tensor on the image's device")


def canvas_shifts(factors: torch.Tensor, h: int) -> torch.Tensor:
    """The widened canvas's shift of each image, int32 [n] on the factors'
    device: ``ceil(v*h)`` for v > 0, else 0, with v the f64 value of each
    f32 factor and the product taken in f64, as PIL's Python caller does
    (transformation.py:212-226). An IEEE f64 multiply and ceil give the same
    bits on every device. (The JAX kernel takes ``ceil(s*h)`` in f32, which
    moves whole rows by a pixel at some (s, h): h = 10 at s = 0.1 gives 2
    against 1.)"""
    v = factors.to(torch.float64)
    return torch.where(v > 0, torch.ceil(v * float(h)), 0.0).to(torch.int32)


@functools.lru_cache(maxsize=16)
def shear_shift_table(grid: tuple, h: int, device: torch.device) -> torch.Tensor:
    """``ceil(v*h)`` (v > 0, else 0) of each grid value ``v``, a Python
    float (the value the reference hands PIL, before any f32 cast), in
    host f64, as int32 on ``device`` (made once a (grid, h, device)): the
    sweep's shifts, gathered by each image's drawn index."""
    shifts = [math.ceil(v * h) if v > 0 else 0 for v in grid]
    return torch.tensor(shifts, dtype=torch.int32, device=device)


def _shifts_of(factors: torch.Tensor, h: int, shifts) -> torch.Tensor:
    if shifts is None:
        return canvas_shifts(factors, h)
    shifts = torch.as_tensor(shifts, dtype=torch.int32, device=factors.device).reshape(-1)
    if shifts.shape != factors.shape:
        raise ValueError(f"expected {factors.shape[0]} shifts, got shape {tuple(shifts.shape)}")
    return shifts.contiguous()


def shear_bicubic_plain(x: torch.Tensor, factors: torch.Tensor,
                        shifts: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of ``shear_bicubic``: NHWC u8, f32 factors [n], int32
    canvas shifts [n] (default ``canvas_shifts``)."""
    n, h, w, c = x.shape
    s = factors.reshape(n, 1, 1)
    m2 = -_shifts_of(factors.reshape(-1), h, shifts).to(torch.float32).reshape(n, 1, 1)
    xo = torch.arange(w, dtype=torch.float32, device=x.device).view(1, 1, w) + 0.5
    yo = torch.arange(h, dtype=torch.float32, device=x.device).view(1, h, 1) + 0.5
    xx = (xo + s * yo) + m2  # [n, h, w]
    xin = xx - 0.5
    fl = torch.floor(xin)
    x0 = fl.to(torch.int64)
    fx = (xin - fl)[..., None]
    v = x.to(torch.float32)

    def tap(j: int) -> torch.Tensor:
        idx = (x0 + j).clamp(0, w - 1)[..., None].expand(n, h, w, c)
        return torch.gather(v, 2, idx)

    cm1, c0, c1, c2 = tap(-1), tap(0), tap(1), tap(2)
    p2 = -cm1 + c1
    p3 = ((2.0 * (cm1 - c0)) + c1) - c2
    p4 = ((-cm1 + c0) - c1) + c2
    out = c0 + fx * (p2 + fx * (p3 + fx * p4))
    out = torch.where(out <= 0, 0.0, torch.where(out >= 255, 255.0, torch.trunc(out)))
    valid = ((xx >= 0) & (xx < w))[..., None]
    return torch.where(valid, out, 255.0).to(torch.uint8)


def shear_bicubic(x: torch.Tensor, factors: torch.Tensor,
                  shifts: torch.Tensor | None = None) -> torch.Tensor:
    """NHWC u8 -> NHWC u8, one f32 shear factor an image, and its int32
    canvas shift (default ``canvas_shifts(factors, h)``).

    On CUDA: ``csrc/shear_bicubic.cu``; on the CPU: the plain version."""
    if x.device.type == "cpu":
        return shear_bicubic_plain(x, factors, shifts)
    _check(x, factors)
    n, h, w, c = x.shape
    m = _shifts_of(factors, h, shifts)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    name = "shear_bicubic"
    lib = _lib.load(name)
    with torch.cuda.device(x.device):
        err = lib.shear_bicubic(x.data_ptr(), out.data_ptr(), factors.data_ptr(), m.data_ptr(),
                                n, h, w, c, torch.cuda.current_stream(x.device).cuda_stream)
    _lib.check(name, err)
    _lib.LAUNCHES[name] += 1
    return out


def shear_bicubic_batched(img: torch.Tensor, factors, max_shear: float = 1.05,
                          shifts=None) -> torch.Tensor:
    """Reference apply_shear (PIL AFFINE BICUBIC on a widened canvas, white
    fill) cropped back to the input width, with one factor an image in
    [0, max_shear], on the tensor's device. Bit-exact against
    ``apply_shear(...)[:, :, :w]``.

    ``shifts``: each image's canvas shift ``ceil(v*h)`` (int32 [n]) where the
    caller has it (the sweep gathers it by drawn index from
    ``shear_shift_table``); by default ``canvas_shifts`` of the factors.
    ``max_shear`` is the JAX signature's routing budget; the CUDA kernel
    gathers its taps directly and needs none, so it only documents the
    range the caller promises."""
    if not isinstance(img, torch.Tensor) or img.ndim != 4 or img.dtype != torch.uint8:
        raise ValueError("expected an NHWC uint8 tensor")
    f = torch.as_tensor(factors, dtype=torch.float32, device=img.device).reshape(-1)
    if f.numel() == 1:
        f = f.expand(img.shape[0])
    return shear_bicubic(img.contiguous(), f.contiguous(), shifts)


# ------------------------------------------------------------ bilinear zoom


def zoom_axis(inv: torch.Tensor, dim: int):
    """Source coordinates along one axis of size ``dim`` for per-image
    ``inv = 1/f`` [n, 1] f32, in the kernel's op order (JAX ``_coords``):
    (i0, i1 int64 [n, dim] clamped taps, frac f32 [n, dim], valid bool
    [n, dim])."""
    pos = torch.arange(dim, dtype=torch.float32, device=inv.device) + 0.5
    half = dim / 2.0
    m = half - inv * half
    src = inv * pos + m
    sm = src - 0.5
    s0 = torch.floor(sm)
    frac = sm - s0
    # clamped in f32 before the conversion, as the kernel does
    i0 = torch.clamp(s0, 0.0, dim - 1.0).to(torch.int64)
    i1 = torch.clamp(s0 + 1.0, 0.0, dim - 1.0).to(torch.int64)
    return i0, i1, frac, (src >= 0) & (src < dim)


def zoom_bilinear_plain(x: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """Plain version of ``zoom_bilinear``: NHWC u8, f32 factors [n]. The
    JAX package's two passes: rows lerped along x (0 where x is not
    valid), then those lerped along y, trunc, clip, 0 where y is not
    valid."""
    n, h, w, c = x.shape
    inv = 1.0 / factors.reshape(n, 1)
    x0, x1, fx, vx = zoom_axis(inv, w)
    y0, y1, fy, vy = zoom_axis(inv, h)
    v = x.to(torch.float32)

    def hpass(rows: torch.Tensor) -> torch.Tensor:
        # source rows y0 or y1 of each output row, lerped along x: [n, h, w, c]
        r = torch.gather(v, 1, rows[:, :, None, None].expand(n, h, w, c))
        a = torch.gather(r, 2, x0[:, None, :, None].expand(n, h, w, c))
        b = torch.gather(r, 2, x1[:, None, :, None].expand(n, h, w, c))
        out = a + fx[:, None, :, None] * (b - a)
        return torch.where(vx[:, None, :, None], out, 0.0)

    top, bot = hpass(y0), hpass(y1)
    out = top + fy[:, :, None, None] * (bot - top)
    out = torch.clamp(torch.trunc(out), 0.0, 255.0)
    return torch.where(vy[:, :, None, None], out, 0.0).to(torch.uint8)


def zoom_bilinear(x: torch.Tensor, factors: torch.Tensor) -> torch.Tensor:
    """NHWC u8 -> NHWC u8, one f32 zoom factor an image.

    On CUDA: ``csrc/zoom_bilinear.cu``; on the CPU: the plain version."""
    if x.device.type == "cpu":
        return zoom_bilinear_plain(x, factors)
    _check(x, factors)
    n, h, w, c = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    name = "zoom_bilinear"
    lib = _lib.load(name)
    with torch.cuda.device(x.device):
        err = lib.zoom_bilinear(x.data_ptr(), out.data_ptr(), factors.data_ptr(), n, h, w, c,
                                torch.cuda.current_stream(x.device).cuda_stream)
    _lib.check(name, err)
    _lib.LAUNCHES[name] += 1
    return out


def zoom_bilinear_batched(img: torch.Tensor, factors, min_factor: float = 0.85,
                          max_factor: float = 1.45) -> torch.Tensor:
    """Centre zoom with one factor an image (random_zoom's bilinear warp of
    ``zoom_matrix``, zero fill), on the tensor's device. NHWC u8 -> u8.

    ``min_factor`` and ``max_factor`` are the JAX signature's roll budget:
    the factors the caller promises. The CUDA kernel gathers its taps
    directly and needs no budget, so they only document the range; any
    positive factor gives the same function."""
    if not isinstance(img, torch.Tensor) or img.ndim != 4 or img.dtype != torch.uint8:
        raise ValueError("expected an NHWC uint8 tensor")
    del min_factor, max_factor  # documentation only (see above)
    f = torch.as_tensor(factors, dtype=torch.float32, device=img.device).reshape(-1)
    if f.numel() == 1:
        f = f.expand(img.shape[0])
    return zoom_bilinear(img.contiguous(), f.contiguous())
