"""Row shears: Paeth 3-shear parameters, the fractional row shifts and the
3-shear rotations built on them.

For one angle the angle -> per-row shift math is computed in float64 on the
host and cast to float32, so the shifts are bit-identical to the CPU
oracle's. Per-image angles take device f32 shifts
(``megakernel._traced_params``).

Counterparts of the JAX package's ``ops/pallas/shear.py`` entry points:
``shear_rows`` (one shift a row for the batch, optional grayscale post-op),
``shear_rows_per_image`` (a shift a row and image), ``shear_rows_logrouted``
(the same, with the log-routed kernel's saturation bound), and the
rotations ``rotate_3shear`` (a row pass, a column pass, a row pass),
``blur_rotate_fused`` (``blur_separable``, then ``rotate_3shear``) and
``rotate_3shear_batched``. On the card one hand-written library,
``csrc/shear_rows.cu``, carries all three row shifts and the column pass
(the Pallas rotation runs that pass as a row shift between two transposes,
a TPU layout need); beside each sits its plain PyTorch version, which
repeats the kernel's f32 arithmetic op for op. A CPU tensor runs the plain version, a CUDA tensor
the kernel (or the call raises); nothing falls back.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from imagetransformations_tpu_torch.ops.hopper import _lib
from imagetransformations_tpu_torch.ops.hopper.blur import blur_separable
from imagetransformations_tpu_torch.ops.stencil import gaussian_blur_plain

_LUMA_WEIGHTS = (19595, 38470, 7471)  # PIL L24 weights of R, G, B


def _paeth_params(angle_deg: float) -> tuple[float, float]:
    # negated so a positive angle matches PIL rotate(-angle), the sign
    # convention of the reference's apply_rotation
    t = math.radians(-angle_deg)
    return -math.tan(t / 2.0), math.sin(t)


def _row_shifts(size: int, slope: float, center: float) -> np.ndarray:
    y = np.arange(size, dtype=np.float64) + 0.5
    return (slope * (y - center)).astype(np.float32)


def rotate_3shear_batched(img, angles_deg, fill: int = 0, max_angle_deg: float = 45.0):
    """One rotation angle an image by three shears with the reference's
    per-pass u8 trunc (oracle fast_warp.rotate_3shear), on the tensor's
    device. A max |angle| beyond ``max_angle_deg`` raises ValueError.

    Delegates to ``fused_blur_rotate_batched`` at radius 0, strict (which
    checks the budget), as the JAX package's ``rotate_3shear_batched``
    does."""
    # imported here: megakernel imports this module at its top
    from imagetransformations_tpu_torch.ops.hopper.megakernel import fused_blur_rotate_batched

    return fused_blur_rotate_batched(img, 0.0, angles_deg, fill=fill, grayscale_out=False,
                                     stream=False, max_angle_deg=float(max_angle_deg))


# ---------------------------------------------------------------- row shifts


def shear_rows_plain(x: torch.Tensor, shifts: torch.Tensor, fill: int, b_px: int,
                     grayscale: bool = False) -> torch.Tensor:
    """Plain version of the ``shear_rows`` library, and so of
    ``shear_rows``, ``shear_rows_per_image`` and ``shear_rows_logrouted``:
    NHWC u8, f32 shifts [n, h] (or [h] for the batch), the saturation bound
    ``b_px``; with
    ``grayscale`` (3 channels) PIL L24 luma of each shifted pixel in all
    three channels."""
    n, h, w, c = x.shape
    shifts = shifts.reshape(-1, h).expand(n, h)
    k = torch.floor(shifts)
    f = (shifts - k)[..., None, None]  # [n, h, 1, 1]
    ki = torch.clamp(k, -b_px, b_px).to(torch.int64)[..., None]  # [n, h, 1]
    j = torch.arange(w, device=x.device).view(1, 1, w) + ki  # left tap, [n, h, w]
    v = x.to(torch.float32)

    def tap(idx: torch.Tensor) -> torch.Tensor:
        got = torch.gather(v, 2, idx.clamp(0, w - 1)[..., None].expand(n, h, w, c))
        return torch.where(((idx >= 0) & (idx < w))[..., None], got, float(fill))

    a, b = tap(j), tap(j + 1)
    out = torch.trunc(a + f * (b - a))  # between a and b: no clip
    keep = ((j >= -1) & (j <= w - 1))[..., None]
    out = torch.where(keep, out, float(fill)).to(torch.uint8)
    if not grayscale:
        return out
    q = out.to(torch.int32)
    wr, wg, wb = _LUMA_WEIGHTS
    luma = ((q[..., 1] * wg + q[..., 0] * wr + q[..., 2] * wb + 32768) >> 16).to(torch.uint8)
    return luma[..., None].expand(n, h, w, 3).contiguous()


def shear_cols_plain(x: torch.Tensor, shifts: torch.Tensor, fill: int,
                     b_px: int) -> torch.Tensor:
    """Plain version of the column pass: column x of NHWC u8 ``x`` shifted
    along y by the f32 ``shifts[x]`` ([w], one vector for the batch), the
    lerp, trunc, fill, saturation at +-``b_px`` and border fill-lerps of
    ``shear_rows_plain`` with h in the place of w. A gather along y: equal
    to transposing h and w, ``shear_rows_plain``, transposing back."""
    n, h, w, c = x.shape
    k = torch.floor(shifts)
    f = (shifts - k).view(1, 1, w, 1)
    ki = torch.clamp(k, -b_px, b_px).to(torch.int64).view(1, w)
    j = torch.arange(h, device=x.device).view(h, 1) + ki  # upper tap, [h, w]
    v = x.to(torch.float32)

    def tap(idx: torch.Tensor) -> torch.Tensor:
        got = torch.gather(v, 1, idx.clamp(0, h - 1).view(1, h, w, 1).expand(n, h, w, c))
        return torch.where(((idx >= 0) & (idx < h)).view(1, h, w, 1), got, float(fill))

    a, b = tap(j), tap(j + 1)
    out = torch.trunc(a + f * (b - a))  # between a and b: no clip
    keep = ((j >= -1) & (j <= h - 1)).view(1, h, w, 1)
    return torch.where(keep, out, float(fill)).to(torch.uint8)


def _check_u8(img, fill: int) -> None:
    if not isinstance(img, torch.Tensor) or img.ndim != 4 or img.dtype != torch.uint8:
        raise ValueError("expected an NHWC uint8 tensor")
    if not 0 <= int(fill) <= 255:
        raise ValueError(f"fill must be a u8 value, got {fill}")


def _shift_bound(shifts, pad_px) -> int:
    """``pad_px`` as given, else ``ceil(max|s|) + 1`` (the JAX rule), read
    on the host (a device tensor's read waits for its queue)."""
    if pad_px is not None:
        return int(pad_px)
    amax = float(torch.as_tensor(shifts, dtype=torch.float32).abs().max())
    return int(math.ceil(amax)) + 1


def _row_shift(x: torch.Tensor, s: torch.Tensor, fill: int, b_px: int, grayscale: bool,
               counter: str) -> torch.Tensor:
    """Run the ``shear_rows`` library on NHWC u8 ``x`` with f32 shifts
    ``s`` ([h] for the batch or [n, h]): the plain version on the CPU, the
    kernel on CUDA, counted under ``counter``."""
    n, h, w, c = x.shape
    if grayscale and c != 3:
        raise ValueError("the grayscale post-op needs 3 channels")
    if x.device.type == "cpu":
        return shear_rows_plain(x, s, fill, b_px, grayscale)
    if x.device.type != "cuda":
        raise ValueError(f"kernel wrappers take CPU or CUDA tensors, got {x.device}")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    stride = 0 if s.ndim == 1 else h
    name = "shear_rows"
    lib = _lib.load(name)
    with torch.cuda.device(x.device):
        err = lib.shear_rows(x.data_ptr(), out.data_ptr(), s.data_ptr(), stride, n, h, w, c,
                             int(fill), int(b_px), int(grayscale),
                             torch.cuda.current_stream(x.device).cuda_stream)
    _lib.check(name, err)
    _lib.LAUNCHES[counter] += 1
    return out


def shear_rows(img: torch.Tensor, shifts, fill: int = 0, pad_px: int | None = None,
               postop: str | None = None) -> torch.Tensor:
    """Shift each row y of an NHWC u8 batch horizontally by ``shifts[y]``
    pixels (one f32 [h] vector shared by the batch), bilinear along x,
    ``fill`` outside, on the tensor's device:
    ``out[n, y, x] = trunc(lerp(in[x+k], in[x+k+1], s - k))``, k = floor(s).

    ``pad_px`` bounds |shift| (default ``ceil(max|s|) + 1``). Integer
    shifts beyond it saturate at
    +-max(pad_px, 1), as ``shear_rows_per_image`` does; the Pallas kernel
    wraps its lane roll there instead (undefined output). ``postop=
    "grayscale"`` (3 channels) replaces each pixel by its PIL L24 luma.

    On CUDA: ``csrc/shear_rows.cu``; on the CPU: the plain version."""
    _check_u8(img, fill)
    if postop not in (None, "grayscale"):
        raise ValueError(f"unknown postop {postop!r}")
    n, h, w, c = img.shape
    b_px = max(_shift_bound(shifts, pad_px), 1)
    s = torch.as_tensor(shifts, dtype=torch.float32, device=img.device)
    if s.shape != (h,):
        raise ValueError(f"expected {h} shifts, got {tuple(s.shape)}")
    return _row_shift(img.contiguous(), s.contiguous(), int(fill), b_px,
                      postop == "grayscale", "shear_rows")


def shear_rows_per_image(img: torch.Tensor, shifts, fill: int = 0,
                         pad_px: int | None = None) -> torch.Tensor:
    """``shear_rows`` with one shift per (image, row): f32 ``shifts``
    [n, h]. Integer shifts saturate at +-max(pad_px, 1), as the JAX
    function clips them. ``pad_px`` defaults to ``ceil(max|s|) + 1`` of
    numpy shifts; tensor shifts need it, as traced shifts do in JAX.

    On CUDA: ``csrc/shear_rows.cu``; on the CPU: the plain version."""
    _check_u8(img, fill)
    n, h, w, c = img.shape
    if pad_px is None and not isinstance(shifts, np.ndarray):
        raise ValueError("tensor shifts need a static pad_px bound")
    b_px = max(_shift_bound(shifts, pad_px), 1)
    s = torch.as_tensor(shifts, dtype=torch.float32, device=img.device)
    if s.shape != (n, h):
        raise ValueError(f"expected [{n}, {h}] shifts, got {tuple(s.shape)}")
    return _row_shift(img.contiguous(), s.contiguous(), int(fill), b_px, False,
                      "shear_rows_per_image")


def shear_rows_logrouted(img: torch.Tensor, shifts, fill: int = 0,
                         max_shift_px: int | None = None) -> torch.Tensor:
    """Per-(image, row) fractional shifts, on the tensor's device:
    ``out[n, y, x] = trunc(lerp(in[x+k], in[x+k+1], s - k))`` with
    ``k = floor(s)``, ``fill`` outside the source row, and both border
    pixels (``x+k == -1``, ``x+k == w-1``) lerped against ``fill``.

    NHWC u8 ``img``; ``shifts`` f32 [n, h] (or [1, h] for the batch), a
    tensor or a numpy array. Integer shifts saturate at +-``b_px``,
    ``b_px = min(max_shift_px + 1, w + 2)``, as the JAX kernel's routing
    budget makes them. ``max_shift_px=None`` takes ``ceil(max|s|) + 1`` of
    numpy shifts; tensor shifts need the bound (ValueError), as traced
    shifts do in JAX.

    On CUDA: ``csrc/shear_rows.cu``; on the CPU: the plain version."""
    _check_u8(img, fill)
    n, h, w, c = img.shape
    if max_shift_px is None:
        if not isinstance(shifts, np.ndarray):
            raise ValueError("tensor shifts need a max_shift_px bound")
        max_shift_px = int(np.ceil(np.abs(shifts).max())) + 1
    b_px = min(int(max_shift_px) + 1, w + 2)
    s = torch.as_tensor(shifts, dtype=torch.float32, device=img.device)
    s = s.reshape(-1, h).expand(n, h).contiguous()
    return _row_shift(img.contiguous(), s, int(fill), b_px, False, "shear_rows_logrouted")


def _col_shift(x: torch.Tensor, s: torch.Tensor, fill: int, b_px: int) -> torch.Tensor:
    """The column pass on NHWC u8 ``x`` with shifts ``s`` [w] (taken as
    f32 on ``x``'s device): the plain version on the CPU, the
    ``shear_cols`` kernel on CUDA, counted under "shear_cols" and under
    "shear_rows" (the pass of kernel #7 it carries)."""
    _check_u8(x, fill)
    n, h, w, c = x.shape
    s = torch.as_tensor(s, dtype=torch.float32, device=x.device).contiguous()
    if s.shape != (w,):
        raise ValueError(f"expected {w} column shifts, got {tuple(s.shape)}")
    if x.device.type == "cpu":
        return shear_cols_plain(x, s, fill, b_px)
    if x.device.type != "cuda":
        raise ValueError(f"kernel wrappers take CPU or CUDA tensors, got {x.device}")
    x = x.contiguous()
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = _lib.load("shear_rows")
    with torch.cuda.device(x.device):
        err = lib.shear_cols(x.data_ptr(), out.data_ptr(), s.data_ptr(), n, h, w, c,
                             int(fill), int(b_px),
                             torch.cuda.current_stream(x.device).cuda_stream)
    _lib.check("shear_cols", err)
    _lib.LAUNCHES["shear_cols"] += 1
    _lib.LAUNCHES["shear_rows"] += 1
    return out


# ---------------------------------------------------------------- 3-shear rotation


def _swap_hw(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(1, 2).contiguous()


@functools.lru_cache(maxsize=64)
def _rotation_shifts(h: int, w: int, angle_deg: float, device: torch.device):
    """(sx f32 [h], its bound, sy f32 [w], its bound) on ``device`` for the
    three passes: host-f64 ``_row_shifts`` cast to f32, each bound
    ``ceil(max|s|) + 1``. Cached, so a repeated call copies nothing."""
    a, b = _paeth_params(angle_deg)
    sx = _row_shifts(h, a, h / 2.0)
    sy = _row_shifts(w, b, w / 2.0)
    return (torch.from_numpy(sx).to(device), _shift_bound(sx, None),
            torch.from_numpy(sy).to(device), _shift_bound(sy, None))


def _rotate_3shear(img: torch.Tensor, angle_deg: float, fill: int, grayscale_out: bool,
                   rows, cols) -> torch.Tensor:
    _check_u8(img, fill)
    n, h, w, c = img.shape
    sx, bx, sy, by = _rotation_shifts(h, w, float(angle_deg), img.device)
    y1 = rows(img, sx, bx, fill, None)
    y2 = cols(y1, sy, by, fill)
    return rows(y2, sx, bx, fill, "grayscale" if grayscale_out else None)


def rotate_3shear(img: torch.Tensor, angle_deg: float, fill: int = 0,
                  grayscale_out: bool = False) -> torch.Tensor:
    """Rotate an NHWC u8 batch by ``angle_deg`` (the reference's
    apply_rotation sign convention) by three shears: x by row
    (``shear_rows``), y by column (the column pass, in place: no
    transpose), x by row, u8 trunc after each. Shifts are the host-f64
    ``_row_shifts`` cast to f32, each pass's bound ``ceil(max|s|) + 1``.
    ``grayscale_out`` rides on pass 3. Any angle. Three kernel launches on
    CUDA.

    Oracle: ``fast_warp.rotate_3shear`` (then PIL grayscale)."""
    return _rotate_3shear(img, angle_deg, fill, grayscale_out,
                          lambda x, s, b, f, postop: shear_rows(x, s, f, b, postop),
                          lambda x, s, b, f: _col_shift(x, s, f, max(b, 1)))


def rotate_3shear_plain(img: torch.Tensor, angle_deg: float, fill: int = 0,
                        grayscale_out: bool = False) -> torch.Tensor:
    """Plain version of ``rotate_3shear`` on the tensor's device: the same
    passes through ``shear_rows_plain``, the middle one as a row shift of
    the transposed batch (the Pallas kernel's way), so it also holds the
    column pass to its transposed form."""
    return _rotate_3shear(
        img, angle_deg, fill, grayscale_out,
        lambda x, s, b, f, postop: shear_rows_plain(x, s, f, max(b, 1), postop == "grayscale"),
        lambda x, s, b, f: _swap_hw(shear_rows_plain(_swap_hw(x), s, f, max(b, 1))))


def blur_rotate_fused(img: torch.Tensor, radius: float, angle_deg: float, fill: int = 0,
                      grayscale_out: bool = False) -> torch.Tensor:
    """Blur -> 3-shear rotation (-> grayscale): ``blur_separable`` then
    ``rotate_3shear``, the function of the JAX entry (which fuses the
    blur's output layout into the first shear's input)."""
    return rotate_3shear(blur_separable(img, float(radius)), angle_deg, fill, grayscale_out)


def blur_rotate_fused_plain(img: torch.Tensor, radius: float, angle_deg: float, fill: int = 0,
                            grayscale_out: bool = False) -> torch.Tensor:
    """Plain version of ``blur_rotate_fused`` on the tensor's device."""
    return rotate_3shear_plain(gaussian_blur_plain(img, float(radius)), angle_deg, fill,
                               grayscale_out)
