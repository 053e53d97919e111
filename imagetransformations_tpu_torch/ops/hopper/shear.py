"""Row shears: Paeth 3-shear parameters, the per-image-angle rotation, and
the per-(image, row) fractional row shift ``shear_rows_logrouted``.

For one angle the angle -> per-row shift math is computed in float64 on the
host and cast to float32, so the shifts are bit-identical to the CPU
oracle's. Per-image angles take device f32 shifts
(``megakernel._traced_params``).

``shear_rows_logrouted`` is the counterpart of the JAX package's
``ops/pallas/shear.py`` entry of that name. On the card the hand-written
kernel ``csrc/shear_rows.cu`` carries it; beside it sits its plain PyTorch
version, which repeats the kernel's f32 arithmetic op for op. A CPU tensor
runs the plain version, a CUDA tensor the kernel (or the call raises);
nothing falls back.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from imagetransformations_tpu_torch.ops.hopper import _lib


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


# ------------------------------------------------- per-(image, row) row shift


def shear_rows_logrouted_plain(x: torch.Tensor, shifts: torch.Tensor, fill: int,
                               b_px: int) -> torch.Tensor:
    """Plain version of ``shear_rows_logrouted``: NHWC u8, f32 shifts
    [n, h], the saturation bound ``b_px``."""
    n, h, w, c = x.shape
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
    return torch.where(keep, out, float(fill)).to(torch.uint8)


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
    if not isinstance(img, torch.Tensor) or img.ndim != 4 or img.dtype != torch.uint8:
        raise ValueError("expected an NHWC uint8 tensor")
    if not 0 <= int(fill) <= 255:
        raise ValueError(f"fill must be a u8 value, got {fill}")
    n, h, w, c = img.shape
    if max_shift_px is None:
        if not isinstance(shifts, np.ndarray):
            raise ValueError("tensor shifts need a max_shift_px bound")
        max_shift_px = int(np.ceil(np.abs(shifts).max())) + 1
    b_px = min(int(max_shift_px) + 1, w + 2)
    s = torch.as_tensor(shifts, dtype=torch.float32, device=img.device)
    s = s.reshape(-1, h).expand(n, h).contiguous()
    x = img.contiguous()
    if x.device.type == "cpu":
        return shear_rows_logrouted_plain(x, s, int(fill), b_px)
    if x.device.type != "cuda":
        raise ValueError(f"kernel wrappers take CPU or CUDA tensors, got {x.device}")
    if h > 65535:
        raise ValueError("shear_rows launches one block row per image row: h <= 65535")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    name = "shear_rows"
    lib = _lib.load(name)
    with torch.cuda.device(x.device):
        err = lib.shear_rows(x.data_ptr(), out.data_ptr(), s.data_ptr(), n, h, w, c, int(fill),
                             b_px, torch.cuda.current_stream(x.device).cuda_stream)
    _lib.check(name, err)
    _lib.LAUNCHES["shear_rows_logrouted"] += 1
    return out
