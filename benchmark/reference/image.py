"""Image helpers of the reference: frozen copies of the port's
``core/image.py`` (layout, u8 rounding, correctly rounded trig) and of
``ops/stencil.py``'s reflect index and cv2 Gaussian taps.

NHWC, ``uint8`` at the boundary, ``float32`` in [0, 255] inside."""

from __future__ import annotations

import numpy as np
import torch


def as_batch(x: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """Promote HWC -> NHWC. Returns (batched tensor, was_single)."""
    if x.ndim == 3:
        return x[None], True
    if x.ndim != 4:
        raise ValueError(f"expected HWC or NHWC image tensor, got shape {tuple(x.shape)}")
    return x, False


def restore_layout(x: torch.Tensor, was_single: bool) -> torch.Tensor:
    return x[0] if was_single else x


def as_float(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] -> float32 [0,255] (identity for float32 inputs)."""
    return x if x.dtype == torch.float32 else x.to(torch.float32)


def trig_f32(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` of the f32 tensor ``x`` taken in f64 and rounded to f32: the
    correctly rounded value, the same on every device."""
    return fn(x.to(torch.float64)).to(torch.float32)


def to_uint8_trunc(x: torch.Tensor) -> torch.Tensor:
    """clip to [0,255] then truncate toward zero (PIL blend C-cast)."""
    return torch.clamp(torch.trunc(x), 0.0, 255.0).to(torch.uint8)


def to_uint8_rint(x: torch.Tensor) -> torch.Tensor:
    """round-half-even then clip (cv2.convertScaleAbs / cvRound)."""
    return torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8)


def finalize(x: torch.Tensor, like_dtype: torch.dtype, mode: str = "rint") -> torch.Tensor:
    """The float result in the caller's dtype: u8 by ``mode`` ("trunc" or
    "rint") for uint8 callers, unchanged otherwise."""
    if like_dtype == torch.uint8:
        return to_uint8_trunc(x) if mode == "trunc" else to_uint8_rint(x)
    return x


def reflect_indices(size: int, p: int, device: torch.device) -> torch.Tensor:
    """Source index of each of the size + 2p positions of a numpy
    ``mode="reflect"`` pad (edge not repeated)."""
    i = torch.arange(-p, size + p, device=device)
    if size == 1:
        return torch.zeros_like(i)
    period = 2 * (size - 1)
    i = i.remainder(period)
    return torch.where(i >= size, period - i, i)


def cv2_gaussian_ksize(radius: float) -> int:
    """Kernel size of the reference blur: int(6*radius) forced odd, min 3."""
    k = int(radius * 6)
    if k % 2 == 0:
        k += 1
    return max(k, 3)


def gaussian_taps(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel (sigma > 0): normalized exp(-x^2/2s^2), f64."""
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    w = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return w / w.sum()
