"""Per-image histogram ops: the 256-bin pixel histogram, cv2 histogram
equalization and the reference's YUV-space equalization (PyTorch).

Counterpart of ``imagetransformations_tpu/ops/histogram.py`` (XLA in the
JAX package, no Pallas kernel):

- ``equalize_channel``: cv2.equalizeHist's LUT, the cdf minus its first
  nonzero value, ``rint((cdf - cdf_min) * 255 / (N - cdf_min))``.
- ``histogram_equalization``: the reference's YUV-space luma equalization
  (pipenline/cifar_image_transformations.py:122-129), cv2's YUV conversion
  in f32. The colour products are written out as f32 multiplies and adds in
  the channel order of the JAX einsum, each rounded on its own (no matrix
  product: on the card that could run in TF32).
"""

from __future__ import annotations

import torch

from imagetransformations_tpu_torch.core.image import as_batch, restore_layout

# cv2 RGB <-> YUV (BT.601 analog YUV) float coefficients, rounded to f32
_RGB2YUV = ((0.299, 0.587, 0.114), (-0.14713, -0.28886, 0.436), (0.615, -0.51499, -0.10001))
_YUV2RGB = ((1.0, 0.0, 1.13983), (1.0, -0.39465, -0.58060), (1.0, 2.03211, 0.0))


def pixel_histogram(img: torch.Tensor, bins: int = 256) -> torch.Tensor:
    """Per-image histogram of u8-valued pixels (truncated, clipped to the
    bins) -> i32 [N, bins]."""
    x, _ = as_batch(img)
    flat = torch.clamp(x.to(torch.int64), 0, bins - 1).reshape(x.shape[0], -1)
    hist = torch.zeros((x.shape[0], bins), dtype=torch.int32, device=x.device)
    return hist.scatter_add_(1, flat, torch.ones_like(flat, dtype=torch.int32))


def equalize_channel(chan: torch.Tensor) -> torch.Tensor:
    """cv2.equalizeHist on an [N, H, W] (or [H, W]) u8-valued channel; u8
    for u8 input, else f32."""
    x = chan[None] if chan.ndim == 2 else chan
    n = x.shape[0]
    hist = pixel_histogram(x[..., None])
    cdf = torch.cumsum(hist, dim=1)
    big = torch.where(hist > 0, cdf, torch.iinfo(torch.int32).max)
    cdf_min = big.min(dim=1, keepdim=True).values
    total = x.shape[1] * x.shape[2]
    denom = torch.clamp(total - cdf_min, min=1).to(torch.float32)
    lut = torch.clamp(torch.round((cdf - cdf_min).to(torch.float32) * 255.0 / denom), 0, 255)
    idx = torch.clamp(x.to(torch.int64), 0, 255).reshape(n, -1)
    out = torch.gather(lut, 1, idx).reshape(x.shape)
    out = out.to(torch.uint8 if chan.dtype == torch.uint8 else torch.float32)
    return out[0] if chan.ndim == 2 else out


def _mix(planes, coeffs) -> list[torch.Tensor]:
    """out[k] = (p[0]*m[k][0] + p[1]*m[k][1]) + p[2]*m[k][2] in f32."""
    m = torch.tensor(coeffs, dtype=torch.float32)
    return [(planes[0] * m[k, 0] + planes[1] * m[k, 1]) + planes[2] * m[k, 2] for k in range(3)]


def histogram_equalization(img: torch.Tensor) -> torch.Tensor:
    """YUV-space luma equalization: RGB -> YUV in f32, the Y plane rounded,
    clipped and equalized, back to RGB, rint and clip. Three channels out.
    One channel reads as (L, L, L), as the JAX einsum broadcasts it; 2 or
    more than 3 channels raise ValueError, as the JAX einsum does."""
    x, single = as_batch(img)
    c = x.shape[-1]
    if c not in (1, 3):
        raise ValueError(f"histogram_equalization takes 1 or 3 channels, got {c}")
    xf = x.to(torch.float32)
    y, u, v = _mix([xf[..., min(i, c - 1)] for i in range(3)], _RGB2YUV)
    y_eq = equalize_channel(torch.clamp(torch.round(y), 0, 255)).to(torch.float32)
    rgb = torch.stack(_mix([y_eq, u, v], _YUV2RGB), dim=-1)
    out = torch.clamp(torch.round(rgb), 0, 255)
    if img.dtype == torch.uint8:
        out = out.to(torch.uint8)
    return restore_layout(out, single)
