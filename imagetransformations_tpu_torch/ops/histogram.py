"""Per-image histogram ops: the 256-bin pixel histogram, cv2 histogram
equalization and the reference's YUV-space equalization (PyTorch).

Counterpart of ``imagetransformations_tpu/ops/histogram.py`` (XLA in the
JAX package, no Pallas kernel):

- ``equalize_channel``: the JAX package's equalizeHist LUT, the cdf minus
  its first nonzero value, ``rint((cdf - cdf_min) * 255 / (N - cdf_min))``;
  ``equalize_channel_cv2``: cv2.equalizeHist's own rounding.
- ``histogram_equalization``: the reference's YUV-space luma equalization
  (pipenline/cifar_image_transformations.py:122-129): cv2's RGB2YUV,
  equalizeHist on Y, YUV2RGB. On uint8 input the conversions are cv2's own
  14-bit fixed point in integers and the LUT is cv2's, so the op equals cv2
  bit for bit (the JAX
  package converts in f32 and differs from cv2 by up to tens of LSB, as a
  flipped Y level moves the CDF). Float input keeps the f32 conversion:
  f32 multiplies and adds in the channel order of the JAX einsum, each
  rounded on its own (no matrix product: on the card that could run in
  TF32).
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


def equalize_channel_cv2(chan: torch.Tensor) -> torch.Tensor:
    """cv2.equalizeHist itself on u8 [N, H, W]: from the first nonzero bin
    i, ``lut = rint(f32(cdf - cdf[i]) * f32(255 / (total - hist[i])))``, and
    an image of one level keeps it. ``equalize_channel`` (the JAX package's
    rule) divides after the product, which moves a level by 1 at some pixel
    counts (23x37), and maps one level to 0."""
    n = chan.shape[0]
    hist = pixel_histogram(chan[..., None])
    cdf = torch.cumsum(hist, dim=1)
    first = torch.argmax((hist > 0).to(torch.int32), dim=1, keepdim=True)
    cdf_min = torch.gather(cdf, 1, first)
    total = chan.shape[1] * chan.shape[2]
    # a tensor numerator: PyTorch takes ``255.0 / t`` as 255 * (1 / t)
    scale = torch.full_like(cdf_min, 255, dtype=torch.float32) / torch.clamp(
        total - cdf_min, min=1).to(torch.float32)
    lut = torch.clamp(torch.round((cdf - cdf_min).to(torch.float32) * scale), 0, 255)
    lut = torch.where(cdf_min == total, first.to(torch.float32), lut).to(torch.uint8)
    idx = chan.to(torch.int64).reshape(n, -1)
    return torch.gather(lut, 1, idx).reshape(chan.shape)


def _mix(planes, coeffs) -> list[torch.Tensor]:
    """out[k] = (p[0]*m[k][0] + p[1]*m[k][1]) + p[2]*m[k][2] in f32."""
    m = torch.tensor(coeffs, dtype=torch.float32)
    return [(planes[0] * m[k, 0] + planes[1] * m[k, 1]) + planes[2] * m[k, 2] for k in range(3)]


def _equalize_yuv_int(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cv2's u8 RGB2YUV, equalizeHist on Y and YUV2RGB, in its 14-bit fixed
    point (int32 planes [N, H, W] in 0..255) -> u8 [N, H, W, 3]. Shifts of
    negative sums floor, as cv2's CV_DESCALE does."""
    half = 1 << 13
    y = (r * 4899 + g * 9617 + b * 1868 + half) >> 14
    u = torch.clamp(((b - y) * 8061 + (128 << 14) + half) >> 14, 0, 255) - 128
    v = torch.clamp(((r - y) * 14369 + (128 << 14) + half) >> 14, 0, 255) - 128
    y = equalize_channel_cv2(y.to(torch.uint8)).to(torch.int32)
    rgb = (y + ((v * 18678 + half) >> 14), y + ((u * -6472 + v * -9519 + half) >> 14),
           y + ((u * 33292 + half) >> 14))
    return torch.stack([torch.clamp(p, 0, 255) for p in rgb], dim=-1).to(torch.uint8)


def histogram_equalization(img: torch.Tensor) -> torch.Tensor:
    """YUV-space luma equalization, three channels out. u8: cv2's integer
    conversions (``_equalize_yuv_int``); float: RGB -> YUV in f32, the Y
    plane rounded, clipped and equalized, back to RGB, rint and clip. One
    channel reads as (L, L, L), as the JAX einsum broadcasts it (so Y = L
    and U = V = 128 in integers); 2 or more than 3 channels raise
    ValueError, as the JAX einsum does."""
    x, single = as_batch(img)
    c = x.shape[-1]
    if c not in (1, 3):
        raise ValueError(f"histogram_equalization takes 1 or 3 channels, got {c}")
    if x.dtype == torch.uint8:
        xi = x.to(torch.int32)
        out = _equalize_yuv_int(*(xi[..., min(i, c - 1)] for i in range(3)))
        return restore_layout(out, single)
    xf = x.to(torch.float32)
    y, u, v = _mix([xf[..., min(i, c - 1)] for i in range(3)], _RGB2YUV)
    y_eq = equalize_channel(torch.clamp(torch.round(y), 0, 255)).to(torch.float32)
    rgb = torch.stack(_mix([y_eq, u, v], _YUV2RGB), dim=-1)
    return restore_layout(torch.clamp(torch.round(rgb), 0, 255), single)


def image_entropy(img: torch.Tensor, base2: bool = True) -> torch.Tensor:
    """Shannon entropy of each image's 256-bin gray-level histogram
    (compute_shannon_entropy, fall_2025/TENT_Pipelines.py:99-121): the luma
    of 3-channel input (PIL convert('L')), ``-sum p log p`` over the
    nonzero bins, in bits (``base2``) or nats. Returns f32 [N]. Taken in
    f64 and rounded to f32, so every device gives the same value (the JAX
    package sums f32 terms)."""
    x, _ = as_batch(img)
    if x.shape[-1] == 3:
        from imagetransformations_tpu_torch.ops.elementwise import grayscale

        x = grayscale(x, keep_rgb=False)
    hist = pixel_histogram(x).to(torch.float64)
    p = hist / hist.sum(dim=1, keepdim=True)
    logp = torch.where(p > 0, torch.log2(p) if base2 else torch.log(p), 0.0)
    return (-(p * logp).sum(dim=1)).to(torch.float32)
