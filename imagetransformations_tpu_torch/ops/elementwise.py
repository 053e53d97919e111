"""Elementwise (photometric) image ops (PyTorch).

Counterparts of ``imagetransformations_tpu/ops/elementwise.py``, which XLA
compiles (no Pallas kernel): u8 in, f32 math, the reference's quantization
out (trunc for PIL blends, rint for cv2).

- brightness: transformation.py:261-269 (PIL ImageEnhance.Brightness)
- contrast  : transformation.py:203-210 (cv2.convertScaleAbs)
- grayscale : PIL convert('L'), integer L24 fixed-point luma
- invert    : PIL ImageOps.invert
- enhance_* : PIL ImageEnhance.Contrast / Color trunc blends
              (pipenline/cifar_image_transformations.py:72-107)

Every f32 operation rounds on its own, as PIL's C code does. (XLA-CPU
contracts the blends of the JAX ``enhance_contrast`` and ``enhance_color``
into FMAs; the tests state that budget.)

Scope of the ImageEnhance ops (brightness, ``enhance_contrast``,
``enhance_color``, and ``stencil.sharpen``): PIL-exact on 1 and 3
channels; 2 and 4 channels resampled per channel (blended channel by
channel: Pillow's ImageEnhance also blends the alpha channel of LA / RGBA,
which the reference never sends; it opens every image as RGB).
"""

from __future__ import annotations

import torch

from imagetransformations_tpu_torch.core.image import as_batch, as_float, finalize, restore_layout


def _pvec(p, n: int, device: torch.device) -> torch.Tensor:
    """A python scalar or [N] vector as f32 [N, 1, 1, 1]."""
    p = torch.as_tensor(p, dtype=torch.float32, device=device)
    if p.ndim == 0:
        p = p.expand(n)
    return p.reshape(-1, 1, 1, 1)


def apply_brightness(img: torch.Tensor, factor) -> torch.Tensor:
    """PIL ImageEnhance.Brightness(1.0 + factor); factor in the [-0.05, 0.05]
    grid. Scope: PIL-exact on 1 and 3 channels; 2 and 4 channels resampled
    per channel."""
    x, single = as_batch(img)
    out = as_float(x) * (1.0 + _pvec(factor, x.shape[0], x.device))
    return restore_layout(finalize(out, img.dtype, "trunc"), single)


def apply_contrast(img: torch.Tensor, alpha) -> torch.Tensor:
    """cv2.convertScaleAbs(img, alpha=c, beta=0): clip(rint(f32(px) * f32(c)))."""
    x, single = as_batch(img)
    out = as_float(x) * _pvec(alpha, x.shape[0], x.device)
    return restore_layout(finalize(out, img.dtype, "rint"), single)


_LUMA_WEIGHTS = (19595, 38470, 7471)  # PIL L24 weights of R, G, B


def _channel(x: torch.Tensor, k: int) -> torch.Tensor:
    """Channel ``k`` of an NHWC batch, clamped to the last channel as JAX
    clamps an out-of-range index: a 1-channel image reads as (L, L, L), a
    2-channel one as (c0, c1, c1)."""
    return x[..., min(k, x.shape[-1] - 1)]


def grayscale(img: torch.Tensor, keep_rgb: bool = True) -> torch.Tensor:
    """PIL convert('L'): ``(r*19595 + g*38470 + b*7471 + 0x8000) >> 16`` on
    the truncated, clipped pixel values (so f32 inputs give the same values
    as their u8 round trip). Three channels out with ``keep_rgb``, else
    one; u8 for u8 input, else f32. Fewer than 3 channels read as JAX reads
    them (``_channel``): one channel is its own luma."""
    x, single = as_batch(img)
    xi = torch.clamp(torch.trunc(as_float(x)), 0.0, 255.0).to(torch.int32)
    wr, wg, wb = _LUMA_WEIGHTS
    luma = (_channel(xi, 0) * wr + _channel(xi, 1) * wg + _channel(xi, 2) * wb + 0x8000) >> 16
    out = luma[..., None]
    if keep_rgb:
        out = out.expand(*luma.shape, 3)
    out = out.to(torch.uint8 if img.dtype == torch.uint8 else torch.float32).contiguous()
    return restore_layout(out, single)


def invert(img: torch.Tensor) -> torch.Tensor:
    """255 - px (PIL ImageOps.invert)."""
    x, single = as_batch(img)
    return restore_layout(finalize(255.0 - as_float(x), img.dtype, "rint"), single)


def enhance_contrast(img: torch.Tensor, factor) -> torch.Tensor:
    """PIL ImageEnhance.Contrast: trunc blend toward the image's mean luma
    ``int(mean(L) + 0.5)``, taken in integers as ``(2*total + npix) //
    (2*npix)`` so the .5 boundary is exact. Scope: PIL-exact on 1 and 3
    channels; 2 and 4 channels resampled per channel."""
    x, single = as_batch(img)
    gray = grayscale(x, keep_rgb=False).to(torch.int64)
    total = gray.sum(dim=(1, 2, 3), keepdim=True)
    npix = gray.shape[1] * gray.shape[2]
    mean = ((2 * total + npix) // (2 * npix)).to(torch.float32)
    out = mean + (as_float(x) - mean) * _pvec(factor, x.shape[0], x.device)
    return restore_layout(finalize(out, img.dtype, "trunc"), single)


def enhance_color(img: torch.Tensor, factor) -> torch.Tensor:
    """PIL ImageEnhance.Color: trunc blend toward each pixel's luma. Scope:
    PIL-exact on 1 and 3 channels; 2 and 4 channels resampled per channel."""
    x, single = as_batch(img)
    gray = grayscale(x, keep_rgb=False).to(torch.float32)
    out = gray + (as_float(x) - gray) * _pvec(factor, x.shape[0], x.device)
    return restore_layout(finalize(out, img.dtype, "trunc"), single)
