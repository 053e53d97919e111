"""Elementwise (photometric) image ops (PyTorch).

Counterparts of ``imagetransformations_tpu/ops/elementwise.py``, which XLA
compiles (no Pallas kernel): u8 in, f32 math, the reference's quantization
out (trunc for PIL blends, rint for cv2).

- brightness: transformation.py:261-269 (PIL ImageEnhance.Brightness)
- contrast  : transformation.py:203-210 (cv2.convertScaleAbs)
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
    """PIL ImageEnhance.Brightness(1.0 + factor); factor in the [-0.05, 0.05] grid."""
    x, single = as_batch(img)
    out = as_float(x) * (1.0 + _pvec(factor, x.shape[0], x.device))
    return restore_layout(finalize(out, img.dtype, "trunc"), single)


def apply_contrast(img: torch.Tensor, alpha) -> torch.Tensor:
    """cv2.convertScaleAbs(img, alpha=c, beta=0): clip(rint(f32(px) * f32(c)))."""
    x, single = as_batch(img)
    out = as_float(x) * _pvec(alpha, x.shape[0], x.device)
    return restore_layout(finalize(out, img.dtype, "rint"), single)
