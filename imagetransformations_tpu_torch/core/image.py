"""Canonical tensor model for image batches (PyTorch).

Same layout contract as the JAX package: **NHWC** with dtype ``uint8`` at the
memory boundary and ``float32`` (pixel range [0, 255]) inside compute.

Quantization back to uint8 is op-dependent:

- ``to_uint8_trunc``: PIL ``Image.blend``-style — float32 math then C-cast
  truncation toward zero.
- ``to_uint8_rint`` : OpenCV ``convertScaleAbs``-style — float32 math then
  round-half-even (``torch.round`` rounds half to even, like ``jnp.rint``).
"""

from __future__ import annotations

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


def to_uint8_trunc(x: torch.Tensor) -> torch.Tensor:
    """clip to [0,255] then truncate toward zero (PIL blend C-cast semantics)."""
    return torch.clamp(torch.trunc(x), 0.0, 255.0).to(torch.uint8)


def to_uint8_rint(x: torch.Tensor) -> torch.Tensor:
    """round-half-even then clip (cv2.convertScaleAbs / cvRound semantics)."""
    return torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8)
