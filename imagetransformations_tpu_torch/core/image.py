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


def entry_device(device, entry: str) -> torch.device:
    """The device an entry point runs on: ``None`` means "cuda", which
    raises without a GPU instead of running on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{entry} runs on CUDA by default and no CUDA device is available; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


def to_device(images, device: torch.device) -> torch.Tensor:
    """A numpy array or a tensor as a tensor on ``device``."""
    if not isinstance(images, torch.Tensor):
        images = torch.from_numpy(np.ascontiguousarray(images))
    return images.to(device)


def as_float(x: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] -> float32 [0,255] (identity for float32 inputs)."""
    return x if x.dtype == torch.float32 else x.to(torch.float32)


def to_uint8_trunc(x: torch.Tensor) -> torch.Tensor:
    """clip to [0,255] then truncate toward zero (PIL blend C-cast semantics)."""
    return torch.clamp(torch.trunc(x), 0.0, 255.0).to(torch.uint8)


def to_uint8_rint(x: torch.Tensor) -> torch.Tensor:
    """round-half-even then clip (cv2.convertScaleAbs / cvRound semantics)."""
    return torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8)


def finalize(x: torch.Tensor, like_dtype: torch.dtype, mode: str = "rint") -> torch.Tensor:
    """The f32 result in the caller's dtype: u8 by ``mode`` ("trunc" or
    "rint") for uint8 callers, unchanged otherwise."""
    if like_dtype == torch.uint8:
        return to_uint8_trunc(x) if mode == "trunc" else to_uint8_rint(x)
    return x
