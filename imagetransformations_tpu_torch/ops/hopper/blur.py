"""cv2 GaussianBlur on NHWC uint8 batches, one radius for the batch.

Counterpart of ``imagetransformations_tpu/ops/pallas/blur.py``:
``blur_separable`` and ``blur_to_sheared_rows``, both of which launch the
Pallas kernel ``_blur_kernel``. On the card the hand-written kernel
``csrc/blur_separable.cu`` carries them; its plain PyTorch version is
``ops.stencil.gaussian_blur_plain``, which computes the same function in
the same order (vertical taps, then horizontal, t = 0..K-1 left to right,
f32, reflect-101, rint). A CPU tensor runs the plain version, a CUDA tensor
the kernel (or the call raises); nothing falls back. The kernel runs at
every shape, so the Pallas entry's XLA fallback for unaligned layouts and
its 128-lane alignment assert have no counterpart.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from imagetransformations_tpu_torch.ops.hopper import _lib
from imagetransformations_tpu_torch.ops.stencil import (
    cv2_gaussian_ksize,
    gaussian_blur_plain,
    gaussian_taps,
)


@functools.lru_cache(maxsize=64)
def blur_taps(radius: float, device: torch.device) -> torch.Tensor:
    """The f32 cv2 taps [K] of ``radius`` on ``device`` (host f64, cast).
    Cached, so a repeated call copies nothing to the card."""
    k = cv2_gaussian_ksize(float(radius))
    return torch.from_numpy(gaussian_taps(k, float(radius)).astype(np.float32)).to(device)


def blur_separable(img: torch.Tensor, radius: float) -> torch.Tensor:
    """cv2.GaussianBlur semantics (ksize = int(6r) forced odd, min 3,
    sigma = r, reflect-101 border). NHWC uint8 -> uint8, on the tensor's
    device. Radius 0 returns the input, as the JAX function does.

    On CUDA: ``csrc/blur_separable.cu``; on the CPU: the plain version."""
    if not isinstance(img, torch.Tensor) or img.ndim != 4 or img.dtype != torch.uint8:
        raise ValueError("expected an NHWC uint8 tensor")
    radius = float(radius)
    if radius == 0:
        return img
    if img.device.type == "cpu":
        return gaussian_blur_plain(img, radius)
    if img.device.type != "cuda":
        raise ValueError(f"kernel wrappers take CPU or CUDA tensors, got {img.device}")
    x = img.contiguous()
    n, h, w, c = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    taps = blur_taps(radius, x.device)
    name = "blur_separable"
    lib = _lib.load(name)
    with torch.cuda.device(x.device):
        err = lib.blur_separable(x.data_ptr(), out.data_ptr(), taps.data_ptr(),
                                 (taps.numel() - 1) // 2, n, h, w, c,
                                 torch.cuda.current_stream(x.device).cuda_stream)
    _lib.check(name, err)
    _lib.LAUNCHES[name] += 1
    return out


def blur_to_sheared_rows(img: torch.Tensor, radius: float, pc_out: int, total_out: int,
                         fill: int) -> torch.Tensor:
    """Blur like ``blur_separable``, then lay the result out as the row
    shear's padded input: u8 ``[H, N, total_out]`` with row y of image n at
    lanes ``pc_out .. pc_out + w*c`` and ``fill`` in the margins.

    The kernel runs first (not at radius 0, as in JAX), then a plain layout
    copy; the Pallas entry writes the margins from its output BlockSpec."""
    n, h, w, c = img.shape
    wc = w * c
    if not 0 <= pc_out <= total_out - wc:
        raise ValueError(f"lanes {pc_out}..{pc_out + wc} do not fit in total_out={total_out}")
    blurred = blur_separable(img, radius)
    out = torch.full((h, n, total_out), int(fill), dtype=torch.uint8, device=img.device)
    out[:, :, pc_out : pc_out + wc] = blurred.permute(1, 0, 2, 3).reshape(h, n, wc)
    return out
