"""cv2 GaussianBlur on NHWC uint8 batches, one radius for the batch or one
an image.

Counterpart of ``imagetransformations_tpu/ops/pallas/blur.py``:
``blur_separable`` and ``blur_to_sheared_rows``, both of which launch the
Pallas kernel ``_blur_kernel``; and ``blur_separable_batched``, apply_all's
per-image blur (XLA in the JAX package, ``ops/stencil.apply_blur`` with an
array). On the card the hand-written kernel ``csrc/blur_separable.cu``
carries all three; its plain PyTorch versions are
``ops.stencil.gaussian_blur_plain`` and ``ops.stencil.blur_batched_plain``,
which compute the same function in the same order (vertical taps, then
horizontal, t = 0..K-1 left to right, f32, reflect-101, rint). A CPU tensor
runs the plain version, a CUDA tensor the kernel (or the call raises);
nothing falls back. The kernel runs at every shape, so the Pallas entry's
XLA fallback for unaligned layouts and its 128-lane alignment assert have
no counterpart.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from imagetransformations_tpu_torch.ops.hopper import _lib
from imagetransformations_tpu_torch.ops.stencil import (
    blur_batched_plain,
    blur_taps_batched,
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


def _check_batch(img) -> None:
    if not isinstance(img, torch.Tensor) or img.ndim != 4 or img.dtype != torch.uint8:
        raise ValueError("expected an NHWC uint8 tensor")
    if img.device.type not in ("cpu", "cuda"):
        raise ValueError(f"kernel wrappers take CPU or CUDA tensors, got {img.device}")


def _launch(x: torch.Tensor, taps: torch.Tensor, tap_stride: int, name: str) -> torch.Tensor:
    """``csrc/blur_separable.cu`` on the contiguous CUDA batch ``x`` with
    tap rows of ``taps.shape[-1]`` values, ``tap_stride`` apart; counts one
    launch under ``name``."""
    n, h, w, c = x.shape
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    lib = _lib.load("blur_separable")
    with torch.cuda.device(x.device):
        err = lib.blur_separable(x.data_ptr(), out.data_ptr(), taps.data_ptr(), tap_stride,
                                 taps.shape[-1], n, h, w, c,
                                 torch.cuda.current_stream(x.device).cuda_stream)
    _lib.check(name, err)
    _lib.LAUNCHES[name] += 1
    return out


def blur_separable(img: torch.Tensor, radius: float) -> torch.Tensor:
    """cv2.GaussianBlur semantics (ksize = int(6r) forced odd, min 3,
    sigma = r, reflect-101 border). NHWC uint8 -> uint8, on the tensor's
    device. Radius 0 returns the input, as the JAX function does.

    On CUDA: ``csrc/blur_separable.cu`` with one tap row; on the CPU: the
    plain version."""
    _check_batch(img)
    radius = float(radius)
    if radius == 0:
        return img
    if img.device.type == "cpu":
        return gaussian_blur_plain(img, radius)
    return _launch(img.contiguous(), blur_taps(radius, img.device), 0, "blur_separable")


def blur_separable_batched(img: torch.Tensor, radii) -> torch.Tensor:
    """cv2.GaussianBlur with one radius an image (apply_all's blur): NHWC
    uint8 [N, H, W, C] -> uint8, ``radii`` [N] (radius 0: the image as it
    is), on the images' device.

    On CUDA: ``csrc/blur_separable.cu`` with each image's f32 tap row from
    ``stencil.blur_taps_batched`` (31 wide, zero-padded); the kernel finds
    each image's window from its nonzero taps, so nothing is read back to
    the host. On the CPU: the plain version ``stencil.blur_batched_plain``."""
    _check_batch(img)
    r = torch.as_tensor(radii, dtype=torch.float32, device=img.device)
    if r.shape != (img.shape[0],):
        raise ValueError(f"expected {img.shape[0]} radii, got shape {tuple(r.shape)}")
    if img.device.type == "cpu":
        return blur_batched_plain(img, r)
    taps = blur_taps_batched(r).contiguous()
    return _launch(img.contiguous(), taps, taps.shape[-1], "blur_separable_batched")


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
