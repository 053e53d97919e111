"""cv2 GaussianBlur on NHWC uint8 batches, one radius for the batch or one
an image, in cv2's own 8U integer arithmetic.

Counterpart of ``imagetransformations_tpu/ops/pallas/blur.py``:
``blur_separable`` and ``blur_to_sheared_rows``, both of which launch the
Pallas kernel ``_blur_kernel``; and ``blur_separable_batched``, apply_all's
per-image blur (XLA in the JAX package, ``ops/stencil.apply_blur`` with an
array). On the card the hand-written kernel ``csrc/blur_separable.cu``
carries all three; its plain PyTorch versions are
``ops.stencil.gaussian_blur_plain`` and ``ops.stencil.blur_batched_plain``,
which compute the same function: cv2's taps with 8 fraction bits
(``stencil.cv2_taps_q8``), integer sums along H and W with reflect-101
borders, ``(sum + 2^15) >> 16``; this equals ``cv2.GaussianBlur`` bit for
bit, where the JAX kernel's f32 blur does not. A CPU tensor runs the plain
version, a CUDA tensor the kernel (or the call raises); nothing falls back.
The kernel runs at every shape, so the Pallas entry's XLA fallback for
unaligned layouts and its 128-lane alignment assert have no counterpart.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from imagetransformations_tpu_torch.ops.hopper import _lib
from imagetransformations_tpu_torch.ops.stencil import (
    blur_batched_plain,
    blur_tap_rows,
    cv2_taps_q8,
    gaussian_blur_plain,
)


@functools.lru_cache(maxsize=64)
def blur_taps(radius: float, device: torch.device) -> torch.Tensor:
    """cv2's int32 taps of ``radius`` (``stencil.cv2_taps_q8``) between its
    outer nonzero ones (a zero tap adds nothing: r 5's 31 taps are 29 here,
    so the kernel runs the body of that K), on ``device``, made on the
    host. Cached, so a repeated call copies nothing to the card."""
    return torch.from_numpy(np.trim_zeros(cv2_taps_q8(float(radius)))).to(device)


def _check_batch(img) -> None:
    if not isinstance(img, torch.Tensor) or img.ndim != 4 or img.dtype != torch.uint8:
        raise ValueError("expected an NHWC uint8 tensor")
    if img.device.type not in ("cpu", "cuda"):
        raise ValueError(f"kernel wrappers take CPU or CUDA tensors, got {img.device}")


def _launch(x: torch.Tensor, taps: torch.Tensor, tap_stride: int, name: str) -> torch.Tensor:
    """``csrc/blur_separable.cu`` on the contiguous CUDA batch ``x`` with
    int32 tap rows of ``taps.shape[-1]`` values, ``tap_stride`` apart;
    counts one launch under ``name``."""
    n, h, w, c = x.shape
    if taps.dtype != torch.int32 or taps.device != x.device or not taps.is_contiguous():
        raise ValueError("taps must be a contiguous int32 tensor on the image's device")
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
    sigma = r, reflect-101 border, cv2's 8U integer arithmetic). NHWC
    uint8 -> uint8, on the tensor's device. Radius 0 returns the input, as
    the JAX function does.

    On CUDA: ``csrc/blur_separable.cu`` with one tap row; on the CPU: the
    plain version."""
    _check_batch(img)
    radius = float(radius)
    if radius == 0:
        return img
    if img.device.type == "cpu":
        return gaussian_blur_plain(img, radius)
    return _launch(img.contiguous(), blur_taps(radius, img.device), 0, "blur_separable")


def blur_separable_batched(img: torch.Tensor, radii, taps: torch.Tensor | None = None
                           ) -> torch.Tensor:
    """cv2.GaussianBlur with one radius an image (apply_all's blur): NHWC
    uint8 [N, H, W, C] -> uint8, ``radii`` [N] (radius 0: the image as it
    is), on the images' device.

    ``taps``: each image's int32 tap row [N, W] (``stencil.blur_tap_rows``)
    where the caller has them on the images' device (the sweep gathers
    them from a table of the grid's rows by drawn index); by default they
    are made on the host from ``radii`` (``stencil.blur_tap_rows``: radii
    on the card are read back first). On CUDA: ``csrc/blur_separable.cu``
    with those rows (the kernel finds each image's window from its nonzero
    taps); on the CPU: the plain version ``stencil.blur_batched_plain``."""
    _check_batch(img)
    n = img.shape[0]
    r = torch.as_tensor(radii, dtype=torch.float32)
    if r.shape != (n,):
        raise ValueError(f"expected {n} radii, got shape {tuple(r.shape)}")
    if taps is None:
        taps = blur_tap_rows(r, img.device)
    if taps.shape != (n, taps.shape[-1]):
        raise ValueError(f"expected {n} tap rows, got shape {tuple(taps.shape)}")
    if img.device.type == "cpu":
        return blur_batched_plain(img, r, taps)
    taps = taps.contiguous()
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
