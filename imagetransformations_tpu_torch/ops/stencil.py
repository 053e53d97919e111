"""Stencil ops (PyTorch): Gaussian and motion blur, PIL sharpen.

Host-side constants (``cv2_gaussian_ksize``, ``gaussian_taps``) are computed
in float64; the fused kernels and their plain versions cast the taps to
float32 exactly where they multiply.

Counterparts of ``imagetransformations_tpu/ops/stencil.py``, which XLA
compiles (no Pallas kernel there):

- ``gaussian_blur`` (one radius) and ``apply_blur`` (one radius an image):
  cv2.GaussianBlur, an H pass then a W pass over NHWC f32, taps summed left
  to right (t = 0..K-1), numpy "reflect" (cv2 reflect-101) borders, rint at
  the end. Per-image radii use taps computed in f32 on the device and
  zero-padded to ``MAX_BLUR_KSIZE``, as the JAX package does. On a CUDA u8
  batch both run the hand-written kernel of ``ops.hopper.blur``
  (``blur_separable``, ``blur_separable_batched``), which computes this
  function in this order (the JAX ``blur_separable`` is the Pallas form of
  the one-radius blur); elsewhere, and for f32 input, their plain PyTorch
  forms ``gaussian_blur_plain`` and ``blur_batched_plain``.
- ``motion_blur``: horizontal 1 x k mean (cv2.filter2D, reflect-101).
- ``sharpen``: PIL ImageEnhance.Sharpness, the SMOOTH 3x3 filter with its
  exact integer sum and one division by 13, then a trunc blend.
"""

from __future__ import annotations

import numpy as np
import torch

from imagetransformations_tpu_torch.core.image import as_batch, as_float, finalize, restore_layout

#: max kernel size for the blur grid (radius <= 5 -> ksize <= 31).
MAX_BLUR_KSIZE = 31


def cv2_gaussian_ksize(radius: float) -> int:
    """Kernel-size rule of the reference blur: int(6*radius) forced odd, min 3."""
    k = int(radius * 6)
    if k % 2 == 0:
        k += 1
    if k < 3:
        k = 3
    return k


def gaussian_taps(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel semantics (sigma > 0): normalized exp(-x^2/2s^2)."""
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    w = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return w / w.sum()


def _reflect_indices(size: int, p: int, device: torch.device) -> torch.Tensor:
    """Source index of each of the size + 2p positions of a numpy
    ``mode="reflect"`` pad (edge not repeated; reflects again as often as
    ``p`` needs)."""
    i = torch.arange(-p, size + p, device=device)
    if size == 1:
        return torch.zeros_like(i)
    period = 2 * (size - 1)
    i = i.remainder(period)
    return torch.where(i >= size, period - i, i)


def _conv1d(x: torch.Tensor, taps: torch.Tensor, dim: int) -> torch.Tensor:
    """Separable 1-D pass along H (dim 1) or W (dim 2) of NHWC f32, reflect
    borders. ``taps`` is [K] (shared) or [N, K] (one row an image); the taps
    are summed left to right as acc + x[t] * w[t]."""
    k = taps.shape[-1]
    p = k // 2
    size = x.shape[dim]
    xp = x.index_select(dim, _reflect_indices(size, p, x.device))
    acc = None
    for t in range(k):
        w = taps[..., t]
        if w.ndim == 1:  # one tap an image
            w = w.reshape(-1, 1, 1, 1)
        term = xp.narrow(dim, t, size) * w
        acc = term if acc is None else acc + term
    return acc


def gaussian_blur_plain(img: torch.Tensor, radius: float) -> torch.Tensor:
    """cv2.GaussianBlur with one radius for the batch, in plain PyTorch on
    the tensor's device (the plain version of the ``blur_separable``
    kernel for u8 input)."""
    if radius == 0:
        return img
    x, single = as_batch(img)
    k = cv2_gaussian_ksize(float(radius))
    taps = torch.from_numpy(gaussian_taps(k, float(radius)).astype(np.float32)).to(x.device)
    out = _conv1d(_conv1d(as_float(x), taps, 1), taps, 2)
    return restore_layout(finalize(out, img.dtype, "rint"), single)


def gaussian_blur(img: torch.Tensor, radius: float) -> torch.Tensor:
    """cv2.GaussianBlur semantics with one radius for the batch: the
    ``blur_separable`` kernel for a CUDA u8 batch, else the plain version."""
    if radius == 0:
        return img
    if img.device.type == "cuda" and img.dtype == torch.uint8:
        # imported here: ops.hopper.blur imports this module at its top
        from imagetransformations_tpu_torch.ops.hopper.blur import blur_separable

        x, single = as_batch(img)
        return restore_layout(blur_separable(x, float(radius)), single)
    return gaussian_blur_plain(img, radius)


def blur_taps_batched(radii, max_ksize: int = MAX_BLUR_KSIZE) -> torch.Tensor:
    """Per-image cv2 Gaussian taps in f32, zero-padded to a fixed width -> [N, K].

    The ksize rule int(6r) -> odd -> min 3 in tensor arithmetic; radius 0
    gives a delta row. Same f32 op order as the JAX package's, with two
    choices of its own: the exponential is taken in f64 and rounded to f32
    (the correctly rounded f32 value, the same on every device; XLA's and
    PyTorch's f32 ``exp`` differ from it, and from each other, by an ulp on
    a few arguments), and the row sum runs left to right, as XLA's CPU
    reduction does for these rows."""
    r = torch.as_tensor(radii, dtype=torch.float32).reshape(-1, 1)
    k = torch.floor(r * 6.0)
    k = torch.where(torch.remainder(k, 2.0) == 0.0, k + 1.0, k)
    k = torch.clamp(k, min=3.0)
    half = (k - 1.0) / 2.0
    c = (max_ksize - 1) // 2
    x = torch.arange(max_ksize, dtype=torch.float32, device=r.device)[None, :] - float(c)
    sigma = torch.clamp(r, min=1e-6)
    arg = -(x * x) / (2.0 * sigma * sigma)
    w = torch.exp(arg.to(torch.float64)).to(torch.float32)
    w = torch.where(torch.abs(x) <= half, w, 0.0)
    total = w[:, :1]
    for t in range(1, max_ksize):
        total = total + w[:, t : t + 1]
    w = w / total
    delta = (x == 0.0).to(torch.float32)
    return torch.where(r == 0.0, delta, w)


def apply_blur(img: torch.Tensor, radius) -> torch.Tensor:
    """Reference apply_blur (transformation.py:228-257), batched: ``radius``
    is a python number (one radius) or one radius an image. A CUDA u8 batch
    runs the kernel (``blur_separable`` or ``blur_separable_batched``),
    anything else the plain version."""
    if isinstance(radius, (int, float)):
        return gaussian_blur(img, float(radius))
    if img.device.type == "cuda" and img.dtype == torch.uint8:
        # imported here: ops.hopper.blur imports this module at its top
        from imagetransformations_tpu_torch.ops.hopper.blur import blur_separable_batched

        x, single = as_batch(img)
        return restore_layout(blur_separable_batched(x, radius), single)
    return blur_batched_plain(img, radius)


def blur_batched_plain(img: torch.Tensor, radii) -> torch.Tensor:
    """cv2.GaussianBlur with one radius an image, in plain PyTorch on the
    tensor's device: the two passes with each image's zero-padded 31-wide
    tap row (the plain version of the ``blur_separable_batched`` kernel for
    u8 input)."""
    x, single = as_batch(img)
    taps = blur_taps_batched(torch.as_tensor(radii, dtype=torch.float32, device=x.device))
    out = _conv1d(_conv1d(as_float(x), taps, 1), taps, 2)
    return restore_layout(finalize(out, img.dtype, "rint"), single)


def motion_blur(img: torch.Tensor, ksize: int) -> torch.Tensor:
    """Horizontal 1 x k mean filter (cv2.filter2D, reflect-101), rint for u8."""
    x, single = as_batch(img)
    k = int(ksize)
    taps = torch.full((k,), 1.0 / k, dtype=torch.float32, device=x.device)
    out = _conv1d(as_float(x), taps, 2)
    return restore_layout(finalize(out, img.dtype, "rint"), single)


def _smooth3x3(x: torch.Tensor) -> torch.Tensor:
    """PIL SMOOTH 3x3 filter, zero padding, the 1-pixel border copied from
    the input. The integer kernel sum is accumulated exactly in f32 (at
    most 13*255) and divided by 13 once: floor(acc / 13 + 0.5)."""
    h, w = x.shape[1], x.shape[2]
    xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    weights = (1.0, 1.0, 1.0, 1.0, 5.0, 1.0, 1.0, 1.0, 1.0)
    acc = None
    for idx in range(9):
        dy, dx = divmod(idx, 3)
        term = xp[:, dy : dy + h, dx : dx + w, :] * weights[idx]
        acc = term if acc is None else acc + term
    sm = torch.floor(acc / 13.0 + 0.5)
    hy = torch.arange(h, device=x.device).view(1, h, 1, 1)
    wx = torch.arange(w, device=x.device).view(1, 1, w, 1)
    border = (hy == 0) | (hy == h - 1) | (wx == 0) | (wx == w - 1)
    return torch.where(border, x, sm)


def sharpen(img: torch.Tensor, factor) -> torch.Tensor:
    """PIL ImageEnhance.Sharpness(factor): ``sm + (x - sm) * f`` with sm the
    SMOOTH filter, every op rounded on its own (as PIL does), then clip and
    trunc for u8 (cifar_image_transformations.py:93-99). ``factor`` is a
    scalar or one value an image."""
    x, single = as_batch(img)
    xf = torch.clamp(torch.trunc(as_float(x)), 0.0, 255.0)
    sm = _smooth3x3(xf)
    f = torch.as_tensor(factor, dtype=torch.float32, device=x.device)
    if f.ndim == 0:
        f = f.expand(x.shape[0])
    out = sm + (xf - sm) * f.reshape(-1, 1, 1, 1)
    if img.dtype == torch.uint8:
        out = torch.clamp(torch.trunc(out), 0.0, 255.0).to(torch.uint8)
    return restore_layout(out, single)
