"""Stencil ops (PyTorch): Gaussian and motion blur, PIL sharpen.

Counterparts of ``imagetransformations_tpu/ops/stencil.py``, which XLA
compiles (no Pallas kernel there):

- ``gaussian_blur`` (one radius) and ``apply_blur`` (one radius an image):
  cv2.GaussianBlur. On uint8 input, cv2's own 8U arithmetic, in integers
  (``cv2_taps_q8``): taps with 8 fraction bits, integer sums along H and
  along W with reflect-101 borders, and one rounding at the end,
  ``(sum + 2^15) >> 16``. This equals ``cv2.GaussianBlur`` bit for bit; the
  JAX package computes the blur in f32 and differs from cv2 by 1-2 LSB on
  6-23% of values. Per-image radii take each image's integer tap row,
  zero-padded to ``MAX_BLUR_KSIZE`` (wider for radii beyond 5). On a CUDA u8 batch both run the
  hand-written kernel of ``ops.hopper.blur`` (``blur_separable``,
  ``blur_separable_batched``), which computes this function; elsewhere
  their plain PyTorch forms ``gaussian_blur_plain`` and
  ``blur_batched_plain``. Float input keeps cv2's float path: f32 taps, an
  H pass then a W pass, taps summed left to right (t = 0..K-1).
- ``motion_blur``: horizontal 1 x k mean (cv2.filter2D, reflect-101).
- ``sharpen``: PIL ImageEnhance.Sharpness, the SMOOTH 3x3 filter with its
  exact integer sum and one division by 13, then a trunc blend.
- ``sobel_edges``: scipy.ndimage.sobel along the last axis, u8 modulo 256
  or f32.
- ``pil_box_blur`` / ``pil_gaussian_blur``: PIL's BoxBlur / GaussianBlur in
  its own integers (24-bit weights, u8 between passes), bit-exact.
"""

from __future__ import annotations

import functools
import math

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


@functools.lru_cache(maxsize=256)
def _taps_q8(ksize: int, sigma: float) -> tuple[int, ...]:
    half = (ksize - 1) // 2
    scale = -0.125 / (sigma * sigma)
    # cv2's f64 Gaussian (getGaussianKernelBitExact): x steps by 2 from 1 - K
    vals = [math.exp(float(x * x) * scale) for x in range(1 - ksize, 0, 2)]
    total = 0.0
    for v in vals:
        total += v
    mul = 1.0 / (2.0 * total + 1.0)
    # 8 fraction bits by error diffusion from the outer taps inward
    # (getGaussianKernelFixedPoint_ED); round() is half to even, as cvRound
    out, err = [0] * ksize, 0.0
    for i, v in enumerate(vals):
        adj = v * mul * 256.0 + err
        q = round(adj)
        err = adj - q
        out[i] = out[ksize - 1 - i] = q
    out[half] = 256 - 2 * sum(out[:half])
    return tuple(out)


def cv2_taps_q8(radius: float) -> np.ndarray:
    """cv2.GaussianBlur's 8U kernel for ``radius`` (ksize = int(6r) forced
    odd, min 3, sigma = r): int32 [K] taps with 8 fraction bits summing to
    256. Radius 0 gives the delta row [256]."""
    if radius == 0:
        return np.asarray([256], np.int32)
    return np.asarray(_taps_q8(cv2_gaussian_ksize(float(radius)), float(radius)), np.int32)


def blur_tap_rows(radii, device: torch.device) -> torch.Tensor:
    """Each radius's ``cv2_taps_q8`` centred in a zero-padded row: int32
    [N, W] on ``device``, W the larger of ``MAX_BLUR_KSIZE`` and the widest
    window (radius 0: the delta row). The rows are made on the host: radii
    on the card are read back first, which waits for the card (the sweep
    gathers its rows from a table of the grid's rows instead)."""
    r = torch.as_tensor(radii, dtype=torch.float64).reshape(-1).cpu().numpy()
    uniq, inv = np.unique(r, return_inverse=True)
    taps = [cv2_taps_q8(float(v)) for v in uniq]
    width = max([MAX_BLUR_KSIZE] + [t.size for t in taps])
    rows = np.zeros((len(taps), width), np.int32)
    for i, t in enumerate(taps):
        p = (width - t.size) // 2
        rows[i, p : p + t.size] = t
    return torch.from_numpy(rows[inv.reshape(-1)]).to(device)


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
    """Separable 1-D pass along H (dim 1) or W (dim 2) of NHWC, reflect
    borders. ``taps`` is [K] (shared) or [N, K] (one row an image); the taps
    are summed left to right as acc + x[t] * w[t] (f32: each op rounded;
    int32: exact)."""
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


def _blur_q8(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """cv2's 8U blur of the NHWC u8 batch ``x`` with int32 taps [K] or
    [N, K] (8 fraction bits): integer sums along H, then W (each row sum is
    at most 65280, the total below 2^24), then ``(sum + 2^15) >> 16``."""
    acc = _conv1d(_conv1d(x.to(torch.int32), taps, 1), taps, 2)
    return ((acc + 32768) >> 16).to(torch.uint8)


def gaussian_blur_plain(img: torch.Tensor, radius: float) -> torch.Tensor:
    """cv2.GaussianBlur with one radius for the batch, in plain PyTorch on
    the tensor's device (the plain version of the ``blur_separable``
    kernel for u8 input)."""
    if radius == 0:
        return img
    x, single = as_batch(img)
    if x.dtype == torch.uint8:
        taps = torch.from_numpy(cv2_taps_q8(float(radius))).to(x.device)
        return restore_layout(_blur_q8(x, taps), single)
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
    """Per-image cv2 Gaussian taps in f32, zero-padded to a fixed width -> [N, K]:
    the float-input path of ``blur_batched_plain``.

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


def blur_batched_plain(img: torch.Tensor, radii, taps: torch.Tensor | None = None) -> torch.Tensor:
    """cv2.GaussianBlur with one radius an image, in plain PyTorch on the
    tensor's device (the plain version of the ``blur_separable_batched``
    kernel for u8 input): the two passes with each image's zero-padded tap
    row. u8 takes cv2's integer rows (``taps``, int32 [N, W], when the
    caller has them, else ``blur_tap_rows``), exact at any radius; float
    input the f32 rows of ``blur_taps_batched``, cut to 31 taps as the JAX
    package cuts them."""
    x, single = as_batch(img)
    if x.dtype == torch.uint8:
        if taps is None:
            taps = blur_tap_rows(radii, x.device)
        return restore_layout(_blur_q8(x, taps), single)
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
    scalar or one value an image. Scope: PIL-exact on 1 and 3 channels; 2
    and 4 channels resampled per channel."""
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


def sobel_edges(img: torch.Tensor, mode: str = "wrap_u8") -> torch.Tensor:
    """Sobel derivative along the last spatial axis (scipy.ndimage.sobel,
    axis -1, on the luma of an NHWC batch with 1 or 3 channels, or on an
    [N, H, W] / [H, W] gray batch).

    ``mode="wrap_u8"``: scipy's u8 result, the integer response modulo 256
    (as apply_background_change uses it, transformation.py:339);
    ``mode="float"``: the unwrapped f32 response. scipy's default border,
    mode='reflect', repeats the edge pixel (numpy's "symmetric" pad)."""
    if img.ndim >= 3 and img.shape[-1] in (1, 3):
        from imagetransformations_tpu_torch.ops.elementwise import grayscale

        img = grayscale(img, keep_rgb=False)[..., 0]
    x = img[None] if img.ndim == 2 else img
    xf = x.to(torch.int32) if mode == "wrap_u8" else x.to(torch.float32)
    h, w = x.shape[1], x.shape[2]
    rows = torch.clamp(torch.arange(-1, h + 1, device=x.device), 0, h - 1)
    cols = torch.clamp(torch.arange(-1, w + 1, device=x.device), 0, w - 1)
    xp = xf[:, rows][:, :, cols]

    def sl(dy, dx):
        return xp[:, dy : dy + h, dx : dx + w]

    # correlate with d/dx [-1, 0, 1], then smooth [1, 2, 1] along the other axis
    d = sl(0, 2) + 2 * sl(1, 2) + sl(2, 2) - sl(0, 0) - 2 * sl(1, 0) - sl(2, 0)
    out = torch.remainder(d, 256).to(torch.uint8) if mode == "wrap_u8" else d
    return out[0] if img.ndim == 2 else out


# --------------------------------------------------- PIL BoxBlur / GaussianBlur (exact)


def pil_gauss_box_radius(radius: float, passes: int = 3) -> float:
    """PIL GaussianBlur's box radius (BoxBlur.c, Gwosdek's extended box):
    one fractional radius l + t for each of ``passes`` box passes, so that
    they reproduce the Gaussian's variance ``radius^2``. In f32, as the C
    code computes it (f64 flips 1-LSB pixels, e.g. at r = 1.0)."""
    r = np.float32(radius)
    sigma2 = r * r / np.float32(passes)
    ll = np.sqrt(np.float32(12.0) * sigma2 + np.float32(1.0), dtype=np.float32)
    l = int((ll - np.float32(1.0)) / np.float32(2.0))
    t = (
        np.float32(2 * l + 1)
        * (sigma2 - np.float32(l * (l + 1)) / np.float32(3.0))
        / (np.float32(2.0) * (np.float32((l + 1) ** 2) - sigma2))
    )
    return float(np.float32(l + t))


def _pil_box_pass(xi: torch.Tensor, float_radius: float, dim: int) -> torch.Tensor:
    """One PIL box-blur pass (BoxBlur.c) along H (dim 1) or W (dim 2) of an
    int64 NHWC batch: 2l+1 inner taps of weight ``ww = trunc(f32(2^24) /
    (2r + 1))``, the two edge taps at distance l + 1 (clamped to the image)
    of weight ``fw = (2^24 - (2l+1)ww) // 2``, then ``(sum + 2^23) >> 24``.
    The inner window is a difference of an exclusive prefix sum; every sum
    is an exact int64."""
    fr = np.float32(float_radius)
    l = int(fr)
    ww = int(np.float32(1 << 24) / (fr * np.float32(2) + np.float32(1)))
    fw = ((1 << 24) - (2 * l + 1) * ww) // 2
    n = xi.shape[dim]
    idx = torch.clamp(torch.arange(-(l + 1), n + l + 1, device=xi.device), 0, n - 1)
    xe = xi.index_select(dim, idx)  # edge padded by l + 1
    q = torch.nn.functional.pad(torch.cumsum(xe, dim=dim).movedim(dim, -1), (1, 0))
    q = q.movedim(-1, dim)
    acc = q.narrow(dim, 2 * l + 2, n) - q.narrow(dim, 1, n)  # the 2l+1 inner taps
    lr = xe.narrow(dim, 0, n) + xe.narrow(dim, 2 * l + 2, n)  # the two edge taps
    return (acc * ww + lr * fw + (1 << 23)) >> 24


def pil_box_blur(img: torch.Tensor, radius: float, passes: int = 1) -> torch.Tensor:
    """PIL ImageFilter.BoxBlur(radius), bit-exact: ``passes`` horizontal
    passes, then ``passes`` vertical ones, each quantized to u8 (integers
    throughout). u8 in, u8 out; float input is truncated and clipped first
    and comes back as f32."""
    x, single = as_batch(img)
    xi = torch.clamp(torch.trunc(as_float(x)), 0.0, 255.0).to(torch.int64)
    for _ in range(passes):
        xi = _pil_box_pass(xi, radius, 2)
    for _ in range(passes):
        xi = _pil_box_pass(xi, radius, 1)
    out = xi.to(torch.uint8) if img.dtype == torch.uint8 else xi.to(torch.float32)
    return restore_layout(out, single)


def pil_gaussian_blur(img: torch.Tensor, radius: float) -> torch.Tensor:
    """PIL ImageFilter.GaussianBlur(radius), bit-exact: three extended-box
    passes an axis with the variance-matched fractional radius
    (``pil_gauss_box_radius``), as Pillow implements it; the
    TransformationPool's defocus_blur primitive
    (pipenline/cifar_image_transformations.py:72-76)."""
    return pil_box_blur(img, pil_gauss_box_radius(radius, 3), 3)
