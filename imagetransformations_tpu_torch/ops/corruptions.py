"""The CIFAR-10-C corruption generators, batched (PyTorch).

Counterpart of ``imagetransformations_tpu/ops/corruptions.py``: the 15
canonical corruptions of the reference's evaluation
(attacks/uncertainty/FINAL_cifar_corrupted.py:22-27) and the four more of
its store, generated on the device instead of loaded from ``.npy`` files.
The semantics are the JAX package's numpy oracle's
(``oracle/corruptions.py``), with the severity tables copied value for
value. The JAX package computes all of them in plain XLA (no Pallas
kernel), and so does this module in plain PyTorch, on the image tensor's
device.

Every random generator takes its draws explicitly (``offsets=``,
``draws=``, ``u_seed=`` / ``u_amp=`` / ``g_noise=``, ``angles_deg=``,
``disp=`` / ``jitter=``, ``noise=``), or draws them with the JAX call's
shapes and distributions from ``generator`` (a ``torch.Generator`` on the
tensor's device; the JAX package takes a ``key``).

The card and the CPU give the same bytes:

- every convolution is a sum of shifted multiply-adds in a fixed order
  (row-major taps, the oracle's order; taps that are zero for every image
  are skipped, which adds nothing), never ``F.conv2d`` (on the card cuDNN
  may run it in TF32) and never a matrix product (the JPEG's 8x8 DCTs are
  eight f32 multiply-adds a coefficient);
- a division by a number is a true division (a tensor divisor: PyTorch's
  CUDA kernel multiplies by the reciprocal of a Python-number divisor);
- the line PSFs take their cos, sin and exp in f64 rounded to f32, and
  their sums, like the per-image means and deviations, in f64;
- the elastic corruption's affine is solved on the host in f64, as the
  oracle solves it.

Against the JAX package (XLA-CPU contracts multiply-adds and reduces in its
own order) and the oracle the gate is 1 LSB; the JPEG's quantization can
flip a bin, moving one 8x8 block by up to a quantization step.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from imagetransformations_tpu_torch.core.image import as_batch, restore_layout, trig_f32
from imagetransformations_tpu_torch.ops import _corruption_host as host
from imagetransformations_tpu_torch.ops.stencil import _reflect_indices
from imagetransformations_tpu_torch.ops.warp import pil_resize
from imagetransformations_tpu_torch.utils import profiling

F32 = torch.float32

#: severity -> parameters (index with severity - 1), the JAX package's
#: tables. Glass: (sigma, max_delta, iterations), severity 1 calibrated
#: against the reference store's real samples (ops/corruptions.py:43-56 of
#: the JAX package says how).
GLASS_BLUR_SEV = [(0.33, 1, 1), (0.41, 1, 2), (0.52, 1, 3), (0.52, 2, 1), (0.52, 2, 2)]
FOG_SEV = [(0.2, 3.0), (0.5, 3.0), (0.75, 2.5), (1.0, 2.0), (1.5, 1.75)]
FROST_SEV = [(1.0, 0.2), (1.0, 0.3), (0.9, 0.4), (0.85, 0.4), (0.75, 0.45)]
#: (loc, scale, zoom, thresh, mb_radius, mb_sigma, blend)
SNOW_SEV = [
    (0.1, 0.33, 1.0, 0.85, 6, 2.5, 0.96),
    (0.12, 0.36, 1.0, 0.82, 7, 2.5, 0.94),
    (0.15, 0.4, 1.0, 0.75, 8, 3.0, 0.92),
    (0.18, 0.45, 1.0, 0.72, 9, 3.5, 0.9),
    (0.25, 0.55, 1.0, 0.65, 10, 5.0, 0.85),
]
#: (alpha_frac, sigma_frac) of min(H, W): the displacement-only recipe
ELASTIC_SEV = [(0.05, 0.22), (0.065, 0.2), (0.085, 0.17), (0.1, 0.14), (0.12, 0.11)]
#: (alpha_frac, sigma_frac, affine_frac) of min(H, W): random affine, then
#: a smoothed displacement; severity 1 is a pure affine
ELASTIC_AFFINE_SEV = [
    (0.0, 0.2, 0.08),
    (0.05, 0.2, 0.07),
    (0.08, 0.06, 0.06),
    (0.1, 0.04, 0.05),
    (0.12, 0.03, 0.03),
]
PIXELATE_SEV = [0.95, 0.9, 0.85, 0.75, 0.65]
JPEG_SEV = [80, 65, 58, 50, 40]
ZOOM_BLUR_SEV = [1.06, 1.11, 1.16, 1.21, 1.26]
#: CIFAR-10-C's noise severities (ImageNet-C's are about twice as strong)
GAUSSIAN_NOISE_SEV = [0.04, 0.06, 0.08, 0.09, 0.10]
SHOT_NOISE_SEV = [500.0, 250.0, 100.0, 75.0, 50.0]
IMPULSE_NOISE_SEV = [0.01, 0.02, 0.03, 0.05, 0.07]
#: (radius, alias_blur) of the disk PSF
DEFOCUS_SEV = [(0.3, 0.4), (0.4, 0.5), (0.5, 0.6), (1.0, 0.2), (1.5, 0.1)]
#: (radius, sigma) of the directional line PSF
MOTION_SEV = [(6, 1.0), (6, 1.5), (6, 2.0), (8, 2.0), (9, 2.5)]
CONTRAST_SEV = [0.75, 0.5, 0.4, 0.3, 0.15]
BRIGHTNESS_SEV = [0.05, 0.1, 0.15, 0.2, 0.3]
#: the store's four non-canonical corruptions
SPECKLE_SEV = [0.06, 0.1, 0.12, 0.16, 0.2]
GAUSSIAN_BLUR_SEV = [0.4, 0.6, 0.7, 0.8, 1.0]
#: (zq, sigma, opacity, mud)
SPATTER_SEV = [
    (1.6, 0.7, 0.55, False),
    (1.45, 0.8, 0.55, False),
    (1.3, 1.0, 0.6, False),
    (1.3, 0.7, 0.65, True),
    (1.15, 0.5, 0.65, True),
]
#: (a, b): s' = clip(a*s + b) on the HSV saturation
SATURATE_SEV = [(0.3, 0.0), (0.1, 0.0), (1.5, 0.0), (2.0, 0.1), (2.5, 0.2)]


# ------------------------------------------------------------- shared helpers


def _div(a: torch.Tensor, b: float) -> torch.Tensor:
    """``a / b`` as a true f32 division on every device (see the module note)."""
    return a / torch.tensor(b, dtype=a.dtype, device=a.device)


def _to01(x: torch.Tensor) -> torch.Tensor:
    return _div(x.to(F32), 255.0)


def _u8(x01: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x01 * 255.0), 0.0, 255.0).to(torch.uint8)


def _rint_like(x: torch.Tensor, img: torch.Tensor) -> torch.Tensor:
    """The [0, 255] result rounded to u8 values: u8 for a u8 ``img``, else
    those values in f32 (as the JAX ops return them)."""
    out = torch.clamp(torch.round(x), 0.0, 255.0).to(torch.uint8)
    return out if img.dtype == torch.uint8 else out.to(F32)


def _f32(v: float) -> float:
    """``v`` rounded to f32, as a Python number (an exact f32 operand)."""
    return float(np.float32(v))


def _batch_draw(a, x: torch.Tensor, ndim: int) -> torch.Tensor:
    """An explicit f32 draw on ``x``'s device, with a batch axis added when
    it has ``ndim - 1`` dimensions (one draw for a single image)."""
    t = torch.as_tensor(a, dtype=F32, device=x.device)
    return t[None] if t.ndim == ndim - 1 else t


def _mean64(x: torch.Tensor, dims) -> torch.Tensor:
    """The mean over ``dims`` (kept), summed in f64 and rounded to f32."""
    return x.to(torch.float64).mean(dim=dims, keepdim=True).to(F32)


def _pad_index(size: int, p: int, mode: str, device) -> torch.Tensor:
    """Source index of each of size + 2p positions: "edge" repeats the edge
    pixel, "reflect" is numpy's reflect (cv2's BORDER_REFLECT_101)."""
    if mode == "edge":
        return torch.clamp(torch.arange(-p, size + p, device=device), 0, size - 1)
    return _reflect_indices(size, p, device)


def _sep_gauss(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Separable sampled Gaussian (``gauss_taps_sigma``) over dims 1 and 2
    of an f32 [N, H, W, ...] tensor, edge borders; the taps summed in order
    as ``acc + tap[t] * x[t]``."""
    taps = host.gauss_taps_sigma(sigma)
    r = len(taps) // 2
    if r == 0:
        return x
    for dim in (1, 2):
        size = x.shape[dim]
        p = x.index_select(dim, _pad_index(size, r, "edge", x.device))
        acc = p.narrow(dim, 0, size) * float(taps[0])
        for t in range(1, len(taps)):
            acc = acc + p.narrow(dim, t, size) * float(taps[t])
        x = acc
    return x


def _sample_bilinear_clamped(xf: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of the f32 NHWC batch ``xf`` at coordinates ``yy``,
    ``xx`` (broadcastable to [N, H', W']), the 2x2 window clamped to the
    image, in the oracle's op order -> [N, H', W', C]."""
    n, h, w, _ = xf.shape
    yfl, xfl = torch.floor(yy), torch.floor(xx)
    y0, x0 = yfl.to(torch.int64), xfl.to(torch.int64)
    fy, fx = (yy - yfl)[..., None], (xx - xfl)[..., None]
    bidx = torch.arange(n, device=xf.device).view(n, 1, 1)

    def g(yi, xi):
        return xf[bidx, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]

    a, b = g(y0, x0), g(y0, x0 + 1)
    c, d = g(y0 + 1, x0), g(y0 + 1, x0 + 1)
    top = a + fx * (b - a)
    return top + fy * ((c + fx * (d - c)) - top)


def _clipped_zoom_coords(h: int, w: int, factor: float, device):
    """Hendrycks' clipped-zoom coordinates as [1, H, 1] and [1, 1, W] f32."""
    ys = torch.from_numpy(host.clipped_zoom_coords(h, float(factor))).to(device)
    xs = torch.from_numpy(host.clipped_zoom_coords(w, float(factor))).to(device)
    return ys.view(1, h, 1), xs.view(1, 1, w)


def _grouped_conv2d(x: torch.Tensor, kernels, mode: str) -> torch.Tensor:
    """2-D 'same' correlation of [N, H, W] or [N, H, W, C] f32 with one
    [K, K] kernel (numpy, shared) or one kernel an image ([N, K, K] tensor),
    border ``mode`` ("edge" or "reflect"): the taps in row-major order,
    ``acc + k[i, j] * x[i, j]``, each op rounded on its own. A tap that is
    zero for every image adds nothing and is skipped."""
    chan = x.ndim == 4
    xv = x if chan else x[..., None]
    n, h, w, _ = xv.shape
    shared = isinstance(kernels, np.ndarray)
    k = kernels.shape[-1]
    r = k // 2
    xp = xv.index_select(1, _pad_index(h, r, mode, x.device))
    xp = xp.index_select(2, _pad_index(w, r, mode, x.device))
    if shared:
        live = kernels != 0
    else:
        live = profiling.host_read((kernels != 0).any(dim=0), "corruptions.live_taps").numpy()
    acc = None
    for i in range(k):
        for j in range(k):
            if not live[i, j]:
                continue
            wt = float(kernels[i, j]) if shared else kernels[:, i, j].view(n, 1, 1, 1)
            term = xp[:, i : i + h, j : j + w] * wt
            acc = term if acc is None else acc + term
    if acc is None:
        acc = torch.zeros_like(xv)
    return acc if chan else acc[..., 0]


# ------------------------------------------------------------- zoom blur


def zoom_blur(img: torch.Tensor, max_zoom: float, step: float = 0.01) -> torch.Tensor:
    """The mean of the image and its clipped zooms at
    ``arange(1, max_zoom, step)`` (z = 1 is the image again), rint to u8."""
    x, single = as_batch(img)
    h, w = x.shape[1], x.shape[2]
    xf = x.to(F32)
    acc = xf
    zooms = host.zoom_factors(max_zoom, step)
    for z in zooms:
        if float(z) <= 1.0:
            acc = acc + xf
            continue
        yy, xx = _clipped_zoom_coords(h, w, float(z), x.device)
        acc = acc + _sample_bilinear_clamped(xf, yy, xx)
    out = _div(acc, float(len(zooms) + 1))
    return restore_layout(_rint_like(out, img), single)


# ------------------------------------------------------------- glass blur


def glass_blur(img: torch.Tensor, sigma: float, max_delta: int, iterations: int,
               generator: torch.Generator | None = None, offsets=None) -> torch.Tensor:
    """Gaussian blur, ``iterations`` rounds of random local displacement (a
    gather), Gaussian blur. ``offsets``: int [iterations, N, H, W, 2] of
    (dy, dx) in [-max_delta, max_delta - 1] (the recipe's
    ``randint(-d, d)``, high bound exclusive), [iterations, H, W, 2] for one
    draw shared by the batch; drawn from ``generator`` when not given."""
    x, single = as_batch(img)
    n, h, w, _ = x.shape
    if offsets is None:
        offsets = torch.randint(-max_delta, max_delta, (iterations, n, h, w, 2),
                                generator=generator, device=x.device)
    else:
        offsets = torch.as_tensor(offsets, device=x.device).to(torch.int64)
        if offsets.ndim == 4:
            offsets = offsets[:, None]
    xcur = _u8(_sep_gauss(_to01(x), sigma))
    yy = torch.arange(h, device=x.device).view(1, h, 1)
    xx = torch.arange(w, device=x.device).view(1, 1, w)
    bidx = torch.arange(n, device=x.device).view(n, 1, 1)
    for it in range(iterations):
        yi = torch.clamp(yy + offsets[it, ..., 0], 0, h - 1)
        xi = torch.clamp(xx + offsets[it, ..., 1], 0, w - 1)
        xcur = xcur[bidx, yi, xi]
    out01 = torch.clamp(_sep_gauss(_to01(xcur), sigma), 0.0, 1.0)
    return restore_layout(_u8(out01), single)


# ------------------------------------------------------------- fog


def _plasma_fractal(draws: torch.Tensor, wibbledecay: float, size: int) -> torch.Tensor:
    """Diamond-square, batched: draws [N, L, S, S] -> [N, S, S] in [0, 1].
    Level by level as the oracle: each step writes a strided slice in
    place and reads the draws at the positions it writes."""
    n = draws.shape[0]
    m = torch.zeros((n, size, size), dtype=F32, device=draws.device)
    # the wibble follows the oracle's f32 division chain
    stepsize, wibble, lvl = size, np.float32(100.0), 0
    while stepsize >= 2:
        half = stepsize // 2
        d = draws[:, lvl]
        wb = float(wibble)
        corner = m[:, 0:size:stepsize, 0:size:stepsize]
        sq = corner + torch.roll(corner, -1, dims=1)
        sq = sq + torch.roll(sq, -1, dims=2)
        m[:, half::stepsize, half::stepsize] = (
            sq / 4.0 + wb * d[:, half::stepsize, half::stepsize])
        dr = m[:, half::stepsize, half::stepsize].clone()
        ul = m[:, 0:size:stepsize, 0:size:stepsize].clone()
        ldr = dr + torch.roll(dr, 1, dims=1)
        lul = ul + torch.roll(ul, -1, dims=2)
        m[:, 0:size:stepsize, half::stepsize] = (
            (ldr + lul) / 4.0 + wb * d[:, 0:size:stepsize, half::stepsize])
        tdr = dr + torch.roll(dr, 1, dims=2)
        tul = ul + torch.roll(ul, -1, dims=1)
        m[:, half::stepsize, 0:size:stepsize] = (
            (tdr + tul) / 4.0 + wb * d[:, half::stepsize, 0:size:stepsize])
        stepsize //= 2
        wibble = np.float32(wibble / np.float32(wibbledecay))
        lvl += 1
    m = m - m.amin(dim=(1, 2), keepdim=True)
    return m / torch.clamp(m.amax(dim=(1, 2), keepdim=True), min=1e-12)


def plasma_levels(size: int) -> int:
    return int(math.log2(size))


def fog_size(h: int, w: int) -> int:
    """The plasma's side S: the next power of two >= max(H, W), at least 2."""
    return 1 << max(1, math.ceil(math.log2(max(h, w))))


def fog(img: torch.Tensor, strength: float, wibbledecay: float,
        generator: torch.Generator | None = None, draws=None) -> torch.Tensor:
    """``x01 += strength * plasma``, rescaled by ``max / (max + strength)``
    an image. ``draws``: uniform(-1, 1) [N, L, S, S], S = ``fog_size``,
    L = log2(S) ([L, S, S] for one image); drawn from ``generator`` when
    not given."""
    x, single = as_batch(img)
    n, h, w, _ = x.shape
    size = fog_size(h, w)
    if draws is None:
        u = torch.rand((n, plasma_levels(size), size, size), generator=generator,
                       device=x.device, dtype=F32)
        draws = u * 2.0 - 1.0
    else:
        draws = _batch_draw(draws, x, 4)
    x01 = _to01(x)
    plasma = _plasma_fractal(draws, wibbledecay, size)[:, :h, :w]
    max_val = x01.amax(dim=(1, 2, 3), keepdim=True)
    out = x01 + _f32(strength) * plasma[..., None]
    out = torch.clamp(out * max_val / (max_val + _f32(strength)), 0.0, 1.0)
    return restore_layout(_u8(out), single)


# ------------------------------------------------------------- frost


def frost(img: torch.Tensor, scale_img: float, scale_frost: float,
          generator: torch.Generator | None = None, u_seed=None, u_amp=None,
          g_noise=None) -> torch.Tensor:
    """``clip(scale_img * x + scale_frost * texture)``, the texture sparse
    crystal seeds blurred into halos over a smoothed noise backdrop.
    ``u_seed``, ``u_amp`` (uniform [0, 1)) and ``g_noise`` (standard
    normal), each [N, H, W], come together or are drawn from
    ``generator`` in that order."""
    x, single = as_batch(img)
    n, h, w, _ = x.shape
    if u_seed is None:
        u_seed = torch.rand((n, h, w), generator=generator, device=x.device, dtype=F32)
        u_amp = torch.rand((n, h, w), generator=generator, device=x.device, dtype=F32)
        g_noise = torch.randn((n, h, w), generator=generator, device=x.device, dtype=F32)
    else:
        if u_amp is None or g_noise is None:
            raise ValueError("frost: u_seed, u_amp and g_noise must all be given together")
        u_seed, u_amp, g_noise = (_batch_draw(a, x, 3) for a in (u_seed, u_amp, g_noise))
    seeds = torch.where(u_seed > 0.98, 0.5 + 0.5 * u_amp, 0.0)
    halos = _sep_gauss(seeds[..., None], 1.2)[..., 0] * 6.0
    backdrop = _sep_gauss(g_noise[..., None], 2.0)[..., 0] * _f32(0.9) + _f32(0.55)
    tex = torch.clamp(halos + backdrop, 0.0, 1.0)[..., None]
    out = torch.clamp(_f32(scale_img) * _to01(x) + _f32(scale_frost) * tex, 0.0, 1.0)
    return restore_layout(_u8(out), single)


# ------------------------------------------------------------- line PSFs


def _motion_kernels_batched(angles_deg: torch.Tensor, radius: int, sigma: float) -> torch.Tensor:
    """[N] angles -> [N, K, K] line PSFs (the oracle's ``motion_kernel``) in
    f32, in its op order, with cos, sin and exp taken in f64 and rounded to
    f32 and the normalizing sum taken in f64: the same on every device."""
    dev = angles_deg.device
    grid = torch.arange(-radius, radius + 1, dtype=F32, device=dev)
    ys, xs = grid.view(1, -1, 1), grid.view(1, 1, -1)
    a = torch.deg2rad(angles_deg.to(F32)).view(-1, 1, 1)
    dx, dy = trig_f32(torch.cos, a), trig_f32(torch.sin, a)
    along = xs * dx + ys * dy
    across = (-xs) * dy + ys * dx
    e_across = torch.exp(_div(-(across * across), 0.5).to(torch.float64)).to(F32)
    e_along = torch.exp(_div(-(along * along), _f32(2.0 * sigma * sigma)).to(torch.float64))
    wgt = e_across * e_along.to(F32)
    wgt = torch.where(torch.abs(along) <= float(radius), wgt, 0.0)
    total = wgt.to(torch.float64).sum(dim=(1, 2), keepdim=True).to(F32)
    return wgt / total


# ------------------------------------------------------------- snow


def snow(img: torch.Tensor, loc: float, scale: float, zoom: float, thresh: float,
         mb_radius: int, mb_sigma: float, blend: float,
         generator: torch.Generator | None = None, g_noise=None, angles_deg=None) -> torch.Tensor:
    """Snow field -> clipped zoom -> threshold -> a directional motion blur
    an image (one line PSF an image) -> graying blend -> add the layer and
    the layer turned by 180 degrees. ``g_noise``: standard normal
    [N, H, W]; ``angles_deg``: [N] in U(-135, -45); drawn from ``generator``
    in that order when ``g_noise`` is not given."""
    x, single = as_batch(img)
    n, h, w, _ = x.shape
    if g_noise is None:
        g_noise = torch.randn((n, h, w), generator=generator, device=x.device, dtype=F32)
        angles_deg = torch.rand((n,), generator=generator, device=x.device, dtype=F32) * 90.0
        angles_deg = angles_deg - 135.0
    else:
        if angles_deg is None:
            raise ValueError("snow: angles_deg is required when g_noise is given")
        g_noise = _batch_draw(g_noise, x, 3)
        angles_deg = torch.as_tensor(angles_deg, dtype=F32, device=x.device).reshape(-1)
    x01 = _to01(x)
    layer = g_noise * _f32(scale) + _f32(loc)
    if zoom > 1.0:
        yy, xx = _clipped_zoom_coords(h, w, float(zoom), x.device)
        layer = _sample_bilinear_clamped(layer[..., None], yy, xx)[..., 0]
    layer = torch.where(layer < _f32(thresh), 0.0, layer)
    layer = _grouped_conv2d(layer, _motion_kernels_batched(angles_deg, mb_radius, mb_sigma),
                            "edge")
    gray = _div((x01[..., 0:1] + x01[..., 1:2]) + x01[..., 2:3], 3.0)
    x01 = _f32(blend) * x01 + float(np.float32(1.0) - np.float32(blend)) * torch.maximum(
        x01, gray * 1.5 + 0.5)
    out = (x01 + layer[..., None]) + torch.flip(layer, dims=(1, 2))[..., None]
    return restore_layout(_u8(torch.clamp(out, 0.0, 1.0)), single)


# ------------------------------------------- photometric (CIFAR-10-C exact)


def contrast_meanpreserve(img: torch.Tensor, c: float) -> torch.Tensor:
    """CIFAR-10-C contrast: ``clip((x - mean) * c + mean)`` with each image's
    per-channel means (mean-preserving, unlike transformation.py's
    convertScaleAbs contrast)."""
    x, single = as_batch(img)
    x01 = _to01(x)
    means = _mean64(x01, (1, 2))
    out = torch.clamp((x01 - means) * _f32(c) + means, 0.0, 1.0)
    return restore_layout(_u8(out), single)


def brightness_hsv(img: torch.Tensor, c: float) -> torch.Tensor:
    """CIFAR-10-C brightness: +c on the HSV value. With H and S fixed the
    round trip is ``rgb * clip(v + c, 0, 1) / v`` (v = max(rgb); v = 0 gives
    the gray c)."""
    x, single = as_batch(img)
    x01 = _to01(x)
    v = x01.amax(dim=-1, keepdim=True)
    v2 = torch.clamp(v + _f32(c), 0.0, 1.0)
    out = torch.where(v > 0, x01 * (v2 / torch.clamp(v, min=1e-12)), v2)
    return restore_layout(_u8(torch.clamp(out, 0.0, 1.0)), single)


def saturate_hsv(img: torch.Tensor, a: float, b: float) -> torch.Tensor:
    """CIFAR-10-C saturate: ``s' = clip(a*s + b)`` on the HSV saturation,
    i.e. ``rgb' = v - (v - rgb) * s'/s`` with H and V fixed; achromatic
    pixels (s = 0) take hue 0, so with b > 0 they tint red,
    (v, v(1 - s'), v(1 - s')), as skimage's round trip does."""
    x, single = as_batch(img)
    x01 = _to01(x)
    v = x01.amax(dim=-1, keepdim=True)
    mn = x01.amin(dim=-1, keepdim=True)
    s = torch.where(v > 0, (v - mn) / torch.clamp(v, min=1e-12), 0.0)
    s2 = torch.clamp(_f32(a) * s + _f32(b), 0.0, 1.0)
    ratio = s2 / torch.clamp(s, min=1e-12)
    grayv = v * (1.0 - s2)
    tint = torch.cat([v, grayv, grayv], dim=-1)
    out = torch.where(s > 0, v - (v - x01) * ratio, tint)
    return restore_layout(_u8(torch.clamp(out, 0.0, 1.0)), single)


# ------------------------------------------- blurs (disk, line, Gaussian)


def defocus_blur_disk(img: torch.Tensor, radius: float, alias_blur: float) -> torch.Tensor:
    """CIFAR-10-C defocus: the anti-aliased disk PSF (Hendrycks' disk()) on
    each channel of the [0, 1] image, reflect-101 border. (The
    TransformationPool's defocus, PIL GaussianBlur of radius 3-10, is
    ``stencil.pil_gaussian_blur``.)"""
    x, single = as_batch(img)
    k = host.disk_kernel(float(radius), float(alias_blur))
    out = _grouped_conv2d(_to01(x), k, "reflect")
    return restore_layout(_u8(torch.clamp(out, 0.0, 1.0)), single)


def motion_blur_directional(img: torch.Tensor, radius: int, sigma: float,
                            generator: torch.Generator | None = None,
                            angles_deg=None) -> torch.Tensor:
    """CIFAR-10-C-style motion blur: a line PSF an image at an angle in
    U(-45, 45) (``angles_deg``, [N]; drawn from ``generator`` when not
    given), reflect-101 border."""
    x, single = as_batch(img)
    n = x.shape[0]
    if angles_deg is None:
        angles_deg = torch.rand((n,), generator=generator, device=x.device, dtype=F32) * 90.0
        angles_deg = angles_deg - 45.0
    else:
        angles_deg = torch.as_tensor(angles_deg, dtype=F32, device=x.device).reshape(-1)
    kern = _motion_kernels_batched(angles_deg, int(radius), float(sigma))
    out = _grouped_conv2d(_to01(x), kern, "reflect")
    return restore_layout(_u8(torch.clamp(out, 0.0, 1.0)), single)


def gaussian_blur_sigma_op(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """CIFAR-10-C gaussian_blur: the sampled-Gaussian separable blur on the
    [0, 1] image, edge border."""
    x, single = as_batch(img)
    out = torch.clamp(_sep_gauss(_to01(x), float(sigma)), 0.0, 1.0)
    return restore_layout(_u8(out), single)


# ------------------------------------------------------------- elastic


def elastic_transform(img: torch.Tensor, alpha: float, sigma: float,
                      generator: torch.Generator | None = None, disp=None) -> torch.Tensor:
    """Bilinear warp by a Gaussian-smoothed random displacement field.
    ``disp``: uniform(-1, 1) [N, H, W, 2] (dy, dx), drawn from ``generator``
    when not given; ``alpha`` and ``sigma`` in pixels (``elastic_params``)."""
    x, single = as_batch(img)
    n, h, w, _ = x.shape
    if disp is None:
        disp = torch.rand((n, h, w, 2), generator=generator, device=x.device, dtype=F32)
        disp = disp * 2.0 - 1.0
    else:
        disp = _batch_draw(disp, x, 4)
    sm = _sep_gauss(disp, sigma) * _f32(alpha)
    yy = torch.arange(h, dtype=F32, device=x.device).view(1, h, 1) + sm[..., 0]
    xx = torch.arange(w, dtype=F32, device=x.device).view(1, 1, w) + sm[..., 1]
    out = _sample_bilinear_clamped(x.to(F32), yy, xx)
    return restore_layout(_rint_like(out, img), single)


def _fold101(c: torch.Tensor, size: int) -> torch.Tensor:
    """Reflect-101 fold of a coordinate into [0, size - 1] (cv2's BORDER_REFLECT_101)."""
    if size == 1:
        return torch.zeros_like(c)
    period = float(2 * (size - 1))
    c = torch.fmod(torch.abs(c), period)
    return torch.minimum(c, period - c)


def _foldsym(c: torch.Tensor, size: int) -> torch.Tensor:
    """Symmetric (edge-repeated) fold of a continuous coordinate: scipy
    map_coordinates' mode='reflect', the reflection axis at -0.5."""
    period = float(2 * size)
    t = torch.remainder(c + 0.5, period)
    return torch.minimum(t, period - t) - 0.5


def elastic_transform_affine(img: torch.Tensor, alpha: float, sigma: float, alpha_affine: float,
                             generator: torch.Generator | None = None, disp=None,
                             jitter=None) -> torch.Tensor:
    """CIFAR-10-C elastic: a random affine an image (the anchor triangle's
    corners jittered by U(-alpha_affine, alpha_affine) px, bilinear,
    reflect-101 border), then a bilinear resample along a Gaussian-smoothed
    displacement field (symmetric border). ``jitter``: [N, 3, 2];
    ``disp``: uniform(-1, 1) [N, H, W, 2], needed when alpha > 0; drawn
    from ``generator`` in that order when ``jitter`` is not given. The
    affine is solved on the host in f64 (the oracle's solve) and rounded to
    f32, so each device warps with the same matrix; a jitter on the card
    is read back first."""
    x, single = as_batch(img)
    n, h, w, _ = x.shape
    if jitter is None:
        u = torch.rand((n, 3, 2), generator=generator, device=x.device, dtype=F32)
        jitter = u * _f32(2.0 * alpha_affine) - _f32(alpha_affine)
        if disp is None and alpha > 0:
            disp = torch.rand((n, h, w, 2), generator=generator, device=x.device, dtype=F32)
            disp = disp * 2.0 - 1.0
    else:
        jitter = _batch_draw(jitter, x, 3)
    pts1 = host.elastic_points(h, w)
    pts2 = pts1[None] + profiling.host_read(jitter, "corruptions.elastic_jitter").numpy().astype(
        np.float32)
    minv = host.affine_from_points(pts2, np.broadcast_to(pts1, pts2.shape)).astype(np.float32)
    m = torch.from_numpy(minv.reshape(n, 6)).to(x.device).view(n, 6, 1, 1)
    yy = torch.arange(h, dtype=F32, device=x.device).view(1, h, 1)
    xx = torch.arange(w, dtype=F32, device=x.device).view(1, 1, w)
    sx = m[:, 0] * xx + m[:, 1] * yy + m[:, 2]
    sy = m[:, 3] * xx + m[:, 4] * yy + m[:, 5]
    out = _sample_bilinear_clamped(x.to(F32), _fold101(sy, h), _fold101(sx, w))
    if alpha > 0:
        if disp is None:
            raise ValueError("elastic_transform_affine: disp required when alpha > 0")
        sm = _sep_gauss(_batch_draw(disp, x, 4), sigma) * _f32(alpha)
        out = _sample_bilinear_clamped(out, _foldsym(yy + sm[..., 0], h),
                                       _foldsym(xx + sm[..., 1], w))
    return restore_layout(_rint_like(out, img), single)


def elastic_affine_pixels(h: int, w: int, af: float, sf: float,
                          aa: float) -> tuple[float, float, float]:
    """(alpha, sigma, alpha_affine) fractions of min(H, W) -> pixels (sigma
    at least 0.5 px, so tiny images still displace)."""
    m = min(h, w)
    return af * m, max(sf * m, 0.5), aa * m


def elastic_affine_params(h: int, w: int, severity: int) -> tuple[float, float, float]:
    """Severity -> (alpha, sigma, alpha_affine) in pixels for an HxW image."""
    af, sf, aa = ELASTIC_AFFINE_SEV[severity - 1]
    return elastic_affine_pixels(h, w, af, sf, aa)


def elastic_pixels(h: int, w: int, af: float, sf: float) -> tuple[float, float]:
    """(alpha_frac, sigma_frac) -> (alpha, sigma) in pixels (sigma at least 0.5 px)."""
    m = min(h, w)
    return af * m, max(sf * m, 0.5)


def elastic_params(h: int, w: int, severity: int) -> tuple[float, float]:
    """Severity -> (alpha, sigma) in pixels for an HxW image."""
    af, sf = ELASTIC_SEV[severity - 1]
    return elastic_pixels(h, w, af, sf)


# ------------------------------------------------------------- pixelate


def pixelate(img: torch.Tensor, factor: float) -> torch.Tensor:
    """PIL-exact pixelation: a BOX downscale to (int(W*f), int(H*f))
    (``warp.pil_resize``), then a NEAREST upscale by PIL's index map."""
    x, single = as_batch(img)
    h, w = x.shape[1], x.shape[2]
    nw, nh = max(1, int(w * factor)), max(1, int(h * factor))
    small = pil_resize(x, nw, nh, "box")
    ys = torch.from_numpy(host.nearest_resize_map(nh, h)).to(x.device)
    xs = torch.from_numpy(host.nearest_resize_map(nw, w)).to(x.device)
    return restore_layout(small[:, ys][:, :, xs], single)


# ------------------------------------------------------------- jpeg


def _mm8(d: torch.Tensor, b: torch.Tensor, left: bool) -> torch.Tensor:
    """An 8x8 matrix product on the last two dims of ``b``, as eight f32
    multiply-adds a coefficient in index order: ``d @ b`` (``left``) or
    ``b @ d``."""
    acc = None
    for j in range(8):
        if left:
            term = d[:, j : j + 1] * b[..., j : j + 1, :]
        else:
            term = b[..., :, j : j + 1] * d[j : j + 1]
        acc = term if acc is None else acc + term
    return acc


def _jpeg_channel(ch: torch.Tensor, q: np.ndarray) -> torch.Tensor:
    """[N, H, W] f32 (H, W multiples of 8) -> the DCT, quantize, dequantize,
    inverse DCT round trip of each 8x8 block."""
    d = torch.from_numpy(host.dct_matrix()).to(ch.device)
    qt = torch.from_numpy(q).to(ch.device)
    n, h, w = ch.shape
    b = ch.reshape(n, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4) - 128.0
    coef = _mm8(d.T.contiguous(), _mm8(d, b, True), False)  # d @ b @ d.T
    qc = torch.round(coef / qt) * qt
    rec = _mm8(d, _mm8(d.T.contiguous(), qc, True), False)  # d.T @ qc @ d
    return rec.permute(0, 1, 3, 2, 4).reshape(n, h, w) + 128.0


def _fancy_upsample_2x(c_u8: torch.Tensor) -> torch.Tensor:
    """libjpeg's h2v2 fancy (triangular) chroma upsampling, batched and
    integer-exact: [N, h, w] u8 -> [N, 2h, 2w] int32."""
    c = c_u8.to(torch.int32)
    n, h, w = c.shape
    up = torch.cat([c[:, :1], c[:, :-1]], dim=1)
    dn = torch.cat([c[:, 1:], c[:, -1:]], dim=1)
    rows = torch.stack([3 * c + up, 3 * c + dn], dim=2).reshape(n, 2 * h, w)
    left = torch.cat([rows[:, :, :1], rows[:, :, :-1]], dim=2)
    right = torch.cat([rows[:, :, 1:], rows[:, :, -1:]], dim=2)
    out = torch.stack([(3 * rows + left + 8) >> 4, (3 * rows + right + 8) >> 4],
                      dim=3).reshape(n, 2 * h, 2 * w)
    out[:, :, 0] = (rows[:, :, 0] * 4 + 8) >> 4
    out[:, :, -1] = (rows[:, :, -1] * 4 + 8) >> 4
    return out


def _pad_to(x: torch.Tensor, mult: int) -> torch.Tensor:
    """Edge-pad [N, H, W] up to multiples of ``mult``."""
    h, w = x.shape[1], x.shape[2]
    ph, pw = (-h) % mult, (-w) % mult
    if not (ph or pw):
        return x
    rows = torch.clamp(torch.arange(h + ph, device=x.device), max=h - 1)
    cols = torch.clamp(torch.arange(w + pw, device=x.device), max=w - 1)
    return x[:, rows][:, :, cols]


def _subsample(c: torch.Tensor) -> torch.Tensor:
    """4:2:0: the mean of each 2x2 block of the even-padded plane, summed
    as ((c00 + c01) + c10) + c11."""
    c = _pad_to(c, 2)
    return (((c[:, 0::2, 0::2] + c[:, 0::2, 1::2]) + c[:, 1::2, 0::2]) + c[:, 1::2, 1::2]) / 4.0


def jpeg_compression(img: torch.Tensor, quality: int) -> torch.Tensor:
    """A JPEG round trip of the pixel data: YCbCr, 4:2:0, 8x8 DCT with
    libjpeg's quality-scaled quantization, fancy chroma upsampling, the
    inverse colour transform (entropy coding is lossless and left out)."""
    x, single = as_batch(img)
    n, h, w, _ = x.shape
    xf = x.to(F32)
    r, g, b = xf[..., 0], xf[..., 1], xf[..., 2]
    y = _f32(0.299) * r + _f32(0.587) * g + _f32(0.114) * b
    cb = _f32(-0.168736) * r - _f32(0.331264) * g + 0.5 * b + 128.0
    cr = 0.5 * r - _f32(0.418688) * g - _f32(0.081312) * b + 128.0
    qy, qc = host.jpeg_quant_tables(quality)
    yr = torch.clamp(torch.round(_jpeg_channel(_pad_to(y, 8), qy)[:, :h, :w]), 0, 255)
    cbr = torch.clamp(torch.round(_jpeg_channel(_pad_to(_subsample(cb), 8), qc)), 0, 255)
    crr = torch.clamp(torch.round(_jpeg_channel(_pad_to(_subsample(cr), 8), qc)), 0, 255)
    cbu = _fancy_upsample_2x(cbr.to(torch.uint8))[:, :h, :w].to(F32) - 128.0
    cru = _fancy_upsample_2x(crr.to(torch.uint8))[:, :h, :w].to(F32) - 128.0
    ro = yr + _f32(1.402) * cru
    go = yr - _f32(0.344136) * cbu - _f32(0.714136) * cru
    bo = yr + _f32(1.772) * cbu
    out = torch.clamp(torch.round(torch.stack([ro, go, bo], dim=-1)), 0.0, 255.0)
    return restore_layout(out.to(torch.uint8), single)


# ------------------------------------------------------------- noise and liquids


def speckle_noise(img: torch.Tensor, c, generator: torch.Generator | None = None,
                  noise=None) -> torch.Tensor:
    """CIFAR-10-C speckle: ``clip(x + x * N(0, c))`` on [0, 1]. ``noise``:
    standard normal of the image's shape, drawn from ``generator`` when not
    given; ``c`` a scalar or one value an image."""
    x, single = as_batch(img)
    if noise is None:
        noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=F32)
    else:
        noise = _batch_draw(noise, x, 4)
    cv = torch.as_tensor(c, dtype=F32, device=x.device)
    if cv.ndim == 0:
        cv = cv.expand(x.shape[0])
    x01 = _to01(x)
    out = torch.clamp(x01 + x01 * (noise * cv.reshape(-1, 1, 1, 1)), 0.0, 1.0)
    return restore_layout(_u8(out), single)


def spatter(img: torch.Tensor, zq: float, sigma: float, opacity: float, mud: bool,
            generator: torch.Generator | None = None, g_noise=None) -> torch.Tensor:
    """CIFAR-10-C-style spatter: a smoothed Gaussian liquid field,
    z-normalized an image (mean and deviation in f64) and thresholded at
    ``zq``, blended as water (blue tint) or mud (brown). ``g_noise``:
    standard normal [N, H, W], drawn from ``generator`` when not given."""
    x, single = as_batch(img)
    n, h, w, _ = x.shape
    if g_noise is None:
        g_noise = torch.randn((n, h, w), generator=generator, device=x.device, dtype=F32)
    else:
        g_noise = _batch_draw(g_noise, x, 3)
    x01 = _to01(x)
    field = _sep_gauss(g_noise[..., None], float(sigma))[..., 0]
    f64 = field.to(torch.float64)
    mu64 = f64.mean(dim=(1, 2), keepdim=True)
    sd64 = ((f64 - mu64) ** 2).mean(dim=(1, 2), keepdim=True).sqrt()
    sd = torch.clamp(sd64.to(F32), min=_f32(1e-6))
    z = (field - mu64.to(F32)) / sd
    m = torch.clamp((z - _f32(zq)) * 3.0, 0.0, 1.0)[..., None]
    rgb = (63.0, 42.0, 20.0) if mud else (175.0, 238.0, 238.0)
    color = torch.from_numpy(np.asarray(rgb, np.float32) / np.float32(255.0)).to(x.device)
    om = _f32(opacity) * m
    out = x01 * (1.0 - om) + color.view(1, 1, 1, 3) * om
    return restore_layout(_u8(torch.clamp(out, 0.0, 1.0)), single)
