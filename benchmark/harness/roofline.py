"""The yardstick's arithmetic: the card's peaks, the work a transform call
needs, and a network's multiply-adds.

The work is the transform's, as the reference library defines it, never
the operations of the way the port computes it (the LANCZOS scale's f64
matrix products, a kernel's recomputed taps): so a later implementation
that does less work cannot read above 100%. Bytes count each input byte
read once and each output byte written once."""

from __future__ import annotations

import functools

import numpy as np
import torch

from reference import resize
from reference import transforms as rt
from reference.image import cv2_gaussian_ksize

#: NVIDIA H100 SXM, the published dense rates at the full 700 W
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12  # outside the tensor cores: 33.5e12 FMA/s


def least_time_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the two roofs."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS)


@functools.lru_cache(maxsize=64)
def _lanczos_axis(size: int, factor: float) -> tuple[int, int]:
    """(output positions that stay on the canvas, filter taps summed over
    them) for one axis of PIL's LANCZOS resize of ``size`` by ``factor``:
    the crop of an upscale keeps ``size`` of them; the black pad of a
    downscale needs no taps."""
    nsize = int(size * factor)
    bounds, _ = resize.resize_coeffs(size, nsize, "lanczos")
    widths = bounds[:, 1]
    if factor > 1.0:
        off = (nsize - size) // 2
        widths = widths[off: off + size]
    return len(widths), int(widths.sum())


def apply_all_work(shape: tuple, values: dict) -> tuple[float, float]:
    """(bytes, flops) of one call of the 8-type sweep on a u8 batch of
    ``shape`` (N, H, W, C) with each type's drawn values ({type: [N]}).
    Flops a pixel-channel: scale, PIL's separable LANCZOS (2 a tap); rotation
    (3 shears, a linear interpolation of 3 ops each, none at angle 0);
    brightness 1; noise 2; translation 0; contrast 1; blur, cv2's separable
    Gaussian (2 passes of ksize taps, 2 a tap, none at radius 0); shear,
    PIL's horizontal BICUBIC (4 taps)."""
    n, h, w, c = shape
    px = h * w * c
    nbytes = n * px + len(rt.TYPES) * n * px + len(rt.TYPES) * n * 4
    v = {t: np.asarray(values[t], np.float64) for t in rt.TYPES}
    scale = 0.0
    for f in np.asarray(values["scale"], np.float32):
        kept_w, taps_w = _lanczos_axis(w, float(f))
        taps_h = _lanczos_axis(h, float(f))[1]
        scale += 2.0 * c * (h * taps_w + kept_w * taps_h)  # horizontal pass, then vertical
    rotation = 9.0 * px * np.count_nonzero(v["rotation"])
    blur = sum(4.0 * cv2_gaussian_ksize(float(r)) * px for r in v["blur"] if r > 0)
    flops = (scale + rotation + (1.0 + 2.0 + 1.0) * n * px + blur
             + 8.0 * px * np.count_nonzero(v["shear"]))
    return float(nbytes), float(flops)


def chain_work(shape: tuple, radius: float) -> tuple[float, float]:
    """(bytes, flops) of blur -> rotation -> grayscale on a u8 RGB batch:
    the gray result needs one plane (the blur and the shears are linear, so
    they commute with the luma), so a pixel takes the luma (5), the
    separable blur (2 passes of ksize taps, 2 a tap), 3 shears (3 each) and
    the rounding (1); 3 bytes in and 3 out."""
    n, h, w, c = shape
    per_px = 5.0 + 4.0 * cv2_gaussian_ksize(float(radius)) + 9.0 + 1.0
    return float(2 * n * h * w * c), float(per_px * n * h * w)


def macs_per_image(model: torch.nn.Module, x1: torch.Tensor) -> int:
    """Multiply-adds of one image's forward (``x1``: a batch of one), from
    the shapes each convolution and dense layer sees (forward hooks): a
    frozen copy of the port's ``chip_smoke.macs_per_image``."""
    total = [0]

    def hook(mod, inp, out):
        if isinstance(mod, torch.nn.Conv2d):
            k = mod.in_channels // mod.groups * mod.kernel_size[0] * mod.kernel_size[1]
        else:
            k = mod.in_features
        total[0] += out[0].numel() * k

    kinds = (torch.nn.Conv2d, torch.nn.Linear)
    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, kinds)]
    try:
        with torch.no_grad():
            model(x1)
    finally:
        for hd in handles:
            hd.remove()
    return total[0]
