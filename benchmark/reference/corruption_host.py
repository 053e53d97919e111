"""Frozen copy of the port's ``ops/_corruption_host.py`` (the benchmark's
reference). Its original docstring follows.

Host-side tables of the CIFAR-10-C corruption generators (numpy).

This package's own copy of the helpers that the JAX package's
``ops/corruptions.py`` takes from its numpy oracle
(``imagetransformations_tpu/oracle/corruptions.py``): Gaussian taps by
sigma, Hendrycks' clipped-zoom coordinates and zoom factors, PIL's NEAREST
resize map, libjpeg's quantization tables and the 8x8 DCT matrix, the line
and disk PSFs and the elastic anchor triangle; and the f64 affine solve of
the elastic corruption. Everything here is computed once on the host and
handed to ``ops.corruptions``, so the card and the CPU start from the same
numbers.
"""

from __future__ import annotations

import functools

import numpy as np

from .image import gaussian_taps

F32 = np.float32


def gauss_taps_sigma(sigma: float) -> np.ndarray:
    """Sampled-Gaussian 1-D taps, ksize = 2*ceil(3*sigma)+1, normalized (f32)."""
    if sigma <= 0:
        return np.ones(1, F32)
    r = int(np.ceil(3.0 * sigma))
    x = np.arange(-r, r + 1, dtype=F32)
    t = np.exp(-(x * x) / F32(2.0 * sigma * sigma))
    return (t / t.sum()).astype(F32)


def clipped_zoom_coords(size: int, factor: float) -> np.ndarray:
    """Hendrycks' clipped_zoom source coordinates along one axis (f32): an
    integer centre crop of ceil(size/z), scipy's order-1 (align-corners)
    upscale to round(crop*z), a centre trim back to ``size``."""
    if factor <= 1.0:
        return np.arange(size, dtype=F32)
    cs = int(np.ceil(size / factor))
    top = (size - cs) // 2
    os_ = int(round(cs * factor))
    trim = (os_ - size) // 2
    scale = F32((cs - 1) / max(os_ - 1, 1))
    return (F32(top) + (np.arange(size, dtype=F32) + F32(trim)) * scale).astype(F32)


def zoom_factors(max_zoom: float, step: float = 0.01) -> np.ndarray:
    """``np.arange(1, max_zoom, step)`` literally, its float overshoot
    included (arange(1, 1.06, 0.01) gives seven factors, as the CIFAR-10-C
    generator's does); z = 1 is the identity."""
    return np.arange(1.0, max_zoom, step)


def nearest_resize_map(in_size: int, out_size: int) -> np.ndarray:
    """PIL's NEAREST-resize source index of each output pixel: the floor of
    the sequentially rounded f64 sum ``scale*0.5 + k*scale`` (Geometry.c's
    incremental affine loop)."""
    a0 = np.float64(in_size) / np.float64(out_size)
    seq = np.cumsum(np.concatenate([[a0 * 0.5], np.full(out_size - 1, a0)]))
    return np.clip(seq.astype(np.int64), 0, in_size - 1)


_Q_LUM = np.array(
    [
        [16, 11, 10, 16, 24, 40, 51, 61],
        [12, 12, 14, 19, 26, 58, 60, 55],
        [14, 13, 16, 24, 40, 57, 69, 56],
        [14, 17, 22, 29, 51, 87, 80, 62],
        [18, 22, 37, 56, 68, 109, 103, 77],
        [24, 35, 55, 64, 81, 104, 113, 92],
        [49, 64, 78, 87, 103, 121, 120, 101],
        [72, 92, 95, 98, 112, 100, 103, 99],
    ],
    np.int32,
)
_Q_CHROM = np.array(
    [
        [17, 18, 24, 47, 99, 99, 99, 99],
        [18, 21, 26, 66, 99, 99, 99, 99],
        [24, 26, 56, 99, 99, 99, 99, 99],
        [47, 66, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
        [99, 99, 99, 99, 99, 99, 99, 99],
    ],
    np.int32,
)


def jpeg_quant_tables(quality: int) -> tuple[np.ndarray, np.ndarray]:
    """libjpeg's quality scaling: the Annex-K tables scaled and clamped to
    [1, 255] (f32 luma and chroma tables)."""
    q = int(np.clip(quality, 1, 100))
    scale = 5000 // q if q < 50 else 200 - 2 * q

    def s(tab):
        return np.clip((tab * scale + 50) // 100, 1, 255).astype(F32)

    return s(_Q_LUM), s(_Q_CHROM)


def dct_matrix() -> np.ndarray:
    """The orthonormal 8x8 DCT-II matrix (f32)."""
    k = np.arange(8).reshape(8, 1).astype(np.float64)
    n = np.arange(8).reshape(1, 8).astype(np.float64)
    d = np.cos(np.pi * (2 * n + 1) * k / 16.0) * np.sqrt(2.0 / 8.0)
    d[0] /= np.sqrt(2.0)
    return d.astype(F32)


def motion_kernel(radius: int, sigma: float, angle_deg: float) -> np.ndarray:
    """One line PSF of length 2*radius+1 at ``angle_deg`` with a Gaussian
    cross-section, in numpy f32 (the oracle's form; ``ops.corruptions``
    builds a batch of them on the device)."""
    k = 2 * radius + 1
    ys, xs = np.mgrid[-radius : radius + 1, -radius : radius + 1].astype(F32)
    a = np.deg2rad(F32(angle_deg))
    dx, dy = np.cos(a, dtype=F32), np.sin(a, dtype=F32)
    along = xs * dx + ys * dy
    across = -xs * dy + ys * dx
    sig_across = F32(0.5)
    w = np.exp(-(across * across) / (2 * sig_across * sig_across)) * np.exp(
        -(along * along) / F32(2.0 * sigma * sigma)
    )
    w = np.where(np.abs(along) <= F32(radius), w, F32(0.0)).reshape(k, k)
    return (w / w.sum()).astype(F32)


@functools.lru_cache(maxsize=16)
def disk_kernel(radius: float, alias_blur: float) -> np.ndarray:
    """Hendrycks' disk(): an anti-aliased disk PSF on a 17x17 grid (radius
    <= 8), blurred like cv2.GaussianBlur(ksize=(3, 3), sigmaX=alias_blur)
    (f32). Read-only: the cached array is shared."""
    grid = np.arange(-8, 8 + 1)
    xx, yy = np.meshgrid(grid, grid)
    disk = ((xx**2 + yy**2) <= radius**2).astype(F32)
    disk /= disk.sum()
    taps = gaussian_taps(3, float(alias_blur)).astype(F32)
    p = np.pad(disk, ((1, 1), (0, 0)), mode="reflect")
    disk = taps[0] * p[:-2] + taps[1] * p[1:-1] + taps[2] * p[2:]
    p = np.pad(disk, ((0, 0), (1, 1)), mode="reflect")
    out = (taps[0] * p[:, :-2] + taps[1] * p[:, 1:-1] + taps[2] * p[:, 2:]).astype(F32)
    out.flags.writeable = False
    return out


def elastic_points(h: int, w: int) -> np.ndarray:
    """Hendrycks' anchor triangle: the centre +- square_size (min(h, w)//3), f32 [3, 2]."""
    cx, cy = np.float32(w // 2), np.float32(h // 2)
    s = np.float32(min(h, w) // 3)
    return np.asarray([[cx + s, cy + s], [cx + s, cy - s], [cx - s, cy - s]], np.float32)


def affine_from_points(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The 2x3 affines [N, 2, 3] that map each image's three ``src``
    points [N, 3, 2] onto its ``dst`` points (cv2.getAffineTransform's
    semantics): the oracle's f64 6x6 solve, one an image."""
    n = src.shape[0]
    a = np.zeros((n, 6, 6))
    b = np.zeros((n, 6))
    for i in range(3):
        a[:, 2 * i, 0:2] = src[:, i]
        a[:, 2 * i, 2] = 1.0
        a[:, 2 * i + 1, 3:5] = src[:, i]
        a[:, 2 * i + 1, 5] = 1.0
        b[:, 2 * i] = dst[:, i, 0]
        b[:, 2 * i + 1] = dst[:, i, 1]
    return np.linalg.solve(a, b[..., None])[..., 0].reshape(n, 2, 3)
