"""The transforms the augmentation cells time, in plain PyTorch: the
reference's 8-type sweep (transformation.py:92-170) at the port's default
flags, and the blur -> rotation -> grayscale chain in its streaming form.

Frozen copies of the port's plain versions (``pipeline/batch.py``,
``core/grids.py``, ``ops/elementwise.py``, ``ops/noise.py``,
``ops/stencil.py``, ``ops/hopper/resample.py``, ``ops/hopper/megakernel.py``,
``ops/hopper/shear.py``), which equal the CUDA kernels byte for byte. Each
float computation takes ``dtype``: ``torch.float32`` is the reference,
``torch.bfloat16`` the control (the precision one step below the f32 that
the transforms state), which the comparison has to reject. Integer and f64
paths (cv2's 8U blur, PIL's fixed-point LANCZOS) stay as they are.

``sweep_draws`` replays the draws ``apply_all_transformations`` makes from
its generator, in its order: per type one ``randint`` of a grid index an
image, and for ``gaussian_noise`` then one standard normal a value."""

from __future__ import annotations

import math

import numpy as np
import torch

from .image import cv2_gaussian_ksize, gaussian_taps, to_uint8_rint, to_uint8_trunc
from .resize import apply_scale_batched

F32 = torch.float32

#: the reference's transform-value grids {lo, hi, step} (transformation.py:95-105)
GRIDS = {
    "scale": (0.9, 1.4, 0.1),
    "rotation": (-22.5, 22.5, 2.5),
    "lighten_darken": (-0.05, 0.05, 0.01),
    "gaussian_noise": (0.0, 0.1, 0.01),
    "translation": (-50.0, 50.0, 5.0),
    "contrast": (0.0, 1.0, 0.1),
    "blur": (0.0, 5.0, 0.5),
    "shear": (0.0, 1.0, 0.1),
}
#: the order ``apply_all_transformations`` runs (and draws) the types in
TYPES = ("scale", "rotation", "lighten_darken", "gaussian_noise", "translation", "contrast",
         "blur", "shear")
LUMA_WEIGHTS = (19595, 38470, 7471)  # PIL L24 weights of R, G, B
MAX_BLUR_KSIZE = 31


def grid_f64(name: str) -> np.ndarray:
    lo, hi, step = GRIDS[name]
    n = int(round((hi - lo) / step)) + 1
    return np.round(lo + step * np.arange(n), 10)


def grid_f32(name: str) -> np.ndarray:
    return grid_f64(name).astype(np.float32)


def sweep_draws(generator: torch.Generator, shape: tuple) -> dict:
    """One call's draws: {type: (index [n] int64, value [n] f32)} and
    ``"noise"``, the standard normals of ``gaussian_noise``, drawn in the
    order and shapes the port's ``apply_all_transformations`` draws them."""
    dev = generator.device
    out = {}
    for t in TYPES:
        vals = torch.from_numpy(grid_f32(t)).to(dev)
        idx = torch.randint(0, vals.shape[0], (shape[0],), generator=generator, device=dev)
        out[t] = (idx, vals[idx])
        if t == "gaussian_noise":
            out["noise"] = torch.randn(shape, generator=generator, device=dev, dtype=F32)
    return out


# ------------------------------------------------------------- photometric


def brightness(x: torch.Tensor, factor: torch.Tensor, dtype=F32) -> torch.Tensor:
    """PIL ImageEnhance.Brightness(1 + factor), C-cast truncation."""
    f = (1.0 + factor.to(F32)).to(dtype).reshape(-1, 1, 1, 1)
    return to_uint8_trunc((x.to(dtype) * f).to(F32))


def contrast(x: torch.Tensor, alpha: torch.Tensor, dtype=F32) -> torch.Tensor:
    """cv2.convertScaleAbs(img, alpha): clip(rint(px * alpha))."""
    return to_uint8_rint((x.to(dtype) * alpha.to(dtype).reshape(-1, 1, 1, 1)).to(F32))


def gaussian_noise(x: torch.Tensor, std: torch.Tensor, noise: torch.Tensor,
                   dtype=F32) -> torch.Tensor:
    """px + N(0, std*255), C-cast truncation (transformation.py:272-281)."""
    scale = (std.reshape(-1, 1, 1, 1) * 255.0).to(dtype)
    return to_uint8_trunc((x.to(dtype) + noise.to(dtype) * scale).to(F32))


# ------------------------------------------------------------- geometry


def translate(x: torch.Tensor, values: torch.Tensor, bound: int) -> torch.Tensor:
    """Per-image integer translation on a black canvas, the shift truncated
    toward zero (``int(tx)``) and clipped to +-bound."""
    n, h, w, _ = x.shape
    t = torch.clamp(torch.trunc(values.to(F32)).to(torch.int64), -bound, bound)
    pad = torch.nn.functional.pad(x, (0, 0, bound, bound, bound, bound))
    start = (bound - t).reshape(n, 1)
    rows = (start + torch.arange(h, device=x.device)).reshape(n, h, 1)
    cols = (start + torch.arange(w, device=x.device)).reshape(n, 1, w)
    return pad[torch.arange(n, device=x.device).reshape(n, 1, 1), rows, cols]


def shear_bicubic(x: torch.Tensor, factors: torch.Tensor, shifts: torch.Tensor,
                  dtype=F32) -> torch.Tensor:
    """PIL AFFINE BICUBIC shear on the widened canvas (white fill), cropped
    to the input width; ``shifts`` each image's ``ceil(v*h)``."""
    n, h, w, c = x.shape
    s = factors.to(F32).reshape(n, 1, 1)
    m2 = -shifts.to(F32).reshape(n, 1, 1)
    xo = torch.arange(w, dtype=F32, device=x.device).view(1, 1, w) + 0.5
    yo = torch.arange(h, dtype=F32, device=x.device).view(1, h, 1) + 0.5
    xx = (xo + s * yo) + m2
    xin = xx - 0.5
    fl = torch.floor(xin)
    x0 = fl.to(torch.int64)
    fx = (xin - fl)[..., None].to(dtype)
    v = x.to(dtype)

    def tap(j: int) -> torch.Tensor:
        idx = (x0 + j).clamp(0, w - 1)[..., None].expand(n, h, w, c)
        return torch.gather(v, 2, idx)

    cm1, c0, c1, c2 = tap(-1), tap(0), tap(1), tap(2)
    p2 = -cm1 + c1
    p3 = ((2.0 * (cm1 - c0)) + c1) - c2
    p4 = ((-cm1 + c0) - c1) + c2
    out = (c0 + fx * (p2 + fx * (p3 + fx * p4))).to(F32)
    out = torch.where(out <= 0, 0.0, torch.where(out >= 255, 255.0, torch.trunc(out)))
    valid = ((xx >= 0) & (xx < w))[..., None]
    return torch.where(valid, out, 255.0).to(torch.uint8)


def _reflect101(i: torch.Tensor, n: int) -> torch.Tensor:
    i = i.abs()
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def _blur_along(v: torch.Tensor, taps: torch.Tensor, p: int, dim: int) -> torch.Tensor:
    """cv2 Gaussian pass along ``dim``, reflect-101 borders: centre tap
    first, then the mirrored pairs as acc + taps[t] * (lo + hi)."""
    size = v.shape[dim]
    idx = _reflect101(torch.arange(-p, size + p, device=v.device), size)
    vp = v.index_select(dim, idx)

    def at(t: int) -> torch.Tensor:
        return vp.narrow(dim, t, size)

    acc = taps[p] * at(p)
    for t in range(p):
        acc = acc + taps[t] * (at(t) + at(2 * p - t))
    return acc


def _take(v: torch.Tensor, idx: torch.Tensor, dim: int, fill: float) -> torch.Tensor:
    size = v.shape[dim]
    got = torch.gather(v, dim, idx.clamp(0, size - 1).expand(v.shape))
    return torch.where((idx >= 0) & (idx < size), got, torch.tensor(fill, dtype=v.dtype,
                                                                      device=v.device))


def _trunc_u8(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.trunc(v), 0.0, 255.0)


def _shear_x(v, k1, f1, fill: float, strict: bool):
    """x shifted by row (shears 1 and 3) of planes v [n, C, h, w]; k1/f1
    [h] or [n, h]; v + f * (nbr - v) as three separately rounded ops."""
    h, w = v.shape[-2:]
    k1, f1 = k1.reshape(-1, 1, h, 1), f1.to(v.dtype).reshape(-1, 1, h, 1)
    xs = torch.arange(w, device=v.device).view(1, 1, 1, w) + k1
    a, b = _take(v, xs, 3, fill), _take(v, xs + 1, 3, fill)
    out = a + f1 * (b - a)
    return _trunc_u8(out) if strict else out


def _shear_y(v, k2, f2, fill: float, strict: bool):
    """y shifted by column (shear 2); k2/f2 [w] or [n, w]."""
    h, w = v.shape[-2:]
    k2, f2 = k2.reshape(-1, 1, 1, w), f2.to(v.dtype).reshape(-1, 1, 1, w)
    ys = torch.arange(h, device=v.device).view(1, 1, h, 1) + k2
    a, b = _take(v, ys, 2, fill), _take(v, ys + 1, 2, fill)
    out = a + f2 * (b - a)
    return _trunc_u8(out) if strict else out


def _shears(v, k1, f1, k2, f2, fill: float, strict: bool):
    v = _shear_x(v, k1, f1, fill, strict)
    v = _shear_y(v, k2, f2, fill, strict)
    return _shear_x(v, k1, f1, fill, strict)


def traced_shifts(angles: torch.Tensor, h: int, w: int, max_angle_deg: float):
    """(k1 [n, h], f1, k2 [n, w], f2, identity [n]) of one angle an image,
    in f32 in the op order of the JAX package's traced kernels: clip, t =
    deg2rad(-angle), a = -tan(t/2), b = sin(t) (correctly rounded), shifts
    a*ys and b*xs, k = floor, f = s - k; identity where t == 0."""
    dev = angles.device
    ang = torch.clamp(angles.to(F32), -max_angle_deg, max_angle_deg)
    t = torch.deg2rad(-ang).reshape(-1)
    a = -torch.tan((t / 2.0).to(torch.float64)).to(F32)
    b = torch.sin(t.to(torch.float64)).to(F32)
    ys = torch.arange(h, dtype=F32, device=dev) + 0.5 - h / 2.0
    xs = torch.arange(w, dtype=F32, device=dev) + 0.5 - w / 2.0
    sx = a[:, None] * ys[None, :]
    sy = b[:, None] * xs[None, :]
    k1, k2 = torch.floor(sx), torch.floor(sy)
    return k1.to(torch.int32), sx - k1, k2.to(torch.int32), sy - k2, t == 0.0


def rotate_strict(x: torch.Tensor, angles: torch.Tensor, max_angle_deg: float,
                  dtype=F32) -> torch.Tensor:
    """The sweep's rotation: the 3-shear rotation with the reference's u8
    truncation after each pass, one angle an image, black fill; an image
    at angle 0 comes back as it is."""
    _, h, w, _ = x.shape
    k1, f1, k2, f2, ident = traced_shifts(angles, h, w, max_angle_deg)
    v = x.permute(0, 3, 1, 2).to(dtype)
    rot = _shears(v, k1, f1, k2, f2, 0.0, strict=True).to(F32)
    q = torch.where(ident.reshape(-1, 1, 1, 1), to_uint8_rint(v.to(F32)), to_uint8_trunc(rot))
    return q.permute(0, 2, 3, 1).contiguous()


# ------------------------------------------------------------- cv2's 8U blur


def _taps_q8(ksize: int, sigma: float) -> list[int]:
    """cv2's 8U Gaussian row (getGaussianKernelBitExact, then 8 fraction
    bits by error diffusion from the outer taps inward)."""
    half = (ksize - 1) // 2
    scale = -0.125 / (sigma * sigma)
    vals = [math.exp(float(x * x) * scale) for x in range(1 - ksize, 0, 2)]
    total = 0.0
    for v in vals:
        total += v
    mul = 1.0 / (2.0 * total + 1.0)
    out, err = [0] * ksize, 0.0
    for i, v in enumerate(vals):
        adj = v * mul * 256.0 + err
        q = round(adj)
        err = adj - q
        out[i] = out[ksize - 1 - i] = q
    out[half] = 256 - 2 * sum(out[:half])
    return out


def cv2_taps_q8(radius: float) -> np.ndarray:
    if radius == 0:
        return np.asarray([256], np.int32)
    return np.asarray(_taps_q8(cv2_gaussian_ksize(float(radius)), float(radius)), np.int32)


def blur_tap_table(radii) -> np.ndarray:
    """Each radius's 8U row centred in a zero-padded int32 row."""
    taps = [cv2_taps_q8(float(v)) for v in radii]
    width = max([MAX_BLUR_KSIZE] + [t.size for t in taps])
    rows = np.zeros((len(taps), width), np.int32)
    for i, t in enumerate(taps):
        p = (width - t.size) // 2
        rows[i, p: p + t.size] = t
    return rows


def _reflect_indices(size: int, p: int, device) -> torch.Tensor:
    i = torch.arange(-p, size + p, device=device)
    period = 2 * (size - 1)
    i = i.remainder(period)
    return torch.where(i >= size, period - i, i)


def _conv1d(x: torch.Tensor, taps: torch.Tensor, dim: int) -> torch.Tensor:
    """Integer pass along H (1) or W (2) of NHWC, reflect borders, one tap
    row an image [N, K]."""
    k = taps.shape[-1]
    p = k // 2
    size = x.shape[dim]
    xp = x.index_select(dim, _reflect_indices(size, p, x.device))
    acc = None
    for t in range(k):
        term = xp.narrow(dim, t, size) * taps[:, t].reshape(-1, 1, 1, 1)
        acc = term if acc is None else acc + term
    return acc


def blur_8u(x: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """cv2.GaussianBlur on u8 with int32 rows [N, K] of 8 fraction bits:
    integer sums along H then W, then (sum + 2^15) >> 16."""
    acc = _conv1d(_conv1d(x.to(torch.int32), taps, 1), taps, 2)
    return ((acc + 32768) >> 16).to(torch.uint8)


# ------------------------------------------------------------- the entries


def apply_all(x: torch.Tensor, draws: dict, dtype=F32) -> dict:
    """{type: transformed [N, H, W, C] u8} of one call of the sweep at the
    port's default flags (LANCZOS scale, 3-shear rotation with per-pass
    truncation, PIL's BICUBIC shear on the widened canvas), from the draws
    of ``sweep_draws``."""
    h = x.shape[1]
    out = {}
    v = {t: draws[t][1] for t in TYPES}
    idx = {t: draws[t][0] for t in TYPES}
    out["scale"] = apply_scale_batched(x, v["scale"], tuple(float(g) for g in grid_f32("scale")))
    out["rotation"] = rotate_strict(x, v["rotation"],
                                    float(np.abs(grid_f32("rotation")).max()) + 0.5, dtype)
    out["lighten_darken"] = brightness(x, v["lighten_darken"], dtype)
    out["gaussian_noise"] = gaussian_noise(x, v["gaussian_noise"], draws["noise"], dtype)
    out["translation"] = translate(x, v["translation"],
                                   int(np.abs(grid_f32("translation")).max()))
    out["contrast"] = contrast(x, v["contrast"], dtype)
    table = torch.from_numpy(blur_tap_table(grid_f64("blur"))).to(x.device)
    out["blur"] = blur_8u(x, table[idx["blur"]])
    shifts = torch.tensor([math.ceil(g * h) if g > 0 else 0 for g in grid_f64("shear")],
                          dtype=torch.int32, device=x.device)
    out["shear"] = shear_bicubic(x, v["shear"], shifts[idx["shear"]], dtype)
    return out


def paeth_shifts(h: int, w: int, angle_deg: float):
    """(k1 [h], f1, k2 [w], f2) of a static angle: shifts in host f64,
    rounded to f32, k = floor, f = s - floor(s) in f32, k held to the
    canvas +- 1."""
    t = math.radians(-angle_deg)
    a, b = -math.tan(t / 2.0), math.sin(t)
    sx = (a * (np.arange(h, dtype=np.float64) + 0.5 - h / 2.0)).astype(np.float32)
    sy = (b * (np.arange(w, dtype=np.float64) + 0.5 - w / 2.0)).astype(np.float32)
    return (np.clip(np.floor(sx), -(w + 1), w + 1).astype(np.int32),
            (sx - np.floor(sx)).astype(np.float32),
            np.clip(np.floor(sy), -(h + 1), h + 1).astype(np.int32),
            (sy - np.floor(sy)).astype(np.float32))


def blur_rotate_gray(x: torch.Tensor, radius: float, angle_deg: float,
                     dtype=F32) -> torch.Tensor:
    """The chain blur(radius) -> rotation(angle) -> grayscale in its
    streaming form: exact integer L24 luma, the f32 cv2 blur along X then
    Y (reflect-101), three shears with black fill, floor(v + 0.5),
    replicated to 3 channels."""
    dev = x.device
    k = cv2_gaussian_ksize(float(radius))
    taps = torch.from_numpy(gaussian_taps(k, float(radius)).astype(np.float32)).to(dev, dtype)
    p = (k - 1) // 2
    _, h, w, _ = x.shape
    k1, f1, k2, f2 = (torch.from_numpy(a).to(dev) for a in paeth_shifts(h, w, angle_deg))
    xi = x.to(torch.int32)
    wr, wg, wb = LUMA_WEIGHTS
    lum = (xi[..., 1] * wg + xi[..., 0] * wr) + xi[..., 2] * wb  # < 2^24: exact in f32
    v = (lum.to(F32) * (1.0 / 65536.0)).to(dtype)[:, None]
    v = _blur_along(_blur_along(v, taps, p, 3), taps, p, 2)
    v = _shears(v, k1, f1, k2, f2, 0.0, strict=False)
    q = (v[:, 0].to(F32) + 0.5).to(torch.int32).clamp(0, 255).to(torch.uint8)
    return q[..., None].expand(*q.shape, 3).contiguous()
