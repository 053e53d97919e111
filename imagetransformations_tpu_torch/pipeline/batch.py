"""Batch transforms: ``apply_all_transformations`` (PyTorch).

Counterpart of ``imagetransformations_tpu/pipeline/batch.py``. The reference
loops images x 8 transform types in Python, drawing a grid value per
(image, type) (transformation.py:92-170); here each type draws one ``[N]``
value vector from its grid and runs over the whole batch at once.

Four types run hand-written CUDA kernels on the card, by flag:

- rotation: ``fused_blur_rotate_batched`` (strict, radius 0: the rgb
  blur-rotate kernel with per-image shifts); with
  ``pil_parity_rotation=True`` Pillow's fixed-point NEAREST rotation
  (``pil_rotate_nearest``), each image's coefficient row gathered by its
  drawn grid index from a table kept on the device.
- shear: the PIL BICUBIC shear (``shear_bicubic_batched``), each image's
  canvas shift ``ceil(v*h)`` gathered by its drawn grid index from a table
  made on the host in f64 (PIL's rule); with
  ``pil_parity_scale_shear=False`` the row-shift shear
  (``shear_rows_logrouted``), which keeps the JAX package's f32 shift.
- blur: cv2's 8U blur (``blur_separable_batched``), each image's integer
  tap row gathered by its drawn grid index from a table made on the host.
- scale: with ``pil_parity_scale_shear=False`` the bilinear zoom
  (``zoom_bilinear_batched``); by default the exact LANCZOS scale, f64
  matrix products in plain PyTorch.

The other four are plain PyTorch, as they are XLA code in the JAX package.
The rotation type reads its largest drawn angle back from the card once a
call (``fused_blur_rotate_batched``'s budget check), which waits for every
launch queued before it; no other type at the default flags reads anything
back, but each type's draw (``sample_indices``) and the LANCZOS scale copy
a small host table to the card, and such a copy from pageable memory waits
for the queue too. Each call is span ``apply_all.call`` and each type, its
draw included, span ``apply_all.<type>`` (``utils.profiling``: recorded
only while a profiler runs).
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import numpy as np
import torch

from imagetransformations_tpu_torch.core.grids import PARAM_GRIDS, sample_indices
from imagetransformations_tpu_torch.core.image import entry_device, to_device
from imagetransformations_tpu_torch.ops import elementwise as ew
from imagetransformations_tpu_torch.ops import noise as nz
from imagetransformations_tpu_torch.ops import stencil as st
from imagetransformations_tpu_torch.ops import warp as wp
from imagetransformations_tpu_torch.ops.hopper.blur import blur_separable_batched
from imagetransformations_tpu_torch.ops.hopper.megakernel import fused_blur_rotate_batched
from imagetransformations_tpu_torch.ops.hopper.resample import (
    shear_bicubic_batched,
    shear_shift_table,
    zoom_bilinear_batched,
)
from imagetransformations_tpu_torch.ops.hopper import rotate_gather as rg
from imagetransformations_tpu_torch.ops.hopper.shear import shear_rows_logrouted
from imagetransformations_tpu_torch.utils import profiling

TYPES = ("scale", "rotation", "lighten_darken", "gaussian_noise", "translation", "contrast",
         "blur", "shear")

#: the span of each type in ``apply_all_transformations``
_TYPE_SPANS = {t: "apply_all." + t for t in PARAM_GRIDS}


def _grid(name: str) -> tuple[float, ...]:
    return tuple(float(v) for v in PARAM_GRIDS[name].values())


def _grid_f64(name: str) -> tuple[float, ...]:
    """The grid's values as the reference's Python floats (before the f32
    cast of ``ParamGrid.values``)."""
    return tuple(float(v) for v in PARAM_GRIDS[name].values_f64())


def _rotation_by_unique_angle(x, values, generator):
    """Per-image grid angles: 3-shear rotation with the reference's per-pass
    u8 quantization (stream=False), radius 0."""
    return fused_blur_rotate_batched(x, 0.0, values, stream=False,
                                     max_angle_deg=max(abs(v) for v in _grid("rotation")) + 0.5)


def _translate_dynamic(x: torch.Tensor, values, bound: int) -> torch.Tensor:
    """Per-image integer translation on a black canvas: the shift truncates
    toward zero like the reference's ``int(tx)`` (transformation.py:284-307)
    and is clipped to +-bound; pad by ``bound``, then each image's window."""
    n, h, w, c = x.shape
    t = torch.clamp(torch.trunc(torch.as_tensor(values, dtype=torch.float32, device=x.device))
                    .to(torch.int64), -bound, bound)
    pad = torch.nn.functional.pad(x, (0, 0, bound, bound, bound, bound))
    start = (bound - t).reshape(n, 1)
    rows = (start + torch.arange(h, device=x.device)).reshape(n, h, 1)
    cols = (start + torch.arange(w, device=x.device)).reshape(n, 1, w)
    return pad[torch.arange(n, device=x.device).reshape(n, 1, 1), rows, cols]


def _translation_fast(x, values, generator):
    return _translate_dynamic(x, values, int(max(abs(v) for v in _grid("translation"))))


def fast_shear_shifts(values, h: int, device: torch.device) -> torch.Tensor:
    """Row shifts [n, h] f32 of the fast shear, on ``device``: row y of an
    image with factor v moves by ``v*(y + 0.5) - ceil(v*h)`` (v > 0; 0
    otherwise), the reference's widened-canvas crop (JAX pipeline/batch.py
    ``_shear_fast_batched``)."""
    v = torch.as_tensor(values, dtype=torch.float32, device=device).reshape(-1, 1)
    y = (torch.arange(h, dtype=torch.float32, device=device) + 0.5).reshape(1, h)
    return v * y - torch.where(v > 0, torch.ceil(v * float(h)), 0.0)


def fast_shear_budget(max_shear: float, h: int) -> int:
    """The row-shift kernel's ``max_shift_px`` for factors up to
    ``max_shear``: ``ceil(max_shear*h) + 2``, in host float64."""
    return int(math.ceil(max_shear * h)) + 2


def _shear_fast_batched(x, values, max_shear: float):
    """Fast shear: one row-shift kernel call (bilinear, white fill),
    cropped to the input canvas."""
    shifts = fast_shear_shifts(values, x.shape[1], x.device)
    return shear_rows_logrouted(x, shifts, fill=255,
                                max_shift_px=fast_shear_budget(max_shear, x.shape[1]))


def _shear_fast(x, values, generator):
    return _shear_fast_batched(x, values, max(abs(v) for v in _grid("shear")))


def _zoom_fast(x, values):
    """random_zoom semantics through the bilinear zoom kernel, with the
    scale grid's bounds -+ 0.05 as the budget."""
    grid = _grid("scale")
    return zoom_bilinear_batched(x, values, min_factor=min(grid) - 0.05,
                                 max_factor=max(grid) + 0.05)


#: transform type -> batched (images, values[N], generator) -> images
_BATCHED_OPS: dict[str, Callable] = {
    "lighten_darken": lambda x, v, g: ew.apply_brightness(x, v),
    "contrast": lambda x, v, g: ew.apply_contrast(x, v),
    "gaussian_noise": lambda x, v, g: nz.apply_gaussian_noise(x, v, generator=g),
    "rotation": _rotation_by_unique_angle,
    "translation": _translation_fast,
    # without PIL parity: the bilinear zoom and the row-shift shear kernels
    "scale": lambda x, v, g: _zoom_fast(x, v),
    "shear": _shear_fast,
}


def _apply_per_value(images: torch.Tensor, t: str, values: torch.Tensor) -> torch.Tensor:
    """Exact PIL semantics for the canvas-changing ops, one value an image:
    LANCZOS scale by fixed-point matrices, Pillow's NEAREST rotation
    (kernel #12, Pillow's fixed point, exact for any values: their
    coefficients come from the host). The sweep's shear takes its drawn
    indices to ``_shear_pil``, its PIL rotation to ``_rotation_pil``."""
    if t == "scale":
        return wp.apply_scale_batched(images, values, _grid("scale"))
    if t == "rotation_pil":
        return rg.pil_rotate_nearest_batched(images, values)
    raise ValueError(f"no per-value route for {t!r}")


def _shear_pil(images: torch.Tensor, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """PIL's BICUBIC shear of each image by its drawn grid index ``i``
    (``sample_indices``), its canvas shift gathered on the device from the
    grid's f64 table (the grid is 0..1: the kernel's range)."""
    shifts = shear_shift_table(_grid_f64("shear"), images.shape[1], images.device)
    return shear_bicubic_batched(images, values, max_shear=max(_grid("shear")) + 0.05,
                                 shifts=shifts[idx.to(images.device)])


@functools.lru_cache(maxsize=16)
def _blur_table(grid: tuple, device: torch.device) -> torch.Tensor:
    """``stencil.blur_tap_rows`` of each grid radius, in grid order (int32
    [len(grid), MAX_BLUR_KSIZE]) on ``device``, made on the host once a
    (grid, device)."""
    return st.blur_tap_rows(grid, device)


def _blur_grid(images: torch.Tensor, idx: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """cv2's blur of each image at its drawn grid radius: the integer tap
    rows gathered on the device from the grid's table, so nothing is read
    back to the host."""
    table = _blur_table(_grid_f64("blur"), images.device)
    return blur_separable_batched(images, values, taps=table[idx.to(images.device)])


@functools.lru_cache(maxsize=16)
def _rotation_table(grid: tuple, w: int, h: int, device: torch.device):
    """Pillow's coefficients of each grid angle, in grid order (int32
    [k, 6]) on ``device``, computed on the host once a (grid, w, h); None
    where a grid angle takes Pillow's float path (sides near 32768)."""
    co = rg.pil_rotate_coeffs(np.asarray(grid, np.float32), w, h)
    return None if co.flagged.any() else torch.from_numpy(co.fixed).to(device)


def _rotation_pil(images: torch.Tensor, idx: torch.Tensor, grid: tuple) -> torch.Tensor:
    """Pillow's rotate(-grid[i], NEAREST) of each image by its drawn grid
    index ``i`` (``sample_indices``): each image's coefficient row is
    gathered on the device, so no call waits for the host."""
    n, h, w, _ = images.shape
    table = _rotation_table(tuple(grid), w, h, images.device)
    if table is None:
        host_idx = profiling.host_read(idx, "rotation_pil.indices")
        values = torch.tensor(grid, dtype=torch.float32)[host_idx]
        return rg.pil_rotate_nearest_batched(images, values)
    return rg.pil_rotate_nearest(images.contiguous(), table[idx.to(images.device)], 0)


def transform_batch(images, chain, generator: torch.Generator | None = None,
                    **kw) -> torch.Tensor:
    """Apply a declarative op-chain to an NHWC batch: ``build_chain_fn(chain,
    **kw)(images, generator)`` (``device`` among ``kw``; None means
    "cuda")."""
    from imagetransformations_tpu_torch.pipeline.chain import build_chain_fn

    return build_chain_fn(chain, **kw)(images, generator)


def apply_all_transformations(
    images,
    generator: torch.Generator | int,
    types: tuple[str, ...] = TYPES,
    pil_parity_scale_shear: bool = True,
    pil_parity_rotation: bool = False,
    fused: bool = True,
    device: str | torch.device | None = None,
) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
    """PyTorch equivalent of transformation.py:92-170.

    For each transform type, draw one grid value an image and apply the
    type to the whole NHWC uint8 batch. Returns
    ``{type: (values[N], transformed[N, H, W, C])}`` on ``device``
    (None means "cuda", and raises without a GPU; "cpu" runs the plain
    versions). ``images`` is a numpy array or a tensor; ``generator`` a
    ``torch.Generator`` on that device, or an int seed for one. The draws
    differ from the JAX package's for any seed.

    ``pil_parity_scale_shear``: True takes PIL's canvas semantics (LANCZOS
    scale, BICUBIC shear on the widened canvas); False the bilinear zoom
    and the row-shift shear. ``pil_parity_rotation``: True takes PIL
    NEAREST rotation, False the 3-shear rotation with per-pass u8 trunc.
    Every flag combination returns all 8 types. ``fused`` is accepted for
    the JAX signature; both values run the same code here (the JAX package
    requires the two to agree).
    """
    del fused  # one dispatch mode on the GPU: both values run this code
    dev = entry_device(device, "apply_all_transformations")
    x = to_device(images, dev)
    if x.ndim != 4 or x.dtype != torch.uint8:
        raise ValueError("expected an NHWC uint8 batch")
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, images on {dev}")
    n = x.shape[0]
    out: dict[str, tuple[torch.Tensor, torch.Tensor]] = {}
    with profiling.span("apply_all.call"):
        for t in types:
            with profiling.span(_TYPE_SPANS[t]):
                idx, values = sample_indices(generator, t, n)
                if t == "rotation" and pil_parity_rotation:
                    results = _rotation_pil(x, idx, _grid(t))
                elif t == "shear" and pil_parity_scale_shear:
                    results = _shear_pil(x, idx, values)
                elif t == "blur":
                    results = _blur_grid(x, idx, values)
                elif t == "scale" and pil_parity_scale_shear:
                    results = _apply_per_value(x, t, values)
                else:
                    results = _BATCHED_OPS[t](x, values, generator)
            out[t] = (values, results)
    return out
