"""Batch transforms: ``apply_all_transformations`` (PyTorch).

Counterpart of ``imagetransformations_tpu/pipeline/batch.py``. The reference
loops images x 8 transform types in Python, drawing a grid value per
(image, type) (transformation.py:92-170); here each type draws one ``[N]``
value vector from its grid and runs over the whole batch at once.

With the default flags two types run hand-written CUDA kernels on the
card: rotation (``fused_blur_rotate_batched``, strict, radius 0: the rgb
blur-rotate kernel with per-image shifts) and shear
(``shear_bicubic_batched``). The other six are plain PyTorch, as they are
XLA code in the JAX package.
"""

from __future__ import annotations

from typing import Callable

import torch

from imagetransformations_tpu_torch.core.grids import PARAM_GRIDS, sample_params
from imagetransformations_tpu_torch.core.image import entry_device, to_device
from imagetransformations_tpu_torch.ops import elementwise as ew
from imagetransformations_tpu_torch.ops import noise as nz
from imagetransformations_tpu_torch.ops import stencil as st
from imagetransformations_tpu_torch.ops import warp as wp
from imagetransformations_tpu_torch.ops.hopper.megakernel import fused_blur_rotate_batched
from imagetransformations_tpu_torch.ops.hopper.resample import shear_bicubic_batched

TYPES = ("scale", "rotation", "lighten_darken", "gaussian_noise", "translation", "contrast",
         "blur", "shear")


def _grid(name: str) -> tuple[float, ...]:
    return tuple(float(v) for v in PARAM_GRIDS[name].values())


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


_FAST_SCALE_SHEAR = ("pil_parity_scale_shear=False runs the row-shift shear and the "
                     "bilinear zoom kernels, not ported yet (ROADMAP B.9, B.10)")
_PIL_ROTATION = ("pil_parity_rotation=True runs the PIL NEAREST rotation kernel, not "
                 "ported yet (ROADMAP B.12)")


def _shear_fast(x, values, generator):
    """The JAX package's non-parity shear (row-shift kernel #9): not ported yet."""
    raise NotImplementedError(_FAST_SCALE_SHEAR)


#: transform type -> batched (images, values[N], generator) -> images
_BATCHED_OPS: dict[str, Callable] = {
    "lighten_darken": lambda x, v, g: ew.apply_brightness(x, v),
    "contrast": lambda x, v, g: ew.apply_contrast(x, v),
    "blur": lambda x, v, g: st.apply_blur(x, v),
    "gaussian_noise": lambda x, v, g: nz.apply_gaussian_noise(x, v, generator=g),
    "rotation": _rotation_by_unique_angle,
    "translation": _translation_fast,
    "shear": _shear_fast,
}


def _apply_per_value(images: torch.Tensor, t: str, values: torch.Tensor) -> torch.Tensor:
    """Exact PIL semantics for the canvas-changing ops, one value an image:
    BICUBIC shear on the widened canvas cropped to w (kernel #11), LANCZOS
    scale by fixed-point matrices."""
    grid = _grid({"scale": "scale", "shear": "shear", "rotation_pil": "rotation"}[t])
    if t == "shear" and min(grid) >= 0.0:
        return shear_bicubic_batched(images, values, max_shear=max(grid) + 0.05)
    if t == "scale":
        return wp.apply_scale_batched(images, values, grid)
    if t == "rotation_pil":
        raise NotImplementedError(_PIL_ROTATION)
    return _value_sweep_per_value(images, values, t, grid)


def _value_sweep_per_value(images, values, t: str, grid: tuple):
    """The JAX package's sweep over every grid value (for grids the batched
    kernels do not take): not ported yet."""
    raise NotImplementedError(
        f"the per-grid-value sweep of {t!r} runs the affine warp, not ported yet (ROADMAP A.6)"
    )


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

    ``fused`` is accepted for the JAX signature; both values run the same
    code here (the JAX package requires the two to agree). The non-default
    flags raise NotImplementedError naming the ROADMAP items that port them.
    """
    del fused  # one dispatch mode on the GPU: both values run this code
    if not pil_parity_scale_shear:
        raise NotImplementedError(_FAST_SCALE_SHEAR)
    if pil_parity_rotation:
        raise NotImplementedError(_PIL_ROTATION)
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
    for t in types:
        values = sample_params(generator, t, n)
        if t in ("shear", "scale"):
            results = _apply_per_value(x, t, values)
        elif t in _BATCHED_OPS:
            results = _BATCHED_OPS[t](x, values, generator)
        else:
            continue
        out[t] = (values, results)
    return out
