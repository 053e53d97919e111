"""Composite ops (PyTorch): background change by edge-mask compositing,
random crop and the 3-D-transform aliases.

Counterpart of ``imagetransformations_tpu/ops/composite.py`` (XLA in the
JAX package, no Pallas kernel):

- ``apply_background_change`` (transformation.py:328-346): grayscale ->
  scipy's u8 Sobel (modulo 256) -> mask above each image's 70th percentile
  (``torch.quantile``, linear, as ``jnp.quantile``) -> binary dilation x3
  (3x3 max) -> the original over a solid background colour.
- ``apply_background_change_simple`` (transformation.py:349-354): a 70/30
  blend with the background, PIL ``Image.blend``'s truncation.
- ``random_crop`` (fall_2025/transformations_code:43-49): reflect pad, then
  one crop offset for the whole batch, as the JAX op's ``dynamic_slice``.
- ``apply_camera_distance``, ``apply_xy_translation_3d`` and
  ``apply_rotation_3d`` (transformation.py:309-325): ``apply_scale``,
  ``apply_translation`` and ``apply_rotation`` with the reference's
  arguments. ``apply_rotation_3d`` on a u8 batch runs Pillow's NEAREST
  rotation, on the card the hand-written kernel ``rotate_nearest.cu``.
"""

from __future__ import annotations

import torch

from imagetransformations_tpu_torch.core.image import as_batch, as_float, restore_layout
from imagetransformations_tpu_torch.ops.elementwise import grayscale
from imagetransformations_tpu_torch.ops.stencil import _reflect_indices, sobel_edges
from imagetransformations_tpu_torch.ops.warp import apply_rotation, apply_scale, apply_translation

F32 = torch.float32


def _dilate3x3(mask: torch.Tensor, iterations: int = 3) -> torch.Tensor:
    """Binary dilation of an [N, H, W] mask with a 3x3 structuring element
    (scipy's default), ``iterations`` times; zero outside the image."""
    m = mask.to(F32)
    h, w = m.shape[1], m.shape[2]
    for _ in range(iterations):
        mp = torch.nn.functional.pad(m, (1, 1, 1, 1))
        out = mp[:, 0:h, 0:w]
        for dy in range(3):
            for dx in range(3):
                out = torch.maximum(out, mp[:, dy : dy + h, dx : dx + w])
        m = out
    return m > 0.5


def _background(bg_color, device) -> torch.Tensor:
    """The background colour in [0, 1] (the reference passes floats) as
    trunc(c * 255) in f32."""
    return torch.trunc(torch.as_tensor(bg_color, dtype=F32, device=device) * 255.0)


def apply_background_change(img: torch.Tensor, bg_color) -> torch.Tensor:
    """Replace the background with a solid colour, keeping edge-dense
    regions. ``bg_color``: [3] in [0, 1]."""
    x, single = as_batch(img)
    gray = grayscale(x, keep_rgb=False)[..., 0]
    edges = sobel_edges(gray, mode="wrap_u8").to(F32)  # [N, H, W]
    flat = edges.reshape(x.shape[0], -1)
    # torch.quantile takes at most 2^24 values a call: a chunk of images each
    step = max(1, (1 << 24) // max(flat.shape[1], 1))
    thresh = torch.cat([torch.quantile(flat[i : i + step], 0.7, dim=1)
                        for i in range(0, flat.shape[0], step)])
    fg = _dilate3x3(edges > thresh[:, None, None], 3)
    out = torch.where(fg[..., None], as_float(x), _background(bg_color, x.device))
    out = out.to(torch.uint8) if img.dtype == torch.uint8 else out
    return restore_layout(out, single)


def apply_background_change_simple(img: torch.Tensor, bg_color) -> torch.Tensor:
    """70/30 PIL blend with a solid background: ``trunc(x + 0.3 (bg - x))``,
    clipped (transformation.py:349-354)."""
    x, single = as_batch(img)
    xf = as_float(x)
    out = xf + 0.3 * (_background(bg_color, x.device) - xf)
    out = torch.clamp(torch.trunc(out), 0, 255)
    out = out.to(torch.uint8) if img.dtype == torch.uint8 else out
    return restore_layout(out, single)


def random_crop(img: torch.Tensor, generator: torch.Generator | None = None, pad: int = 4,
                offset: tuple[int, int] | None = None) -> torch.Tensor:
    """Reflect-pad by ``pad``, then crop back to the original size
    (transformations_code:43-49, torchvision RandomCrop(32, padding=4)).
    One offset ``(y0, x0)`` in 0..2*pad serves the whole batch, as in the
    JAX op: ``offset`` when given, else two draws from ``generator``."""
    x, single = as_batch(img)
    h, w = x.shape[1], x.shape[2]
    if offset is None:
        yx = torch.randint(0, 2 * pad + 1, (2,), generator=generator,
                           device=generator.device if generator is not None else "cpu")
        y0, x0 = (int(v) for v in yx.tolist())
    else:
        y0, x0 = (int(v) for v in offset)
    rows = _reflect_indices(h, pad, x.device)[y0 : y0 + h]
    cols = _reflect_indices(w, pad, x.device)[x0 : x0 + w]
    return restore_layout(x[:, rows][:, :, cols], single)


def apply_camera_distance(img: torch.Tensor, distance_factor: float) -> torch.Tensor:
    """transformation.py:309-315: scale by neutral / distance (2.75 / d)."""
    return apply_scale(img, 2.75 / float(distance_factor))


def apply_xy_translation_3d(img: torch.Tensor, tx: float, ty: float) -> torch.Tensor:
    """transformation.py:317-322: a translation by fractions of the size."""
    x, _ = as_batch(img)
    return apply_translation(img, float(int(tx * x.shape[2])), float(int(ty * x.shape[1])))


def apply_rotation_3d(img: torch.Tensor, angle: float) -> torch.Tensor:
    """transformation.py:324-325: an alias of apply_rotation."""
    return apply_rotation(img, angle)
