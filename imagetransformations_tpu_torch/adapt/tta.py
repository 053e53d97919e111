"""Test-time augmentation: averaged probabilities of a frozen model, and
adaptive view weights (PyTorch).

Counterpart of ``imagetransformations_tpu/adapt/tta.py``:

- fall_2025/TTA_transforms.py:69-154 -> three view stacks (gentle flip /
  crop, multiscale resize -> crop, colour jitter) and the table from
  corruption family to stack (:141-154); ``predict_with_tta`` (:182-210)
  averages the views' softmax.
- fall_2025/tta_initial.py:108-141 -> adaptive TTA: simplex weights over
  {original, vertical flip, crop, brightness, contrast} minimising the ECE
  of the mixture plus an accuracy-drop penalty on a validation split, by
  scipy's SLSQP on the host (the objective reads cached view
  probabilities).

A stack is ``stack(x, generator=None, offsets=None) -> [views]`` on a u8
NHWC batch. The crops' offsets are the only draws: pass them (``offsets``,
int [k, 2] of (top, left) in 0..2*pad) or a ``torch.Generator`` to draw
them. ``model_fn`` takes a batch of views (u8 NHWC) to logits; every
forward runs in true f32 (``core.precision.full_f32``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from imagetransformations_tpu_torch.core.image import entry_device, to_device, to_host
from imagetransformations_tpu_torch.core.precision import full_f32
from imagetransformations_tpu_torch.ops import elementwise as ew
from imagetransformations_tpu_torch.ops import warp as wp
from imagetransformations_tpu_torch.uq.calibration import ece

PAD = 2


def _reflect(i: torch.Tensor, n: int) -> torch.Tensor:
    """numpy's "reflect" padding index (the edge is not repeated), for
    indices within one reflection of ``[0, n)``."""
    i = torch.abs(i)
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def pad_crop(x: torch.Tensor, pad: int, top: int, left: int) -> torch.Tensor:
    """The ``h x w`` window at (``top``, ``left``) of the batch padded by
    ``pad`` on each side in "reflect" mode (``jnp.pad(mode="reflect")``)."""
    _, h, w, _ = x.shape
    rows = _reflect(torch.arange(h, device=x.device) + (int(top) - pad), h)
    cols = _reflect(torch.arange(w, device=x.device) + (int(left) - pad), w)
    return x[:, rows][:, :, cols]


def crop_offsets(generator: torch.Generator | None, k: int, pad: int = PAD) -> list:
    """``k`` (top, left) crop offsets in ``0..2*pad`` drawn from
    ``generator``, as host integers."""
    if generator is None:
        raise ValueError("the crop views draw their offsets: pass generator= or offsets=")
    return torch.randint(0, 2 * pad + 1, (k, 2), generator=generator,
                         device=generator.device).cpu().tolist()


def _offsets(offsets, generator, k: int) -> list:
    return crop_offsets(generator, k) if offsets is None else np.asarray(offsets).tolist()


def gentle_stack(x: torch.Tensor, generator: torch.Generator | None = None,
                 offsets=None) -> list[torch.Tensor]:
    """Flip + two small random crops (TTA_transforms.py:74-95)."""
    (t1, l1), (t2, l2) = _offsets(offsets, generator, 2)
    return [x, wp.flip_vertical(x), pad_crop(x, PAD, t1, l1), pad_crop(x, PAD, t2, l2)]


def multiscale_stack(x: torch.Tensor, generator: torch.Generator | None = None,
                     offsets=None) -> list[torch.Tensor]:
    """PIL bilinear resize up (36 / 40 for 32-pixel inputs), then the centre
    crop back (:96-118)."""
    _, h, w, _ = x.shape
    views = [x]
    for scale in (1.125, 1.25):
        up = wp.pil_resize(x, int(w * scale), int(h * scale), "bilinear")
        views.append(wp.center_crop(up, h, w))
    return views


def color_stack(x: torch.Tensor, generator: torch.Generator | None = None,
                offsets=None) -> list[torch.Tensor]:
    """Brightness / contrast jitter (:119-138)."""
    return [x, ew.apply_brightness(x, 0.1), ew.apply_brightness(x, -0.1),
            ew.apply_contrast(x, 0.9)]


#: corruption family -> stack (TTA_transforms.py corruption_to_strategy :141-154)
CORRUPTION_TO_STRATEGY: dict[str, Callable] = {
    **{k: gentle_stack for k in ("gaussian_noise", "shot_noise", "impulse_noise",
                                 "speckle_noise")},
    **{k: multiscale_stack for k in ("defocus_blur", "glass_blur", "motion_blur", "zoom_blur",
                                     "gaussian_blur")},
    **{k: color_stack for k in ("brightness", "contrast", "fog", "frost", "snow", "saturate",
                                "jpeg_compression", "pixelate", "elastic_transform",
                                "spatter")},
}


def _view_probs(model_fn, views) -> torch.Tensor:
    """[V, B, C] softmax of each view's logits."""
    with torch.no_grad(), full_f32():
        return torch.stack([torch.softmax(model_fn(v), dim=-1) for v in views])


def predict_with_tta(
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    images,
    generator: torch.Generator | None = None,
    stack: Callable = gentle_stack,
    jit: bool = True,
    offsets=None,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Mean softmax over ``stack``'s views -> [B, C] probabilities.
    ``jit`` is the JAX signature's compile switch and does nothing here
    (nothing is compiled). Runs on ``device`` (None means "cuda", which
    raises without a GPU)."""
    del jit  # the JAX package's jit cache; nothing to compile here
    x = to_device(images, entry_device(device, "predict_with_tta"))
    return torch.mean(_view_probs(model_fn, stack(x, generator, offsets)), dim=0)


# ------------------------------------------------------- adaptive TTA


def adaptive_view_probs(model_fn, images, generator: torch.Generator | None = None,
                        offsets=None, device: str | torch.device | None = None) -> torch.Tensor:
    """[V, B, C] probabilities of the adaptive-TTA views (tta_initial.py:
    69-90): the input, its vertical flip, a 2-pixel reflect-padded crop
    (``offsets``: one (top, left) pair, else drawn), brightness +0.1 and
    contrast 0.9. Runs on ``device`` (None means "cuda")."""
    x = to_device(images, entry_device(device, "adaptive_view_probs"))
    ((top, left),) = _offsets(offsets, generator, 1)
    views = [x, wp.flip_vertical(x), pad_crop(x, PAD, top, left), ew.apply_brightness(x, 0.1),
             ew.apply_contrast(x, 0.9)]
    return _view_probs(model_fn, views)


def fit_adaptive_weights(
    view_probs,
    labels,
    acc_penalty: float = 10.0,
    n_bins: int = 10,
) -> np.ndarray:
    """Simplex weights minimising the ECE of the weighted mixture plus
    ``acc_penalty`` times the accuracy lost against the first view, by
    scipy's SLSQP from uniform weights (tta_initial.py:108-141,
    ece_loss_obj :117-127). As in the JAX package the mixture is numpy's
    f64 ``einsum`` of the f32 view probabilities, rounded to f32 for the
    ECE (``uq.calibration.ece`` on the host). The ECE is piecewise constant
    and SLSQP differentiates it by finite differences, so an ulp in the
    objective can change its path; the tests measure that."""
    from scipy.optimize import minimize

    view_probs = to_host(view_probs).astype(np.float32, copy=False)
    labels = np.array(to_host(labels))
    labels_t = torch.from_numpy(labels)
    v = view_probs.shape[0]
    base_acc = float((view_probs[0].argmax(-1) == labels).mean())

    def obj(w):
        w = np.clip(w, 0.0, None)
        w = w / max(w.sum(), 1e-12)
        mixed = np.einsum("v,vbc->bc", w, view_probs)
        e = float(ece(torch.from_numpy(mixed.astype(np.float32)), labels_t, n_bins))
        acc = float((mixed.argmax(-1) == labels).mean())
        return e + acc_penalty * max(0.0, base_acc - acc)

    res = minimize(obj, np.full(v, 1.0 / v), method="SLSQP", bounds=[(0.0, 1.0)] * v,
                   constraints=[{"type": "eq", "fun": lambda w: w.sum() - 1.0}])
    w = np.clip(res.x, 0.0, None)
    return w / max(w.sum(), 1e-12)


def predict_adaptive(model_fn, images, weights, generator: torch.Generator | None = None,
                     offsets=None, device: str | torch.device | None = None) -> torch.Tensor:
    """The ``weights``-weighted mixture of ``adaptive_view_probs`` -> [B, C]."""
    probs = adaptive_view_probs(model_fn, images, generator, offsets, device)
    w = torch.as_tensor(np.asarray(weights, np.float32)).to(probs.device)
    with full_f32():
        return torch.einsum("v,vbc->bc", w, probs)
