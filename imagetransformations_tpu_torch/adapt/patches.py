"""Angelic (restorative) patches: gradient-trained patches that REDUCE loss
(PyTorch).

Counterpart of ``imagetransformations_tpu/adapt/patches.py``. Parity map
(reference -> here):
- pipenline/angellic.py:53-76    -> apply_patch (center / random position)
- pipenline/angellic.py:94-143   -> train_universal_patch: sign-SGD patch
  update minimizing CE under corruption (patch.data.sub_(lr*sign(grad)))
- pipenline/cifar100_angelic_entropyloss.py:41-70 -> per-image restorative
  patch optimized by Adam on entropy for 20 iters (all images at once)
- fall_2025/angellic_patches_fgsm_cifar_transformations.py:35-47 ->
  apply_transformed_patch (random scale + rotation at apply time, EOT-style)
- fall_2025/angellic_with_corrupt.py:65-107 -> adet_operator (random-affine
  patch application)

Images are NHWC f32 in [0, 1] and patches [ph, pw, C], as in the JAX
package; ``model_fn`` maps such a batch to logits (for the port's NCHW
classifiers: ``lambda x: model(normalize_cifar(x).permute(0, 3, 1, 2))``).
Every random draw can be passed in explicitly (keyword arguments named
after the draw), else it comes from the caller's ``torch.Generator``. The
bilinear warps run the plain ``ops.warp.affine_warp``; every forward and
backward runs in true f32 (``core.precision.full_f32``), and Adam is
optax's (``adapt._optim``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from imagetransformations_tpu_torch.adapt import _optim
from imagetransformations_tpu_torch.core.image import entry_device, to_device, trig_f32
from imagetransformations_tpu_torch.core.precision import full_f32
from imagetransformations_tpu_torch.ops.warp import (
    affine_warp,
    compose_matrices,
    rotation_matrix,
    zoom_matrix,
)

F32 = torch.float32


def _need(generator, what: str):
    if generator is None:
        raise ValueError(f"{what}: pass a torch.Generator or the draw itself")
    return generator


def _on(v, device, dtype=None) -> torch.Tensor:
    """An explicit draw (array, number or tensor) as a tensor on ``device``."""
    t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v))
    return t.to(device) if dtype is None else t.to(device, dtype)


def _uniform(v, lo: float, hi: float, shape, generator, device, what: str) -> torch.Tensor:
    """The explicit draw ``v`` as f32 on ``device``, else U[lo, hi) from
    ``generator``."""
    if v is not None:
        return _on(v, device, F32).reshape(shape)
    g = _need(generator, what)
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


def _randint(v, high: int, generator, device, what: str) -> int:
    if v is not None:
        return int(v)
    g = _need(generator, what)
    return int(torch.randint(0, high, (), generator=g, device=device))


def _paste(images: torch.Tensor, patch: torch.Tensor, y0: int, x0: int) -> torch.Tensor:
    """``images`` with ``patch`` written at (y0, x0) in every image (a copy;
    the gradient reaches ``patch``)."""
    ph, pw = patch.shape[-3], patch.shape[-2]
    out = images.clone()
    out[:, y0: y0 + ph, x0: x0 + pw, :] = patch
    return out


def apply_patch(images: torch.Tensor, patch: torch.Tensor, position: str = "center",
                generator: torch.Generator | None = None, y0: int | None = None,
                x0: int | None = None) -> torch.Tensor:
    """Paste a [ph, pw, C] patch into every image. ``position="center"``, or
    any other value for one random position shared by the batch: (``y0``,
    ``x0``) explicit, else drawn from ``generator`` in [0, h - ph] x [0, w -
    pw]; an explicit position is clamped into the image, as JAX's
    ``dynamic_update_slice`` clamps it."""
    _, h, w, _ = images.shape
    ph, pw = patch.shape[:2]
    if position == "center":
        return _paste(images, patch, (h - ph) // 2, (w - pw) // 2)
    y0 = _randint(y0, h - ph + 1, generator, images.device, "apply_patch")
    x0 = _randint(x0, w - pw + 1, generator, images.device, "apply_patch")
    return _paste(images, patch, min(max(y0, 0), h - ph), min(max(x0, 0), w - pw))


def apply_transformed_patch(images: torch.Tensor, patch: torch.Tensor,
                            generator: torch.Generator | None = None, *, scale=None,
                            angle=None, y0: int | None = None,
                            x0: int | None = None) -> torch.Tensor:
    """EOT-style apply: the patch zoomed by ``scale`` in [0.8, 1.2] about its
    centre and rotated by ``angle`` in [-15, 15] degrees (bilinear, zero
    fill; each explicit or drawn), then pasted at one random position."""
    dev = images.device
    s = _uniform(scale, 0.8, 1.2, (), generator, dev, "apply_transformed_patch")
    a = _uniform(angle, -15.0, 15.0, (), generator, dev, "apply_transformed_patch")
    ph, pw = patch.shape[:2]
    m = compose_matrices(zoom_matrix(s, pw, ph, device=dev), rotation_matrix(a, pw, ph, device=dev))
    tp = affine_warp(patch[None], m, method="bilinear", fill=0.0)[0]
    return apply_patch(images, tp, "random", generator, y0, x0)


def _blur3(x: torch.Tensor) -> torch.Tensor:
    """The ADET pool's 3-tap [0.25, 0.5, 0.25] blur, edge-padded, along W
    then H, each sum in the JAX package's order."""
    h, w = x.shape[1], x.shape[2]
    taps = (0.25, 0.5, 0.25)
    xp = torch.cat([x[:, :, :1], x, x[:, :, -1:]], dim=2)
    xh = taps[0] * xp[:, :, 0:w] + taps[1] * xp[:, :, 1:w + 1] + taps[2] * xp[:, :, 2:w + 2]
    xhp = torch.cat([xh[:, :1], xh, xh[:, -1:]], dim=1)
    return taps[0] * xhp[:, 0:h] + taps[1] * xhp[:, 1:h + 1] + taps[2] * xhp[:, 2:h + 2]


def adet_operator(
    images: torch.Tensor,
    patch: torch.Tensor,
    generator: torch.Generator | None = None,
    scale_range: tuple[float, float] = (0.8, 1.2),
    rotate_deg: float = 15.0,
    shear_max: float = 0.15,
    brightness_jitter: float = 0.2,
    corruption_fns: "tuple | None | str" = "default",
    *,
    corruption_idx=None,
    scale=None,
    angle=None,
    shear=None,
    brightness=None,
    y_u=None,
    x_u=None,
    noise=None,
) -> torch.Tensor:
    """ADET operator: per-image random corruption + random-affine patch paste.

    Reference (fall_2025/angellic_with_corrupt.py:65-107): for EACH image a
    corruption from Delta = {gaussian noise 0.05, 3x3 blur}, a patch scale in
    ``scale_range`` and a location; as in JAX, also a rotation within
    ``rotate_deg``, a shear within ``shear_max`` and a brightness factor
    within ``1 +- brightness_jitter`` (0 for the reference's family). One
    batched inverse-map ``affine_warp`` of the patch + alpha canvas, then the
    alpha >= 0.5 select.

    ``corruption_fns``: "default" (the pool above), a tuple of ``fn(x) -> x``
    or None / () for no corruption. The draws, each [N] and each explicit or
    drawn from ``generator``: ``corruption_idx`` (ints), ``scale``,
    ``angle`` (degrees), ``shear``, ``brightness``, ``y_u`` and ``x_u``
    (U[0, 1): the position as a share of the room left), and ``noise`` (the
    default pool's N(0, 1), shaped like ``images``).

    images: [N, H, W, C] f32 in [0, 1]; patch: [ph, pw, C].
    """
    n, h, w, c = images.shape
    ph, pw = patch.shape[:2]
    dev = images.device

    if isinstance(corruption_fns, str) and corruption_fns == "default":
        if noise is None:
            noise = torch.randn(images.shape, generator=_need(generator, "adet_operator"),
                                device=dev)
        noise = _on(noise, dev, F32)
        corruption_fns = (lambda x: torch.clamp(x + 0.05 * noise, 0.0, 1.0), _blur3)
    if corruption_fns:
        if corruption_idx is None:
            idx = torch.randint(0, len(corruption_fns), (n,),
                                generator=_need(generator, "adet_operator"), device=dev)
        else:
            idx = _on(corruption_idx, dev)
        idx = idx.reshape(n, 1, 1, 1)
        out = images
        for i, fn in enumerate(corruption_fns):
            out = torch.where(idx == i, fn(images), out)
        images = out

    def draw(v, lo, hi):
        return _uniform(v, lo, hi, (n,), generator, dev, "adet_operator")

    s = draw(scale, scale_range[0], scale_range[1])
    a = draw(angle, -rotate_deg, rotate_deg)
    sh = draw(shear, -shear_max, shear_max)
    br = draw(brightness, 1.0 - brightness_jitter, 1.0 + brightness_jitter)
    # a random location keeping the (scaled) patch inside the canvas
    ext = s * float(max(ph, pw)) * (1.0 + torch.abs(sh))
    y0 = draw(y_u, 0.0, 1.0) * torch.clamp(h - ext, min=0.0)
    x0 = draw(x_u, 0.0, 1.0) * torch.clamp(w - ext, min=0.0)

    # inverse map canvas (x, y) -> patch coordinates: (1/s) K^-1 R^-1
    rad = torch.deg2rad(a)
    cos, sin = trig_f32(torch.cos, rad), trig_f32(torch.sin, rad)
    inv_s = 1.0 / s
    a_ = inv_s * (cos - sh * (-sin))
    b_ = inv_s * (sin - sh * cos)
    d_ = inv_s * (-sin)
    e_ = inv_s * cos
    # anchor: the canvas point (x0 + s*pw/2, y0 + s*ph/2) maps to the patch centre
    cxs = x0 + s * pw / 2.0
    cys = y0 + s * ph / 2.0
    c_ = pw / 2.0 - a_ * cxs - b_ * cys
    f_ = ph / 2.0 - d_ * cxs - e_ * cys
    m = torch.stack([a_, b_, c_, d_, e_, f_], dim=-1)

    pa = torch.cat([patch, torch.ones((ph, pw, 1), dtype=patch.dtype, device=dev)], dim=-1)
    canvas = affine_warp(pa[None].expand(n, ph, pw, c + 1), m, out_size=(h, w),
                         method="bilinear", fill=0.0)
    alpha = canvas[..., -1:] >= 0.5
    pimg = torch.clamp(canvas[..., :c] * br.reshape(-1, 1, 1, 1), 0.0, 1.0)
    return torch.where(alpha, pimg, images)


def train_universal_patch(
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    batches_iter,
    labels_iter,
    patch_hw: tuple[int, int] = (20, 20),
    channels: int = 3,
    lr: float = 0.01,
    corruption_fn: Callable | None = None,
    generator: torch.Generator | None = None,
    position: str = "center",
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """Sign-SGD universal patch minimizing CE under corruption.

    The reference trains 50 epochs over CIFAR-10 train (angellic.py:129-134:
    ``patch -= lr * sign(grad)``); here one step a batch of ``batches_iter``
    (NHWC f32 in [0, 1]) with its labels, the patch clipped to [0, 1] after
    each. ``corruption_fn(x, generator)`` corrupts each batch first; a
    random ``position`` is drawn from ``generator`` a step. Runs on
    ``device`` (None means "cuda", which raises without a GPU); returns the
    [ph, pw, C] patch there."""
    dev = entry_device(device, "train_universal_patch")
    patch = torch.zeros((*patch_hw, channels), dtype=F32, device=dev) + 0.5
    for x, y in zip(batches_iter, labels_iter):
        x, y = to_device(x, dev), to_device(y, dev).long()
        if corruption_fn is not None:
            x = corruption_fn(x, generator)
        leaf = patch.detach().requires_grad_(True)
        with full_f32(), torch.enable_grad():
            xp = apply_patch(x, leaf, position, generator)
            loss = F.cross_entropy(model_fn(xp), y)
            (g,) = torch.autograd.grad(loss, leaf)
        patch = torch.clamp(patch - lr * torch.sign(g), 0.0, 1.0)
    return patch


def _mean_entropy(logits: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(torch.exp(logp) * logp, dim=-1))


def restorative_patches_per_image(
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    x,
    patch_hw: tuple[int, int] = (8, 8),
    iters: int = 20,
    lr: float = 0.1,
    device: str | torch.device | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-image centred patch minimizing the batch's mean predictive
    entropy.

    Reference get_restorative_patch (cifar100_angelic_entropyloss.py:41-70)
    optimizes image by image; here all images at once: the patches are one
    [B, ph, pw, C] leaf, ``iters`` steps of optax's Adam(``lr``), clipped to
    [0, 1] after each. Runs on ``device`` (None means "cuda", which raises
    without a GPU). Returns (patched images, patches)."""
    dev = entry_device(device, "restorative_patches_per_image")
    x = to_device(x, dev)
    n, h, w, c = x.shape
    ph, pw = patch_hw
    y0, x0 = (h - ph) // 2, (w - pw) // 2
    patches = torch.zeros((n, ph, pw, c), dtype=F32, device=dev) + 0.5
    state = _optim.adam_init({"p": patches})
    for _ in range(iters):
        leaf = patches.detach().requires_grad_(True)
        with full_f32(), torch.enable_grad():
            loss = _mean_entropy(model_fn(_paste(x, leaf, y0, x0)))
            (g,) = torch.autograd.grad(loss, leaf)
        updates, state = _optim.adam_update({"p": g}, state, lr)
        patches = torch.clamp(_optim.apply_updates({"p": patches}, updates)["p"], 0.0, 1.0)
    return _paste(x, patches, y0, x0), patches
