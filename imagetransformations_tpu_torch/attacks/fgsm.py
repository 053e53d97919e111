"""FGSM attack, reverse-FGSM defence and adversarial training (PyTorch).

Counterpart of ``imagetransformations_tpu/attacks/fgsm.py:27-122``:
- attacks/fgsm/cifar-10/fgsm_reversefgsm_cifar10.py:23-27 -> fgsm_attack
  (x + eps sign(grad)) and reverse_fgsm (x - eps sign(grad)), clipped to
  the valid range.
- attacks/fgsm.py:201-219 -> minimal_epsilon: the smallest eps of a grid
  that flips each sample's prediction (one forward a grid level over the
  whole batch, not the reference's loop over images).
- attacks/fgsm.py:233-263 -> adversarial_train_step: the loss on the clean
  and the FGSM-perturbed batch.
- attacks/fgsm/imagenet/fgsm_reversefgsm_imagenet.py:27-44 ->
  denormalize / renormalize.

Each input gradient is one ``torch.autograd.grad`` of the batch's mean
cross-entropy (``core.precision.input_gradient``: forward and backward in
true f32). ``model_fn`` maps the port's model space (NCHW) to logits.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from imagetransformations_tpu_torch.core.grids import linspace_f32
from imagetransformations_tpu_torch.core.precision import full_f32, input_gradient
from imagetransformations_tpu_torch.core.mesh import (
    ShardedBatch, average_gradients, batch_mesh, local_view, mean_over_ranks, shard_images)


def _ce_grad(model_fn: Callable, x: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """d mean CE(model_fn(x), labels) / d x."""
    return input_gradient(lambda xb: F.cross_entropy(model_fn(xb), labels.long()), x)


def fgsm_attack(model_fn: Callable, x: torch.Tensor, labels: torch.Tensor,
                eps: float = 0.03, clip_min: float = 0.0,
                clip_max: float = 1.0) -> torch.Tensor:
    """x_adv = clip(x + eps * sign(dL/dx)). Per example: a ``ShardedBatch``
    ``x`` on a process mesh is attacked shard by shard, with no collective
    (the sign of an example's gradient does not depend on the batch's
    size), and the result is this rank's ``ShardedBatch``."""
    xl, mesh = local_view(x)
    if mesh is not None:
        labels = shard_images(labels, mesh).shards[0]
    g = _ce_grad(model_fn, xl, labels)
    adv = torch.clamp(xl.detach() + eps * torch.sign(g), clip_min, clip_max)
    return adv if mesh is None else ShardedBatch((adv,), mesh, x.axis)


def reverse_fgsm(model_fn: Callable, x: torch.Tensor, labels: torch.Tensor,
                 eps: float = 0.03, clip_min: float = 0.0,
                 clip_max: float = 1.0) -> torch.Tensor:
    """x_def = clip(x - eps * sign(dL/dx)), the recovery direction: it
    descends the loss of ``labels``, which must be the original labels or
    the model's pseudo-labels (its prediction on the clean input), as the
    reference does; never the prediction on the adversarial input, whose
    descent only entrenches the attack (the JAX-side
    tools/attack_artifacts.py:419 passes that, ADVICE.md:3)."""
    g = _ce_grad(model_fn, x, labels)
    return torch.clamp(x.detach() - eps * torch.sign(g), clip_min, clip_max)


def minimal_epsilon(model_fn: Callable, x: torch.Tensor, labels: torch.Tensor,
                    eps_grid: torch.Tensor | None = None) -> torch.Tensor:
    """Per-sample smallest eps of ``eps_grid`` (default 1/255 .. 16/255, 16
    levels, JAX's f32 ``linspace`` within 1 ulp) whose FGSM step flips the
    prediction; inf where none does."""
    if eps_grid is None:
        eps_grid = linspace_f32(1.0 / 255, 16.0 / 255, 16)
    eps_grid = torch.as_tensor(eps_grid, dtype=torch.float32).to(x.device)
    g = torch.sign(_ce_grad(model_fn, x, labels))
    x = x.detach()
    with torch.no_grad():
        flips = torch.stack([
            torch.argmax(model_fn(torch.clamp(x + eps * g, 0.0, 1.0)), dim=-1) != labels
            for eps in eps_grid])  # [E, B]
    first = torch.argmax(flips.to(torch.int32), dim=0)  # jnp.argmax of bools: the first True
    return torch.where(torch.any(flips, dim=0), eps_grid[first],
                       torch.full_like(eps_grid[first], float("inf")))


def adversarial_train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                           x: torch.Tensor, labels: torch.Tensor,
                           eps: float = 8.0 / 255, adv_weight: float = 0.5) -> torch.Tensor:
    """One step of mixed clean + FGSM training (attacks/fgsm.py:233-263):
    the adversarial batch is crafted against the current weights with
    BatchNorm in evaluation mode; the loss (1 - w) CE(clean) + w CE(adv)
    runs both forwards in training mode from the same running statistics,
    and the statistics kept are the adversarial forward's, as the JAX step
    keeps ``stats2``. Updates ``model`` and ``optimizer`` in place; returns
    the loss. ``x`` may be a ``ShardedBatch`` on a process mesh, as in
    ``models.training.make_train_step``: each rank crafts and trains on its
    shard, BatchNorm takes the global statistics, the gradients are
    averaged over the ranks, and the loss is the global batch's."""
    x, mesh = local_view(x)
    if mesh is not None:
        labels = shard_images(labels, mesh).shards[0]
    x_adv = fgsm_attack(model, x, labels, eps)
    y = labels.long()
    optimizer.zero_grad(set_to_none=True)
    saved = {k: b.clone() for k, b in model.named_buffers()}
    with full_f32(), batch_mesh(mesh):
        ce_clean = F.cross_entropy(model(x, True), y)
        with torch.no_grad():
            for k, b in model.named_buffers():
                b.copy_(saved[k])
        ce_adv = F.cross_entropy(model(x_adv, True), y)
        loss = (1.0 - adv_weight) * ce_clean + adv_weight * ce_adv
        loss.backward()
    if mesh is not None:
        average_gradients(model.parameters(), mesh)
    optimizer.step()
    return loss.detach() if mesh is None else mean_over_ranks(loss, mesh)


def _per_channel(v, x: torch.Tensor) -> torch.Tensor:
    """[C] statistics as a tensor broadcasting over an NCHW batch's channels."""
    return torch.as_tensor(v, dtype=x.dtype).to(x.device).reshape(-1, 1, 1)


def denormalize(x: torch.Tensor, mean, std) -> torch.Tensor:
    """Normalized model space -> [0, 1] pixel space (imagenet scripts
    :27-35), over the channel axis of NCHW (the JAX package's is NHWC's
    last)."""
    return x * _per_channel(std, x) + _per_channel(mean, x)


def renormalize(x01: torch.Tensor, mean, std) -> torch.Tensor:
    """[0, 1] pixel space -> normalized model space (NCHW channels)."""
    return (x01 - _per_channel(mean, x01)) / _per_channel(std, x01)
