"""Training loops (PyTorch): supervised steps, ensembles, the BNN ELBO.

Counterpart of ``imagetransformations_tpu/models/training.py:23-110``:
- ensemble.py:49-77      -> train_members (M independent inits and fits)
- baysian.py:137-158     -> make_elbo_step (CE(sum) + kl_weight * KL, Adam)
- swag/cifar_swag.py:137-166 -> swag_collect (SGD steps + swag.update per
  batch)

The JAX steps are pure functions of (params, batch_stats, opt_state); here
a step updates the module and its optimizer in place and returns the
batch's numbers. Training-mode BatchNorm follows flax's rule (the biased
batch variance in the running statistics, ``models._layers.BatchNorm``),
so a step from carried weights moves the statistics as the JAX step does.
The loss reduction is f32. A step's forward and backward both run inside
``full_f32``: cuDNN's convolution backward reads the TF32 flag when the
backward runs, so a scope around the forward alone leaves the gradients in
TF32 under the caller's default flags.
"""

from __future__ import annotations

from typing import Callable, Iterable

import torch
import torch.nn.functional as F
from torch import nn

from imagetransformations_tpu_torch.core.precision import full_f32
from imagetransformations_tpu_torch.core.mesh import (
    ShardedBatch, average_gradients, batch_mesh, local_view, mean_over_ranks, psum_mean,
    shard_images)


def make_train_step(model: nn.Module, optimizer: torch.optim.Optimizer) -> Callable:
    """Standard CE step: ``step(x, y) -> (loss, accuracy)`` (0-dim tensors),
    the forward in training mode (``model(x, True)``). After a step each
    parameter's ``.grad`` holds the batch's gradient.

    ``x`` may be a ``ShardedBatch`` on a process mesh (``y`` then the
    global labels or their ``ShardedBatch``): each rank runs its shard,
    BatchNorm takes the global batch statistics, the gradients are averaged
    over the ranks, and the optimizer step, replicated, leaves the same
    parameters on every rank; the loss and the accuracy are the global
    batch's (``psum_mean``)."""

    def step(x, y):
        x, mesh = local_view(x)
        if mesh is not None:
            y = shard_images(y, mesh).shards[0]
        optimizer.zero_grad(set_to_none=True)
        with full_f32(), batch_mesh(mesh):
            logits = model(x, True).to(torch.float32)
            loss = F.cross_entropy(logits, y.long())
            loss.backward()
        if mesh is not None:
            average_gradients(model.parameters(), mesh)
        optimizer.step()
        with torch.no_grad():
            correct = (torch.argmax(logits, -1) == y).to(torch.float32)
        if mesh is None:
            return loss.detach(), torch.mean(correct)
        return (mean_over_ranks(loss, mesh),
                psum_mean(ShardedBatch((correct,), mesh)))

    return step


def fit(model: nn.Module, data_iter: Iterable, epochs: int = 1, lr: float = 1e-3) -> nn.Module:
    """Minimal fit loop: Adam(lr) over ``data_iter``'s (x, y) batches for
    ``epochs`` (``data_iter`` is iterated once an epoch); returns ``model``.
    The JAX ``fit`` also initializes from a key: here the caller builds the
    module (``train_members`` seeds it)."""
    step = make_train_step(model, torch.optim.Adam(model.parameters(), lr=lr))
    for _ in range(epochs):
        for x, y in data_iter:
            step(x, y)
    return model


def train_members(
    make_model: Callable[[], nn.Module], num_members: int,
    data_iter_fn: Callable[[], Iterable], epochs: int = 1, lr: float = 1e-3,
    seed: int = 0,
) -> list[nn.Module]:
    """Deep ensemble (ensemble.py:49-77): member m is ``make_model()`` built
    under ``torch.manual_seed(seed + m)`` (the process's generators restored
    after), then fit on ``data_iter_fn()``."""
    members = []
    for m in range(num_members):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed + m)
            model = make_model()
        members.append(fit(model, data_iter_fn(), epochs, lr))
    return members


def make_elbo_step(model: nn.Module, optimizer: torch.optim.Optimizer,
                   kl_weight: float) -> Callable:
    """Bayes-by-backprop step (baysian.py:137-158): ``step(x, y, generator)
    -> (ce, kl)``, minimizing CE summed over the batch + ``kl_weight`` * KL,
    the weight noise drawn from ``generator``."""
    from imagetransformations_tpu_torch.models.bayesian import kl_loss

    def step(x: torch.Tensor, y: torch.Tensor, generator: torch.Generator | None = None):
        optimizer.zero_grad(set_to_none=True)
        with full_f32():
            logits = model(x, True, generator)
            ce = F.cross_entropy(logits, y.long(), reduction="sum")
            kl = kl_loss(model)
            (ce + kl_weight * kl).backward()
        optimizer.step()
        return ce.detach(), kl.detach()

    return step


def swag_collect(model: nn.Module, data_iter: Iterable, *, lr: float = 1e-4,
                 max_rank: int = 20, update_every: int = 1):
    """SWAG collection (cifar_swag.py:137-166 at lr=1e-4): ``make_train_step``
    with SGD(lr, momentum 0.9) over ``data_iter``'s (x, y) batches (optax's
    ``sgd(lr, momentum=0.9)``: no dampening, no Nesterov, the first momentum
    buffer the gradient), and ``swag.update`` on the trainable parameters
    after every ``update_every``-th step, the first included. Trains
    ``model`` in place; returns ``(model, swag_state)``."""
    from imagetransformations_tpu_torch.uq import swag

    step = make_train_step(model, torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9))
    state = swag.init(model, max_rank=max_rank)
    for i, (x, y) in enumerate(data_iter):
        step(x, y)
        if i % update_every == 0:
            swag.update(state, model)
    return model, state
