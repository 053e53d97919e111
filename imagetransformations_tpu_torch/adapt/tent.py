"""TENT test-time adaptation of the BatchNorm parameters (PyTorch).

Counterpart of ``imagetransformations_tpu/adapt/tent.py`` (the reference's
fall_2025/TENT_Pipelines.py):

- configure_model_for_tent (:70-83): only the BatchNorm scale and bias
  adapt, and the forward normalizes by the batch's statistics;
- the entropy loss (:95-97): ``-(softmax * log_softmax).sum(1).mean()``;
- tent_forward_and_adapt (:123-143): forward, entropy, backward, clip the
  gradients' global norm to 1, one Adam step; the prediction is the same
  forward's;
- the continuous, reset and conditional protocols (:162-303).

The adaptation is functional, as in JAX: a ``TentState`` holds the BatchNorm
parameters (chosen by module type, ``models._layers.BatchNorm``), the frozen
rest and the Adam state, and each step runs the caller's module through
``torch.func.functional_call`` on them. The module itself is never changed:
the batch-statistics forward updates running statistics in place
(``BatchNorm.forward(x, train=True)``), so it runs on scratch copies of the
buffers, which are dropped, as JAX drops the ``mutable=["batch_stats"]``
update. The JAX package's ``lax.scan`` over batches and its jit caches are
compile workarounds; here the protocols are one loop over the batches.
Every forward and backward runs in true f32 (``core.precision.full_f32``).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch import nn
from torch.func import functional_call

from imagetransformations_tpu_torch.adapt import _optim
from imagetransformations_tpu_torch.adapt.conditional import batch_gate_fraction
from imagetransformations_tpu_torch.core.image import entry_device, to_device
from imagetransformations_tpu_torch.core.precision import full_f32
from imagetransformations_tpu_torch.models._layers import BatchNorm
from imagetransformations_tpu_torch.core.mesh import (
    ShardedBatch, batch_mesh, local_view, mean_over_ranks, shard_images)

Params = dict[str, torch.Tensor]
PROTOCOLS = ("continuous", "reset", "conditional")


def entropy_loss(logits: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(torch.exp(logp) * logp, dim=-1))


def bn_parameter_names(model: nn.Module) -> list[str]:
    """The names of the parameters that belong to BatchNorm modules. By
    module type: the port's names for these layers (``downsample.1``, the
    VGG's ``features.N``) do not all hold "bn", which the JAX package's
    flax paths do."""
    return [f"{m}.{p}" if m else p for m, mod in model.named_modules()
            if isinstance(mod, BatchNorm) for p, _ in mod.named_parameters(recurse=False)]


def partition_bn_params(model: nn.Module) -> tuple[Params, Params]:
    """(BatchNorm parameters, the rest) of ``model`` as two dicts by name:
    the first detached copies (TENT's state), the second detached views."""
    names = set(bn_parameter_names(model))
    bn, frozen = {}, {}
    for k, v in model.named_parameters():
        if k in names:
            bn[k] = v.detach().clone()
        else:
            frozen[k] = v.detach()
    return bn, frozen


def merge_params(bn: Params, frozen: Params) -> Params:
    return {**frozen, **bn}


@dataclasses.dataclass
class TentState:
    """The BatchNorm parameters by name, the frozen rest, and the Adam
    state of the BatchNorm parameters flattened into one vector (optax's
    rules are elementwise but for the global norm, which sums over every
    element either way; one vector costs a launch an operation, not one a
    tensor)."""

    bn_params: Params
    frozen_params: Params
    opt_state: _optim.AdamState


def _flat(params: Params) -> dict:
    return {"bn": torch.cat([v.reshape(-1) for v in params.values()])}


def _unflat(flat: torch.Tensor, like: Params) -> Params:
    parts = flat.split([v.numel() for v in like.values()])
    return {k: p.view(v.shape) for (k, v), p in zip(like.items(), parts)}


@dataclasses.dataclass(frozen=True)
class TentOptimizer:
    """THE TENT recipe (TENT_Pipelines.py:123-143): the gradients' global
    norm clipped to 1, then Adam at ``lr`` (optax's rules, ``_optim``)."""

    lr: float

    def init(self, params: Params) -> _optim.AdamState:
        return _optim.adam_init(params)

    def update(self, grads: Params, state: _optim.AdamState):
        return _optim.adam_update(_optim.clip_by_global_norm(grads, 1.0), state, self.lr)


def init_tent(model: nn.Module, lr: float = 2.5e-4) -> tuple[TentState, TentOptimizer]:
    """The initial state from ``model``'s parameters; lr per
    TENT_Pipelines.py:354 (1e-3 for the reset and conditional protocols)."""
    bn, frozen = partition_bn_params(model)
    tx = TentOptimizer(float(lr))
    return TentState(bn, frozen, tx.init(_flat(bn))), tx


def batch_stats_forward(model: nn.Module):
    """``forward(params, x) -> logits``: ``model`` on the parameters
    ``params`` with BatchNorm normalizing by the batch's statistics; the
    running statistics it updates are scratch copies made here, so neither
    the module nor its buffers change."""
    scratch = {k: b.detach().clone() for k, b in model.named_buffers()}

    def forward(params: Params, x: torch.Tensor) -> torch.Tensor:
        with full_f32():
            return functional_call(model, {**params, **scratch}, (x, True))

    return forward


def make_tent_step(model: nn.Module, tx: TentOptimizer):
    """``step(state, x) -> (state', logits)``: the batch-statistics forward,
    the entropy of its logits, the gradient for the BatchNorm parameters,
    one ``tx`` update. The logits are the forward's, before the update.

    ``x`` may be a ``ShardedBatch`` on a process mesh: each rank runs its
    shard with BatchNorm's global batch statistics, the entropy's gradient
    is averaged over the ranks (the global mean's), the update is
    replicated, and the logits are this rank's ``ShardedBatch``."""
    forward = batch_stats_forward(model)

    def step(state: TentState, x) -> tuple[TentState, torch.Tensor | ShardedBatch]:
        x, mesh = local_view(x)
        bn = {k: v.detach().requires_grad_(True) for k, v in state.bn_params.items()}
        with full_f32(), torch.enable_grad(), batch_mesh(mesh):
            logits = forward(merge_params(bn, state.frozen_params), x)
            grads = torch.autograd.grad(entropy_loss(logits), list(bn.values()))
        flat_grads = _flat(dict(zip(bn, grads)))
        if mesh is not None:
            flat_grads = {"bn": mean_over_ranks(flat_grads["bn"], mesh)}
        updates, opt_state = tx.update(flat_grads, state.opt_state)
        with torch.no_grad():
            flat = _optim.apply_updates(_flat(state.bn_params), updates)["bn"]
        logits = logits.detach()
        return (TentState(_unflat(flat, state.bn_params), state.frozen_params, opt_state),
                logits if mesh is None else ShardedBatch((logits,), mesh))

    return step


def evaluate_with_tent(
    model: nn.Module, batches, labels_batches, lr: float = 2.5e-4,
    protocol: str = "continuous", image_entropy_threshold: float = 1.16,
    device: str | torch.device | None = None,
) -> float:
    """Accuracy of ``model`` over ``batches`` under a TENT protocol:
    'continuous' (one state adapted batch after batch), 'reset' (every
    batch from the initial parameters and Adam state) or 'conditional'
    (adapt a batch iff more than half of its images have a 256-bin pixel
    entropy above ``image_entropy_threshold``, strictly; otherwise the
    batch-statistics forward with the current state, no step;
    TENT_Pipelines.py:239-303). ``batches`` are model-space inputs, or
    ``(model_space, raw_u8)`` tuples, which the conditional protocol needs
    for its gate. Batches may differ in size (a ragged tail). The module
    is not changed (parameters nor buffers).

    Runs on ``device`` (None means "cuda", which raises without a GPU);
    ``model`` must be there, and the batches (tensors or numpy arrays) are
    moved there. Batches and labels may be ``ShardedBatch`` es on a process
    mesh (``make_tent_step``'s rules; ``device`` then the rank's own): the
    gate reads the whole raw batch on every rank, and the accuracy counts
    the global batch."""
    if protocol not in PROTOCOLS:
        raise ValueError(f"unknown TENT protocol {protocol!r}; one of {PROTOCOLS}")
    dev = entry_device(device, "evaluate_with_tent")
    has_raw = bool(batches) and isinstance(batches[0], tuple)
    if any(isinstance(b, tuple) != has_raw for b in batches):
        raise ValueError("batches mix (x, raw_u8) tuples with bare arrays — supply one "
                         "form consistently")
    if protocol == "conditional" and not has_raw:
        raise ValueError("conditional protocol needs (x, raw_u8) batch tuples for the "
                         "pixel-entropy gate (TENT_Pipelines.py:239-303)")
    state0, tx = init_tent(model, lr)
    step = make_tent_step(model, tx)
    forward = batch_stats_forward(model)
    state = state0
    correct = torch.zeros((), dtype=torch.int64, device=dev)
    total = 0
    mesh = None
    for b, yb in zip(batches, labels_batches):
        xin = b[0] if has_raw else b
        xb, mesh = local_view(xin)
        xb = to_device(xb, dev)
        if protocol == "reset":
            state = state0
        adapt = protocol != "conditional" or float(batch_gate_fraction(
            to_device(b[1].gather() if isinstance(b[1], ShardedBatch) else b[1], dev),
            image_entropy_threshold)) > 0.5
        if adapt:
            state, logits = step(state, xb if mesh is None else xin)
            logits = local_view(logits)[0]
        else:
            with torch.no_grad(), batch_mesh(mesh):
                logits = forward(merge_params(state.bn_params, state.frozen_params), xb)
        total += len(yb)
        yb = to_device(yb if mesh is None else shard_images(yb, mesh).shards[0], dev)
        correct += torch.sum(torch.argmax(logits, dim=-1) == yb)
    if mesh is not None:
        dist.all_reduce(correct)
    return int(correct) / max(total, 1)
