"""SWAG (SWA-Gaussian) posterior (PyTorch).

Counterpart of ``imagetransformations_tpu/uq/swag.py:34-213``, the
reference's SWAGWrapper (attacks/cifar10-unvertainty/swag/swag_wrapper.py):

- ``SwagState`` holds the running SWA mean, the second moment and a
  ``max_rank`` ring buffer of deviations, each a dict keyed by parameter
  name (``named_parameters()``: BatchNorm's weight and bias included, its
  running statistics not, as flax's ``params``).
- ``update`` takes one collection step (update_stats parity,
  swag_wrapper.py:227-266) in place, with the JAX package's formulas:
  ``(m n + p) / (n + 1)``, then ring slot ``n % max_rank`` takes
  ``p - new_mean``.
- ``sample`` draws theta = mean + diag_scale * sigma * z1 + D z2 /
  sqrt(2 max(rank - 1, 1)) (swag_wrapper.py:333-383, the reference's
  scaling: the diagonal is divided by sqrt(2) only with the low-rank half),
  unfilled ring slots masked out of z2. ``generator=`` draws z2 then each
  parameter's z1 in the state's order; ``draws=`` passes them in.
- ``refresh_batch_stats`` re-estimates BatchNorm statistics with training
  forwards (swag_wrapper.py:484-533's train-loader pass); ``bma_logits``
  runs one ``torch.func.functional_call`` a weight sample.

The low-rank product and every forward run in true f32 (``full_f32``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable

import torch
from torch import nn
from torch.func import functional_call

from imagetransformations_tpu_torch.core.image import trig_f32
from imagetransformations_tpu_torch.core.precision import full_f32
from imagetransformations_tpu_torch.core.mesh import ShardedBatch, broadcast_, local_view

Params = dict[str, torch.Tensor]


@dataclasses.dataclass
class SwagState:
    mean: Params
    sq_mean: Params
    deviations: Params  # each [max_rank, *shape]: the ring buffer
    n_models: int
    max_rank: int = 20

    @classmethod
    def from_dict(cls, d: dict) -> "SwagState":
        """The state from ``dataclasses.asdict(state)`` (a checkpoint)."""
        return cls(dict(d["mean"]), dict(d["sq_mean"]), dict(d["deviations"]),
                   int(d["n_models"]), int(d["max_rank"]))


def _params(model_or_params) -> Params:
    if isinstance(model_or_params, nn.Module):
        return {k: p.detach() for k, p in model_or_params.named_parameters()}
    return dict(model_or_params)


def init(model_or_params, max_rank: int = 20) -> SwagState:
    """A state at the given parameters (a module's ``named_parameters()`` or
    a dict of tensors): mean p, second moment p * p, empty ring, n 0."""
    params = _params(model_or_params)
    return SwagState(
        mean={k: p.clone() for k, p in params.items()},
        sq_mean={k: p * p for k, p in params.items()},
        deviations={k: p.new_zeros((max_rank, *p.shape)) for k, p in params.items()},
        n_models=0,
        max_rank=max_rank,
    )


def update(state: SwagState, model_or_params) -> SwagState:
    """One collection step, in place: running moments, then the deviation
    ``p - new_mean`` into ring slot ``n_models % max_rank``. Returns
    ``state``."""
    params = _params(model_or_params)
    any_p = next(iter(params.values()))
    # tensor operands: a CUDA division by a Python number multiplies by its
    # reciprocal, the CPU divides
    n = torch.tensor(float(state.n_models), dtype=any_p.dtype, device=any_p.device)
    m1 = n + 1.0
    with torch.no_grad():
        for k, p in params.items():
            state.mean[k] = (state.mean[k] * n + p) / m1
            state.sq_mean[k] = (state.sq_mean[k] * n + p * p) / m1
            state.deviations[k][state.n_models % state.max_rank] = p - state.mean[k]
    state.n_models += 1
    return state


def _resolve_diag_scale(diag_scale, use_lowrank: bool) -> float:
    """The reference's scaling (swag_wrapper.py:362-374): the diagonal term
    ``std * z`` is divided by sqrt(2) only when the low-rank half is used
    (each half then gives half the posterior variance), unscaled without
    it; an explicit float tempers the diagonal instead."""
    if diag_scale is None:
        diag_scale = 1.0 / math.sqrt(2.0) if use_lowrank else 1.0
    return diag_scale


def _diag_std(sq: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """sqrt(max(sq - mean * mean, 1e-30)) as the JAX package computes it on
    the CPU: the difference rounded once (XLA contracts it into a fused
    multiply-add; here in f64, where the square and the difference are
    exact), the square root correctly rounded (``core.image.trig_f32``).
    The difference cancels (SWAG's variances are tiny against the squares),
    so a separately rounded square moves it by whole percents."""
    var = torch.clamp((sq.double() - mean.double() ** 2).to(sq.dtype), min=1e-30)
    return trig_f32(torch.sqrt, var)


def draw(state: SwagState, generator: torch.Generator | None = None) -> dict:
    """One sample's standard normals from ``generator``: ``{"z_low": [K],
    "z_diag": {name: tensor shaped as the parameter}}``, z_low first."""
    any_p = next(iter(state.mean.values()))
    z_low = torch.randn(state.max_rank, generator=generator, device=any_p.device,
                        dtype=any_p.dtype)
    z_diag = {k: torch.randn(m.shape, generator=generator, device=m.device, dtype=m.dtype)
              for k, m in state.mean.items()}
    return {"z_low": z_low, "z_diag": z_diag}


def sample(
    state: SwagState,
    generator: torch.Generator | None = None,
    diag_scale: float | None = None,
    lowrank_scale: float = 1.0,
    use_lowrank: bool = True,
    draws: dict | None = None,
) -> Params:
    """One weight sample theta from the SWAG posterior, a dict keyed as the
    state; the normals from ``draws`` (as ``draw`` returns them) or else
    drawn from ``generator``."""
    draws = draw(state, generator) if draws is None else draws
    diag_scale = _resolve_diag_scale(diag_scale, use_lowrank)
    rank_eff = min(state.n_models, state.max_rank)
    z_low = draws["z_low"]
    z2 = z_low * (torch.arange(state.max_rank, device=z_low.device) < rank_eff).to(z_low.dtype)
    denom = torch.sqrt(torch.tensor(2.0 * max(rank_eff - 1.0, 1.0), dtype=z_low.dtype,
                                    device=z_low.device))
    out = {}
    with torch.no_grad(), full_f32():
        for k, mean in state.mean.items():
            theta = mean + diag_scale * (_diag_std(state.sq_mean[k], mean) * draws["z_diag"][k])
            if use_lowrank:
                low = torch.tensordot(z2, state.deviations[k], dims=1) / denom
                theta = theta + lowrank_scale * low
            out[k] = theta
    return out


def sample_many(
    state: SwagState,
    num_samples: int,
    generator: torch.Generator | None = None,
    diag_scale: float | None = None,
    lowrank_scale: float = 1.0,
    use_lowrank: bool = True,
    draws: list | None = None,
) -> Params:
    """S samples stacked on a leading axis: ``{name: [S, *shape]}``; sample
    s from ``draws[s]`` where given, else from ``generator`` in turn."""
    samples = [sample(state, generator, diag_scale, lowrank_scale, use_lowrank,
                      None if draws is None else draws[s]) for s in range(int(num_samples))]
    return {k: torch.stack([s[k] for s in samples]) for k in state.mean}


def batch_stats(model: nn.Module) -> Params:
    """The model's buffers (BatchNorm's running statistics) as a dict of
    clones: what ``bma_logits`` and ``refresh_batch_stats`` take."""
    return {k: b.detach().clone() for k, b in model.named_buffers()}


def refresh_batch_stats(model: nn.Module, params: Params, init_batch_stats: Params,
                        batches: Iterable[torch.Tensor]) -> Params:
    """Re-estimate BatchNorm statistics for the weights ``params``: training
    forwards (``model(x, True)``) over ``batches``, each moving the running
    statistics from ``init_batch_stats`` on (the module's own are not
    touched). Returns the new statistics."""
    stats = {k: v.clone() for k, v in init_batch_stats.items()}
    with torch.no_grad():
        for x in batches:
            functional_call(model, {**params, **stats}, (x, True))
    return stats


def bma_logits(model: nn.Module, stacked_params: Params, x,
               batch_stats: Params | None = None) -> torch.Tensor:
    """[S, B, C] logits over S stacked weight samples (swag_wrapper.py:63-96
    returns them as {'logit': [B, S, C]}), evaluation mode, with the
    BatchNorm statistics ``batch_stats`` (default: the model's own).

    ``x`` may be a ``ShardedBatch`` on a process mesh: every rank uses rank
    0's samples and statistics (broadcast into copies, so the caller's
    draws on other ranks do not matter), runs its shard, and gets the whole
    [S, B, C] (``all_gather``)."""
    x, mesh = local_view(x)
    stats = {} if batch_stats is None else batch_stats
    if mesh is not None:
        stacked_params = {k: v.clone() for k, v in stacked_params.items()}
        stats = {k: v.clone() for k, v in (stats or dict(model.named_buffers())).items()}
        broadcast_([*stacked_params.values(), *stats.values()])
    n = next(iter(stacked_params.values())).shape[0]
    with torch.no_grad(), full_f32():
        logits = torch.stack([
            functional_call(model, {**{k: v[s] for k, v in stacked_params.items()}, **stats},
                            (x,))
            for s in range(n)])
    return logits if mesh is None else ShardedBatch((logits,), mesh, dim=1).gather()
