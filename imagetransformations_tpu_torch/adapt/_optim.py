"""optax's update rules for the adaptation loops (PyTorch).

The JAX package fits TENT's BatchNorm parameters with
``optax.chain(optax.clip_by_global_norm(1.0), optax.adam(lr))`` and the
MATTA and ensemble-temperature weights with ``optax.adam``. These are the
same rules on dicts of tensors, in optax's order of operations:

- ``clip_by_global_norm``: keep the gradients when their global norm is
  below ``max_norm``, else ``g / norm * max_norm`` (``torch.nn.utils.
  clip_grad_norm_`` scales by ``max_norm / (norm + 1e-6)`` instead);
- ``adam_update``: ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g² + b2
  nu``, the bias corrections ``1 - b^count`` in f32, the update
  ``-lr * mu_hat / (sqrt(nu_hat) + eps)``, added to the parameters by
  ``apply_updates``.

What remains apart from optax is the summation order of the norm and of
XLA's fused arithmetic; the tests measure it.
"""

from __future__ import annotations

import dataclasses

import torch

Params = dict[str, torch.Tensor]


@dataclasses.dataclass
class AdamState:
    """optax's ``ScaleByAdamState``: the step count and the two moments."""

    count: int
    mu: Params
    nu: Params


def adam_init(params: Params) -> AdamState:
    return AdamState(0, {k: torch.zeros_like(v) for k, v in params.items()},
                     {k: torch.zeros_like(v) for k, v in params.items()})


def _bias_correction(decay: float, count: int, device) -> torch.Tensor:
    """``1 - decay ** count`` in f32, as optax computes it, made on
    ``device``: a divisor on the host would be a CPU scalar, which CUDA's
    division replaces by a multiplication with its reciprocal."""
    return 1.0 - torch.full((), decay, dtype=torch.float32, device=device) ** count


def adam_update(grads: Params, state: AdamState, lr: float, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8) -> tuple[Params, AdamState]:
    """``optax.adam(lr).update``: (updates to add, new state)."""
    mu = {k: (1.0 - b1) * g + b1 * state.mu[k] for k, g in grads.items()}
    nu = {k: (1.0 - b2) * (g * g) + b2 * state.nu[k] for k, g in grads.items()}
    count = state.count + 1
    dev = next(iter(grads.values())).device
    c1, c2 = _bias_correction(b1, count, dev), _bias_correction(b2, count, dev)
    updates = {k: (-lr) * ((m / c1) / (torch.sqrt(nu[k] / c2) + eps)) for k, m in mu.items()}
    return updates, AdamState(count, mu, nu)


def clip_by_global_norm(grads: Params, max_norm: float) -> Params:
    """``optax.clip_by_global_norm(max_norm)``: the global norm is the root
    of the sum over tensors of each one's sum of squares."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    keep = norm < max_norm
    return {k: torch.where(keep, g, (g / norm) * max_norm) for k, g in grads.items()}


def apply_updates(params: Params, updates: Params) -> Params:
    return {k: p + updates[k] for k, p in params.items()}
