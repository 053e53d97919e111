"""Monte-Carlo sampling uncertainty: MC dropout, BALD, layer uncertainty,
ensembles (PyTorch).

Counterpart of ``imagetransformations_tpu/uq/mc.py:21-107``. Parity:
- mutual_info.py:35-88 — dropout p=0.5 after activations, T=50, MI = BALD
- cifar_iterative_mc.py:20,41-78 — T=50 predictive entropy; layer uncertainty
  = feature variance across stochastic forward passes
- ensemble.py:49-123 — deep-ensemble variance of the predicted-class prob

The JAX package vmaps the T passes over split keys; here they are a loop
of T forwards that draw in turn from one ``torch.Generator``, in the
caller's gradient mode (wrap them in ``torch.no_grad()`` to keep no
graph). The reductions clip ``p`` at 1e-12 and take population variances
(``correction=0``), as ``jnp.var``.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

from imagetransformations_tpu_torch.uq.metrics import probs_of


def mc_sample_logits(
    stochastic_fn: Callable[[torch.Generator | None, torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    generator: torch.Generator | None = None,
    num_samples: int = 50,
) -> torch.Tensor:
    """Stack T stochastic forward passes -> [T, B, C] logits.

    ``stochastic_fn(generator, x)`` is any randomized forward (a dropout
    mask, a BNN weight sample, a SWAG draw, ...) drawing from
    ``generator``."""
    return torch.stack([stochastic_fn(generator, x) for _ in range(num_samples)])


def dropout_fn(model) -> Callable[[torch.Generator | None, torch.Tensor], torch.Tensor]:
    """A model's MC-dropout forward: ``fn(generator, x) = model(x, mc=True,
    generator=generator)`` (the CIFAR ResNets' dropout after each block, at
    the model's ``dropout_rate``; the JAX ``dropout_fn``'s ``rate`` argument
    is unused there too)."""

    def fn(generator, x):
        return model(x, mc=True, generator=generator)

    return fn


def _entropy(p: torch.Tensor, base2: bool) -> torch.Tensor:
    logp = torch.log(torch.clamp(p, 1e-12, 1.0))
    ent = -torch.sum(p * logp, dim=-1)
    return ent / math.log(2.0) if base2 else ent


def predictive_entropy(mc_logits: torch.Tensor, base2: bool = True) -> torch.Tensor:
    """H[ mean_t p_t ]  -> [B]."""
    return _entropy(torch.mean(probs_of(mc_logits), dim=0), base2)


def expected_entropy(mc_logits: torch.Tensor, base2: bool = True) -> torch.Tensor:
    """mean_t H[p_t]  -> [B]."""
    return torch.mean(_entropy(probs_of(mc_logits), base2), dim=0)


def bald(mc_logits: torch.Tensor, base2: bool = True) -> torch.Tensor:
    """Mutual information = predictive - expected entropy (mutual_info.py:78-88)."""
    return predictive_entropy(mc_logits, base2) - expected_entropy(mc_logits, base2)


def mc_variance(mc_logits: torch.Tensor) -> torch.Tensor:
    """Variance of the BMA-predicted-class probability across samples
    (cifar_swag.py:216-241 'expected variance' / ensemble.py:109-123)."""
    p = probs_of(mc_logits)  # [T, B, C]
    pred = torch.argmax(torch.mean(p, dim=0), dim=-1)  # [B]
    p_cls = torch.gather(p, 2, pred[None, :, None].expand(p.shape[0], -1, 1))[..., 0]
    return torch.var(p_cls, dim=0, correction=0)


def jensen_shannon(mc_logits: torch.Tensor) -> torch.Tensor:
    """Generalized JSD across samples == BALD in nats (cifar_swag.py:231)."""
    return bald(mc_logits, base2=False)


def layer_uncertainty(mc_features: torch.Tensor) -> torch.Tensor:
    """Mean feature variance across stochastic passes (cifar_iterative_mc.py:41-78).

    mc_features: [T, B, D] penultimate features -> [B]."""
    return torch.mean(torch.var(mc_features, dim=0, correction=0), dim=-1)


def ensemble_logits(members: Sequence[Callable[[torch.Tensor], torch.Tensor]],
                    x: torch.Tensor) -> torch.Tensor:
    """Stack member logits [M, B, C] (``members``: modules or forwards)."""
    return torch.stack([m(x) for m in members])
