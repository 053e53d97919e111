"""Uncertainty scores over [B, C] logits (PyTorch); higher = more uncertain
unless noted.

Counterpart of ``imagetransformations_tpu/uq/metrics.py:25-168``. Parity
map (reference -> here):
- shannon_entropy.py:53            -> shannon_entropy (log2)
- attacks/uncertainty/FINAL_cifar_corrupted.py:69-114
                                   -> msp/least_confidence/margin/ratio/
                                      doctor_alpha/doctor_beta/max_logit/energy
- pipeline/metrics/energy.py:36    -> energy_score (-logsumexp)
- pipeline/metrics/trellis_rey.py:25-31 -> tsallis_entropy / renyi_entropy
- pipeline/metrics/nll.py:10-76    -> nll_per_sample
- swag/metric.py:323               -> dempster_shafer
- pipeline/metrics/decision_change.py:27-58 -> decision_change
- pipeline/metrics/gradient_based.py:33-69  -> gradient_uncertainty

The two model-in-the-loop scores draw their Gaussian perturbation from a
``torch.Generator`` (``generator=``) where the JAX functions take a key.
``gradient_uncertainty``'s backward runs in true f32 (``full_f32``), as the
models' forwards do.
"""

from __future__ import annotations

import math
from typing import Callable

import torch
import torch.nn.functional as F

from imagetransformations_tpu_torch.core.precision import input_gradient


def probs_of(logits: torch.Tensor) -> torch.Tensor:
    return torch.softmax(logits, dim=-1)


def shannon_entropy(logits: torch.Tensor, base2: bool = True) -> torch.Tensor:
    """Predictive entropy -sum p log p (log2 per the reference)."""
    logp = F.log_softmax(logits, dim=-1)
    ent = -torch.sum(torch.exp(logp) * logp, dim=-1)
    return ent / math.log(2.0) if base2 else ent


def msp(logits: torch.Tensor) -> torch.Tensor:
    """Max softmax probability (higher = more confident)."""
    return torch.max(probs_of(logits), dim=-1).values


def least_confidence(logits: torch.Tensor) -> torch.Tensor:
    return 1.0 - msp(logits)


def _top2(p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    top = torch.topk(p, 2, dim=-1).values
    return top[..., 0], top[..., 1]


def margin(logits: torch.Tensor) -> torch.Tensor:
    """top1 - top2 prob (higher = more confident)."""
    p1, p2 = _top2(probs_of(logits))
    return p1 - p2


def ratio(logits: torch.Tensor) -> torch.Tensor:
    """top2 / top1 prob (higher = more uncertain)."""
    p1, p2 = _top2(probs_of(logits))
    return p2 / p1


def max_logit(logits: torch.Tensor) -> torch.Tensor:
    """Max raw logit (higher = more confident)."""
    return torch.max(logits, dim=-1).values


def energy_score(logits: torch.Tensor) -> torch.Tensor:
    """-logsumexp(logits); higher (closer to 0) = more uncertain."""
    return -torch.logsumexp(logits, dim=-1)


def doctor_alpha(logits: torch.Tensor) -> torch.Tensor:
    """(1 - g) / g with g = sum p^2 (Doctor alpha)."""
    g = torch.sum(probs_of(logits) ** 2, dim=-1)
    return (1.0 - g) / g


def doctor_beta(logits: torch.Tensor) -> torch.Tensor:
    """(1 - pmax) / pmax (Doctor beta)."""
    pmax = msp(logits)
    return (1.0 - pmax) / pmax


def tsallis_entropy(logits: torch.Tensor, q: float = 1.5) -> torch.Tensor:
    """(1 - sum p^q) / (q - 1)   (trellis_rey.py:25-27)."""
    p = probs_of(logits)
    return (1.0 - torch.sum(p**q, dim=-1)) / (q - 1.0)


def renyi_entropy(logits: torch.Tensor, alpha: float = 1.5) -> torch.Tensor:
    """log(sum p^a) / (1 - a)   (trellis_rey.py:29-31)."""
    p = probs_of(logits)
    return torch.log(torch.sum(p**alpha, dim=-1)) / (1.0 - alpha)


def dempster_shafer(logits: torch.Tensor) -> torch.Tensor:
    """K / (K + sum exp(logit))  (swag/metric.py:323)."""
    k = logits.shape[-1]
    return k / (k + torch.sum(torch.exp(logits), dim=-1))


def nll_per_sample(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample negative log likelihood of the true class."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def brier_score(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample multiclass Brier score (swag/metric.py:160-186)."""
    p = probs_of(logits)
    onehot = F.one_hot(labels.long(), logits.shape[-1]).to(p.dtype)
    return torch.sum((p - onehot) ** 2, dim=-1)


# --------------------------------------------------------- model-in-the-loop


def _perturbed(x: torch.Tensor, generator: torch.Generator | None, eps: float) -> torch.Tensor:
    noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    return x + eps * noise


def decision_change(
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    generator: torch.Generator | None = None,
    eps: float = 0.01,
) -> torch.Tensor:
    """1 - MSP on a Gaussian-perturbed input (decision_change.py:27-58)."""
    with torch.no_grad():
        return least_confidence(model_fn(_perturbed(x, generator, eps)))


def gradient_uncertainty(
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    generator: torch.Generator | None = None,
    eps: float = 0.01,
) -> torch.Tensor:
    """L2 norm of d MSE(logits(x'), logits(x)) / d x' at the perturbed input
    x' (gradient_based.py:33-69): one backward for the batch. The sum of the
    per-sample losses has each sample's gradient in its own row, since the
    models treat samples independently in evaluation mode."""
    with torch.no_grad():
        clean = model_fn(x)
    grads = input_gradient(
        lambda xb: torch.sum(torch.mean((model_fn(xb) - clean) ** 2, dim=-1)),
        _perturbed(x, generator, eps))
    return torch.sqrt(torch.sum(grads.reshape(grads.shape[0], -1) ** 2, dim=-1))


#: registry used by the evaluation sweep harness (FINAL_cifar_corrupted parity)
LOGIT_METRICS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "shannon_entropy": shannon_entropy,
    "msp": msp,
    "least_confidence": least_confidence,
    "margin": margin,
    "ratio": ratio,
    "max_logit": max_logit,
    "energy": energy_score,
    "doctor_alpha": doctor_alpha,
    "doctor_beta": doctor_beta,
    "tsallis": tsallis_entropy,
    "renyi": renyi_entropy,
    "dempster_shafer": dempster_shafer,
}

#: metrics where HIGHER means MORE CONFIDENT (flip for error-detection AUC)
CONFIDENCE_METRICS = {"msp", "margin", "max_logit"}
