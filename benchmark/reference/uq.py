"""The sweep's scores in plain PyTorch: the logit metrics, ODIN, the
Mahalanobis distance and the error-detection AUROC. Frozen copies of the
port's ``uq/metrics.py``, ``uq/odin.py``, ``uq/mahalanobis.py`` (the
class-agnostic fit) and ``uq/calibration.auroc``; the formulas are the
reference's (FINAL_cifar_corrupted.py:69-114, uncertainty_metrics.py:69-94,
pipeline/metrics/mahalanobis.py:32-80).

Every product runs in the precision the caller's TF32 flags set: the
reference sets them off, the control on."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

F32 = torch.float32


def shannon_entropy(logits: torch.Tensor) -> torch.Tensor:
    """Predictive entropy in bits."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.sum(torch.exp(logp) * logp, dim=-1) / math.log(2.0)


def msp(logits: torch.Tensor) -> torch.Tensor:
    return torch.max(torch.softmax(logits, dim=-1), dim=-1).values


def margin(logits: torch.Tensor) -> torch.Tensor:
    top = torch.topk(torch.softmax(logits, dim=-1), 2, dim=-1).values
    return top[..., 0] - top[..., 1]


def energy(logits: torch.Tensor) -> torch.Tensor:
    return -torch.logsumexp(logits, dim=-1)


METRICS = {"shannon_entropy": shannon_entropy, "msp": msp, "margin": margin, "energy": energy}
#: higher means more confident: negated for error detection
CONFIDENCE = {"msp", "margin"}


def odin_uncertainty(model_fn, x: torch.Tensor, temperature: float, eps: float) -> torch.Tensor:
    """1 - ODIN's score: one signed-gradient step on the input that raises
    the max softmax at ``temperature``, then the max softmax there."""
    leaf = x.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = -torch.sum(torch.amax(F.log_softmax(model_fn(leaf) / temperature, dim=-1), dim=-1))
        (g,) = torch.autograd.grad(loss, leaf)
    with torch.no_grad():
        logits = model_fn(x.detach() - eps * torch.sign(g)) / temperature
        return 1.0 - torch.amax(torch.softmax(logits, dim=-1), dim=-1)


def mahalanobis_fit(features: torch.Tensor, ridge: float = 1e-4):
    """(mean [D], precision [D, D]): the features' mean and the
    pseudo-inverse of their covariance plus a ridge (singular values below
    10 * max(m, n) * eps of the largest dropped, as ``jnp.linalg.pinv``)."""
    feats = features.to(F32)
    n, d = feats.shape
    mean = torch.mean(feats, dim=0)
    centered = feats - mean
    cov = centered.T @ centered / (n - 1)
    a = cov + ridge * torch.eye(d, device=feats.device)
    return mean, torch.linalg.pinv(a, rtol=10.0 * max(a.shape) * torch.finfo(F32).eps)


def mahalanobis_score(mean: torch.Tensor, precision: torch.Tensor,
                      features: torch.Tensor) -> torch.Tensor:
    c = features.to(F32) - mean
    q = torch.sum((c @ precision) * c, dim=-1)
    return torch.sqrt(torch.clamp(q, min=0.0))


def _midranks(v: torch.Tensor) -> torch.Tensor:
    """1-based midranks (ties share the mean of their ranks), f32."""
    s = torch.sort(v, stable=True).values
    lo = torch.searchsorted(s, v.contiguous(), side="left").to(F32)
    hi = torch.searchsorted(s, v.contiguous(), side="right").to(F32)
    return (lo + hi + 1.0) / 2.0


def auroc(scores: torch.Tensor, targets: torch.Tensor) -> float:
    """AUC-ROC by the Mann-Whitney U statistic (ties: midranks), the rank
    sum in f64, rounded to f32 at the end, as sklearn's roc_auc_score."""
    n = scores.shape[0]
    pos = targets.to(torch.float64)
    n_pos = torch.sum(pos)
    n_neg = n - n_pos
    u = torch.sum(_midranks(scores).to(torch.float64) * pos) - n_pos * (n_pos + 1.0) / 2.0
    return float((u / torch.clamp(n_pos * n_neg, min=1.0)).to(F32))
