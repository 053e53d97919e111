"""Calibration and ranking metrics (PyTorch): ECE, AUROC, AUPR, AURC,
coverage, correlation, Youden thresholds, temperature scaling.

Counterpart of ``imagetransformations_tpu/uq/calibration.py:15-222`` (the
reference's attacks/cifar10-unvertainty/swag/metric.py and
pipeline/metrics/ece.py). Every function takes tensors and returns a
0-dim f32 tensor (or a pair of curves). Sorts are stable, as
``jnp.argsort``'s, so tied scores keep their order as in JAX.

``auroc`` sums its midranks in f64 and rounds the statistic to f32 once:
at n = 10 000 the f32 rank sum passes 2^24, where its rounding would
depend on the summation order and so on the device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from imagetransformations_tpu_torch.core.grids import linspace_f32

F32 = torch.float32


def ece(probs: torch.Tensor, labels: torch.Tensor, n_bins: int = 10) -> torch.Tensor:
    """Expected calibration error over max-prob bins (ece.py:49-61); the
    binning lives in ``calibration_bins``. The bin weights are the counts
    times f32(1 / n), as XLA computes JAX's ``count / n`` (and CUDA's
    division by a scalar does; the CPU's would divide)."""
    count, acc, avg_conf = calibration_bins(probs, labels, n_bins)
    return torch.sum(count * (1.0 / probs.shape[0]) * torch.abs(acc - avg_conf))


def calibration_bins(probs, labels, n_bins: int = 10):
    """Per-bin (count, accuracy, confidence) — swag/metric.py:188-232:
    equal-width (lo, hi] confidence bins, their edges JAX's
    (``linspace_f32``) so that a confidence on an edge falls in the same
    bin as in the JAX package."""
    conf, pred = torch.amax(probs, dim=-1), torch.argmax(probs, dim=-1)
    correct = (pred == labels).to(F32)
    edges = linspace_f32(0.0, 1.0, n_bins + 1, device=probs.device)
    idx = torch.clamp(torch.searchsorted(edges, conf.contiguous(), side="left") - 1,
                      0, n_bins - 1)
    onehot = F.one_hot(idx, n_bins).to(F32)
    count = torch.sum(onehot, dim=0)
    denom = torch.clamp(count, min=1.0)
    acc = torch.sum(onehot * correct[:, None], dim=0) / denom
    avg_conf = torch.sum(onehot * conf[:, None], dim=0) / denom
    return count, acc, avg_conf


def nll(probs: torch.Tensor, labels: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    logp = torch.log(torch.clamp(probs, eps, 1.0))
    return -torch.mean(torch.gather(logp, 1, labels.long()[:, None])[:, 0])


def brier(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    onehot = F.one_hot(labels.long(), probs.shape[-1]).to(probs.dtype)
    return torch.mean(torch.sum((probs - onehot) ** 2, dim=-1))


def accuracy(logits_or_probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.mean((torch.argmax(logits_or_probs, dim=-1) == labels).to(F32))


def _midranks(v: torch.Tensor) -> torch.Tensor:
    """1-based midranks (ties share the mean of their ranks), f32."""
    s = torch.sort(v, stable=True).values
    lo = torch.searchsorted(s, v.contiguous(), side="left").to(F32)
    hi = torch.searchsorted(s, v.contiguous(), side="right").to(F32)
    return (lo + hi + 1.0) / 2.0


def auroc(scores: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """AUC-ROC via the Mann-Whitney U rank statistic (ties -> midranks).

    ``targets`` binary {0,1}; ``scores`` higher = more likely positive.
    Matches sklearn.roc_auc_score (swag/metric.py:493, energy.py:99). The
    rank sum and the statistic are f64, rounded to f32 at the end.
    """
    n = scores.shape[0]
    pos = targets.to(torch.float64)
    n_pos = torch.sum(pos)
    n_neg = n - n_pos
    u = torch.sum(_midranks(scores).to(torch.float64) * pos) - n_pos * (n_pos + 1.0) / 2.0
    return (u / torch.clamp(n_pos * n_neg, min=1.0)).to(F32)


def _order_desc(v: torch.Tensor) -> torch.Tensor:
    """``argsort(-v)``, stable."""
    return torch.argsort(-v, stable=True)


def aupr(scores: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Average precision (area under PR curve, step interpolation)."""
    t = targets[_order_desc(scores)].to(F32)
    tp = torch.cumsum(t, 0)
    k = torch.arange(1, scores.shape[0] + 1, dtype=F32, device=scores.device)
    n_pos = torch.clamp(torch.sum(t), min=1.0)
    return torch.sum(tp / k * t) / n_pos


def risk_coverage_curve(confidence: torch.Tensor, correct: torch.Tensor):
    """(coverage, risk) tensors sweeping a confidence threshold
    (swag/metric.py:356-405, area_under_risk_coverage_curve)."""
    err = 1.0 - correct[_order_desc(confidence)].to(F32)
    n = confidence.shape[0]
    k = torch.arange(1, n + 1, dtype=F32, device=confidence.device)
    return k / n, torch.cumsum(err, 0) / k


def aurc(confidence: torch.Tensor, correct: torch.Tensor) -> torch.Tensor:
    """Area under the risk-coverage curve (lower = better)."""
    return torch.mean(risk_coverage_curve(confidence, correct)[1])


def excess_aurc(confidence: torch.Tensor, correct: torch.Tensor) -> torch.Tensor:
    """AURC minus the optimal-ordering AURC (swag/metric.py:392-405)."""
    return aurc(confidence, correct) - aurc(correct.to(F32), correct)


def coverage_for_accuracy(
    confidence: torch.Tensor,
    correct: torch.Tensor,
    target_acc: float = 0.95,
    start_index: int = 200,
) -> torch.Tensor:
    """Coverage at the FIRST prefix (most-confident-first) whose selective
    accuracy drops below the target, with the reference's ``start_index``
    noise rule (swag/metric.py:407-446): the crossing is searched from
    ``start_index`` on, and falls back to the strict (from-0) crossing when
    that search fires immediately. An accuracy that never drops below the
    target gives coverage 0, as in the reference."""
    c = correct[_order_desc(confidence)].to(F32)
    n = c.shape[0]
    cummean = torch.cumsum(c, 0) / torch.arange(1, n + 1, dtype=F32, device=c.device)
    below = (cummean < target_acc).to(F32)
    strict = torch.argmax(below)
    si = min(int(start_index), max(n - 1, 0))
    nonstrict = torch.argmax(below[si:]) + si
    cov = torch.where(nonstrict > si, nonstrict, strict)
    return cov.to(F32) / n


def area_under_lift_curve(confidence: torch.Tensor, correct: torch.Tensor) -> torch.Tensor:
    """swag/metric.py:268-321: lift of the accuracy in confidence order."""
    c = correct[_order_desc(confidence)].to(F32)
    n = confidence.shape[0]
    k = torch.arange(1, n + 1, dtype=F32, device=c.device)
    base = torch.clamp(torch.mean(c), min=1e-12)
    return torch.mean((torch.cumsum(c, 0) / k) / base) - 1.0


def pearsonr(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    xc = x - torch.mean(x)
    yc = y - torch.mean(y)
    return torch.sum(xc * yc) / torch.clamp(
        torch.sqrt(torch.sum(xc**2) * torch.sum(yc**2)), min=1e-12)


def spearmanr(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Spearman rank correlation with midranks (the JAX package's deliberate
    deviation from swag/metric.py:461-489's ordinal ranks: ties share
    midranks as in scipy, and a constant vector gives 0, not NaN)."""
    return pearsonr(_midranks(x), _midranks(y))


def youden_threshold(scores: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Optimal threshold by Youden's J = TPR - FPR over the ROC sweep
    (analyze_uncertainty_thresholds, cifar_iterative_mc.py:174-219)."""
    order = _order_desc(scores)
    t = targets[order].to(F32)
    n_pos = torch.clamp(torch.sum(t), min=1.0)
    n_neg = torch.clamp(t.shape[0] - torch.sum(t), min=1.0)
    j = torch.cumsum(t, 0) / n_pos - torch.cumsum(1.0 - t, 0) / n_neg
    return scores[order][torch.argmax(j)]


def fit_temperature(
    logits: torch.Tensor,
    labels: torch.Tensor,
    t_init: float = 1.5,
    steps: int = 200,
    lr: float = 0.01,
) -> torch.Tensor:
    """Scalar temperature minimizing the NLL (temperature_scaling.py:33-79):
    full-batch Adam on log T (``torch.optim.Adam``, optax's update), where
    the reference runs L-BFGS on T."""
    log_t = torch.log(torch.tensor(t_init, dtype=F32, device=logits.device))
    log_t.requires_grad_(True)
    opt = torch.optim.Adam([log_t], lr=lr)
    logits = logits.detach()
    idx = labels.long()[:, None]
    for _ in range(steps):
        opt.zero_grad()
        with torch.enable_grad():
            logp = F.log_softmax(logits / torch.exp(log_t), dim=-1)
            loss = -torch.mean(torch.gather(logp, 1, idx))
            loss.backward()
        opt.step()
    return torch.exp(log_t.detach())
