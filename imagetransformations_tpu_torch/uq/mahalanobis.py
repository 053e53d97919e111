"""Mahalanobis-distance uncertainty on penultimate features (PyTorch).

Counterpart of ``imagetransformations_tpu/uq/mahalanobis.py:23-73``:
- pipeline/metrics/mahalanobis.py:32-80 — class-agnostic: train-feature mean
  and the pseudo-inverse of the covariance (+1e-4 ridge), a per-sample
  quadratic form;
- pipeline/cifar_iterative_mc.py:80-149 — per-class means with a shared
  covariance, the minimum over classes.

The quadratic form is a batched product in true f32 (``full_f32``): the
JAX package asks for ``Precision.HIGHEST`` there, since the AUROC that
consumes these scores moved by +0.004 to +0.008 without it (fac138c).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from imagetransformations_tpu_torch.core.precision import full_f32


@dataclasses.dataclass
class MahalanobisState:
    mean: torch.Tensor  # [D] or [K, D]
    precision: torch.Tensor  # [D, D]
    per_class: bool = False


def _pinv(a: torch.Tensor) -> torch.Tensor:
    """``jnp.linalg.pinv``: singular values below 10 * max(m, n) * eps of the
    largest are dropped."""
    rtol = 10.0 * max(a.shape) * torch.finfo(a.dtype).eps
    return torch.linalg.pinv(a, rtol=rtol)


def fit(features: torch.Tensor, labels: torch.Tensor | None = None,
        num_classes: int | None = None, ridge: float = 1e-4) -> MahalanobisState:
    """Mean(s) and inverse covariance of train features [N, D].

    labels None -> class-agnostic (mahalanobis.py); with labels -> per-class
    means and a tied covariance (cifar_iterative_mc.py:80-119)."""
    feats = features.to(torch.float32)
    n, d = feats.shape
    eye = torch.eye(d, device=feats.device)
    with full_f32():
        if labels is None:
            mean = torch.mean(feats, dim=0)
            centered = feats - mean
            cov = centered.T @ centered / (n - 1)
            return MahalanobisState(mean, _pinv(cov + ridge * eye), per_class=False)
        labels = labels.long()
        k = int(num_classes or int(labels.max()) + 1)
        onehot = F.one_hot(labels, k).to(torch.float32)  # [N, K]
        counts = torch.clamp(torch.sum(onehot, dim=0), min=1.0)
        means = (onehot.T @ feats) / counts[:, None]  # [K, D]
        centered = feats - means[labels]
        cov = centered.T @ centered / (n - k)
        return MahalanobisState(means, _pinv(cov + ridge * eye), per_class=True)


def score(state: MahalanobisState, features: torch.Tensor) -> torch.Tensor:
    """Mahalanobis distance per sample -> [B] (higher = more OOD /
    uncertain); per class, the least distance over the classes."""
    f = features.to(torch.float32)
    with full_f32():
        if not state.per_class:
            c = f - state.mean
            q = torch.sum((c @ state.precision) * c, dim=-1)
        else:
            diffs = f[:, None, :] - state.mean[None, :, :]  # [B, K, D]
            q = torch.amin(torch.sum((diffs @ state.precision) * diffs, dim=-1), dim=1)
    return torch.sqrt(torch.clamp(q, min=0.0))
