"""MATTA / VATTA weighted test-time augmentation and the mixing ratio
search (PyTorch).

Counterpart of ``imagetransformations_tpu/adapt/matta.py``
(fall_2025/mata_initial_aaryaa_02.py):

- apply_matta / apply_vatta (:205-214): the views' probabilities mixed by
  learned weights, a matrix over (view, class) for MATTA (softmax over the
  views for each class, then renormalised), one weight a view for VATTA;
- find_optimal_rho (:82-92): the mixing ratio between the original and the
  augmented predictive distributions, by ternary search on a calibration
  criterion (the ECE by default);
- fit_matta_weights: the weights by 200 Adam steps on the NLL (optax's
  Adam, ``adapt._optim``).

Functions of probability tensors run on those tensors' device; every
product and backward in true f32 (``core.precision.full_f32``).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from imagetransformations_tpu_torch.adapt import _optim
from imagetransformations_tpu_torch.core.precision import full_f32
from imagetransformations_tpu_torch.uq.calibration import ece


def apply_vatta(view_probs: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """[V, B, C] probabilities and one weight a view [V] -> mixed [B, C]."""
    with full_f32():
        return torch.einsum("v,vbc->bc", torch.softmax(weights, dim=0), view_probs)


def apply_matta(view_probs: torch.Tensor, weight_matrix: torch.Tensor) -> torch.Tensor:
    """[V, B, C] probabilities and (view, class) weights [V, C] -> mixed
    [B, C], each row renormalised."""
    w = torch.softmax(weight_matrix, dim=0)  # across the views, for each class
    with full_f32():
        mixed = torch.einsum("vc,vbc->bc", w, view_probs)
    return mixed / torch.clamp(torch.sum(mixed, dim=-1, keepdim=True), min=1e-12)


def find_optimal_rho(
    probs_orig: torch.Tensor,
    probs_aug: torch.Tensor,
    labels: torch.Tensor,
    criterion: Callable | None = None,
    iters: int = 20,
) -> float:
    """rho in [0, 1] minimising ``criterion`` (default: the ECE) of
    ``rho * orig + (1 - rho) * aug``, by ``iters`` rounds of ternary search
    (mata_initial_aaryaa_02.py:82-92). The comparisons read the criterion's
    value on the host, so one ulp can send a round the other way."""
    crit = criterion or (lambda p: float(ece(p, labels)))

    def value(r):
        return crit(r * probs_orig + (1.0 - r) * probs_aug)

    lo, hi = 0.0, 1.0
    for _ in range(iters):
        m1 = lo + (hi - lo) / 3
        m2 = hi - (hi - lo) / 3
        if value(m1) < value(m2):
            hi = m2
        else:
            lo = m1
    return (lo + hi) / 2


def fit_matta_weights(
    view_probs: torch.Tensor, labels: torch.Tensor, steps: int = 200, lr: float = 0.05,
    per_class: bool = True,
) -> np.ndarray:
    """MATTA ([V, C]) or VATTA ([V]) weights from zeros by ``steps`` Adam
    steps at ``lr`` on the mixture's NLL (log of the probabilities clipped
    to [1e-12, 1]); returned as numpy f32."""
    v, _, c = view_probs.shape
    mix = apply_matta if per_class else apply_vatta
    idx = labels.long()[:, None]
    params = {"w": torch.zeros((v, c) if per_class else (v,), device=view_probs.device)}
    state = _optim.adam_init(params)
    for _ in range(int(steps)):
        w = params["w"].requires_grad_(True)
        with full_f32(), torch.enable_grad():
            lp = torch.log(torch.clamp(mix(view_probs, w), 1e-12, 1.0))
            (g,) = torch.autograd.grad(-torch.mean(torch.gather(lp, 1, idx)), w)
        updates, state = _optim.adam_update({"w": g}, state, lr)
        with torch.no_grad():
            params = _optim.apply_updates({"w": w.detach()}, updates)
    return params["w"].cpu().numpy()
