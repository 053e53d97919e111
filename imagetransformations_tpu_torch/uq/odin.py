"""ODIN and Generalized-ODIN: temperature scaling with input preprocessing
(PyTorch).

Counterpart of ``imagetransformations_tpu/uq/odin.py:21-60``:
- attacks/uncertainty/uncertainty_metrics.py:69-94 (calculate_odin) and
  cifar_odin_uncertin.py:175-176 — T=1000, eps=0.0014: one signed-gradient
  step that INCREASES the max softmax score, then rescored at temperature T;
- fall_2025/generalizedOdin2.py:29-56 — the eps* grid search maximizing the
  mean MSP.

The input gradient is one ``torch.autograd.grad`` over the batch
(``core.precision.input_gradient``: on a leaf copy of ``x``, the forward
and the backward inside ``full_f32``: cuDNN's convolution backward reads
the TF32 flag when it runs, not when the graph was built).
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from imagetransformations_tpu_torch.core.precision import input_gradient


def odin_score(
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    temperature: float = 1000.0,
    eps: float = 0.0014,
) -> torch.Tensor:
    """ODIN max-softmax score after input preprocessing -> [B] (higher=ID)."""
    g = _input_gradient(model_fn, x, temperature)
    with torch.no_grad():
        logits = model_fn(x.detach() - eps * torch.sign(g)) / temperature
        return torch.amax(torch.softmax(logits, dim=-1), dim=-1)


def _input_gradient(
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    temperature: float = 1000.0,
) -> torch.Tensor:
    """d(-sum of the batch's max log-softmax at ``temperature``) / d x: the
    gradient whose sign ODIN steps against."""
    return input_gradient(lambda xb: -torch.sum(torch.amax(
        F.log_softmax(model_fn(xb) / temperature, dim=-1), dim=-1)), x)


def odin_uncertainty(model_fn, x, temperature: float = 1000.0, eps: float = 0.0014):
    """1 - ODIN score (higher = more uncertain)."""
    return 1.0 - odin_score(model_fn, x, temperature, eps)


def generalized_odin_search(
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    x_val: torch.Tensor,
    eps_grid=(0.0025, 0.005, 0.01, 0.02, 0.04, 0.08),
    temperature: float = 1000.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pick eps* maximizing the mean perturbed MSP on validation data.

    Returns (eps_star, mean_scores_per_eps) (generalizedOdin2.py:29-56)."""
    eps_arr = torch.tensor(eps_grid, dtype=torch.float32)
    scores = torch.stack([torch.mean(odin_score(model_fn, x_val, temperature, float(e)))
                          for e in eps_arr])
    return eps_arr[torch.argmax(scores.cpu())], scores
