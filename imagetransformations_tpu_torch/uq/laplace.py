"""Last-layer diagonal Laplace approximation (PyTorch; no ``laplace``
package).

Counterpart of ``imagetransformations_tpu/uq/laplace.py:22-73``, after
pipeline/metrics/laplace_metric.py:39-68: a diagonal Gaussian posterior
over the LAST layer's weights (precision = prior + the diagonal GGN summed
over the train set), test samples scored by the predictive variance of
sampled-head probabilities. For a softmax head the GGN diagonal is
  H_diag[w_dc] = sum_n phi_nd^2 * p_nc (1 - p_nc),
one product over the feature batch. The head is in the JAX layout, ``w``
[D, C] (a port model's ``fc.weight.T``). Every product runs in true f32
(``full_f32``).
"""

from __future__ import annotations

import dataclasses

import torch

from imagetransformations_tpu_torch.core.image import trig_f32
from imagetransformations_tpu_torch.core.precision import full_f32


@dataclasses.dataclass
class LaplaceState:
    w_mean: torch.Tensor  # [D, C]
    b_mean: torch.Tensor  # [C]
    w_var: torch.Tensor  # [D, C] posterior variance
    b_var: torch.Tensor  # [C]


def fit(features: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
        prior_precision: float = 1.0) -> LaplaceState:
    """The posterior from the train set's penultimate ``features`` [N, D] and
    the trained head ``w`` [D, C], ``b`` [C]."""
    with torch.no_grad(), full_f32():
        p = torch.softmax(features @ w + b, dim=-1)
        h = p * (1.0 - p)  # [N, C] per-class GGN factor
        w_prec = prior_precision + torch.einsum("nd,nc->dc", features ** 2, h)
        b_prec = prior_precision + torch.sum(h, dim=0)
    return LaplaceState(w, b, 1.0 / w_prec, 1.0 / b_prec)


def predictive(
    state: LaplaceState,
    features: torch.Tensor,
    generator: torch.Generator | None = None,
    num_samples: int = 30,
    draws: tuple[torch.Tensor, torch.Tensor] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean probs [B, C], predictive variance [B]) by weight sampling: the
    standard normals ``draws = (zw [S, D, C], zb [S, C])``, else drawn from
    ``generator`` (zw, then zb)."""
    if draws is None:
        zw = torch.randn((num_samples, *state.w_mean.shape), generator=generator,
                         device=features.device)
        zb = torch.randn((num_samples, *state.b_mean.shape), generator=generator,
                         device=features.device)
    else:
        zw, zb = draws
    with torch.no_grad(), full_f32():
        # correctly rounded square roots, as XLA's (core.image.trig_f32)
        w = state.w_mean + trig_f32(torch.sqrt, state.w_var) * zw  # [S, D, C]
        b = state.b_mean + trig_f32(torch.sqrt, state.b_var) * zb  # [S, C]
        probs = torch.softmax(features @ w + b[:, None, :], dim=-1)  # [S, B, C]
        mean_p = torch.mean(probs, dim=0)
        pred = torch.argmax(mean_p, dim=-1)
        p_cls = torch.gather(probs, 2, pred[None, :, None].expand(probs.shape[0], -1, 1))[..., 0]
        return mean_p, torch.var(p_cls, dim=0, correction=0)


def closed_form_variance(state: LaplaceState, features: torch.Tensor) -> torch.Tensor:
    """Analytic logit variance sum (laplace_metric.py predictive variance)."""
    with torch.no_grad(), full_f32():
        v = torch.einsum("bd,dc->bc", features ** 2, state.w_var) + state.b_var
        return torch.sum(v, dim=-1)
