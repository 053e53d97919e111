"""Reverse-FGSM input refinement (PyTorch).

Counterpart of ``imagetransformations_tpu/adapt/refine.py:25-138``. Parity
map (reference -> here):
- pipeline/cifar_iterative_mc.py:24-35   -> logit_margin_loss
- pipeline/cifar_iterative_mc.py:351-356 -> one reverse step
  x <- clip(x - eps * sign(grad))
- pipeline/cifar_iterative_mc.py:358-440 -> refine_batch: <= 10 iterations
  per flagged sample until MSP >= 0.998 (the reference loops over single
  images; here every flagged sample steps at once under a per-sample active
  mask)
- pipenline/cifar_gradient_newloss.py:12-46 -> negative_class_loss /
  pseudo_label_loss / logit_consistency_loss (unsupervised variants)
- pipenline/cifar100_shannon.py:54-78 -> entropy_loss refinement

The JAX ``while_loop`` is a Python loop with one host read a step (are any
samples still active?). Every input gradient runs forward and backward in
true f32 (``core.precision.input_gradient``). ``model_fn`` maps model
space (the port's NCHW) to logits.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from imagetransformations_tpu_torch.core.precision import input_gradient


def _picked(logp: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return torch.gather(logp, 1, labels.long()[:, None])[:, 0]


def _margin_per_sample(logits: torch.Tensor, labels: torch.Tensor,
                       margin: float = 10.0) -> torch.Tensor:
    true_logit = _picked(logits, labels)
    masked = logits - 1e9 * F.one_hot(labels.long(), logits.shape[-1]).to(logits.dtype)
    return torch.relu(margin - (true_logit - torch.amax(masked, dim=-1)))


def logit_margin_loss(logits: torch.Tensor, labels: torch.Tensor,
                      margin: float = 10.0) -> torch.Tensor:
    """Hinge on the true-class logit margin (cifar_iterative_mc.py:24-35)."""
    return torch.mean(_margin_per_sample(logits, labels, margin))


def _entropy_per_sample(logits: torch.Tensor) -> torch.Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)


def entropy_loss(logits: torch.Tensor) -> torch.Tensor:
    """Mean predictive entropy (cifar100_shannon.py:54-60)."""
    return torch.mean(_entropy_per_sample(logits))


def negative_class_loss(logits: torch.Tensor, avoid_labels: torch.Tensor,
                        generator: torch.Generator | None = None,
                        offset: torch.Tensor | None = None) -> torch.Tensor:
    """CE toward a random class other than ``avoid_labels``
    (cifar_gradient_newloss.py:12-33): target = (avoid + offset) mod C,
    ``offset`` in [1, C) shaped as ``avoid_labels``, else drawn from
    ``generator``."""
    c = logits.shape[-1]
    if offset is None:
        offset = torch.randint(1, c, avoid_labels.shape, generator=generator,
                               device=logits.device)
    target = torch.remainder(avoid_labels.long() + offset.long(), c)
    return -torch.mean(_picked(F.log_softmax(logits, dim=-1), target))


def pseudo_label_loss(logits: torch.Tensor) -> torch.Tensor:
    """CE toward the model's own argmax (cifar_gradient_newloss.py:34)."""
    return -torch.mean(_picked(F.log_softmax(logits, dim=-1), torch.argmax(logits, dim=-1)))


def logit_consistency_loss(logits: torch.Tensor, ref_logits: torch.Tensor) -> torch.Tensor:
    """MSE to the initial logits (cifar_gradient_newloss.py:37-46)."""
    return torch.mean((logits - ref_logits) ** 2)


def _msp(logits: torch.Tensor) -> torch.Tensor:
    return torch.amax(torch.softmax(logits, dim=-1), dim=-1)


def _where_rows(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(mask.reshape(-1, *([1] * (a.ndim - 1))), a, b)


def refine_batch(
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    x: torch.Tensor,
    flagged: torch.Tensor,
    *,
    loss_kind: str = "logit_margin",
    max_iters: int = 10,
    eps: float = 0.03,
    msp_stop: float = 0.998,
    clip_min: float = 0.0,
    clip_max: float = 1.0,
) -> tuple[torch.Tensor, int]:
    """Refine flagged inputs by iterative reverse FGSM until MSP >= msp_stop.

    x: [B, ...] model-space inputs; flagged: [B] bool. The targets are the
    model's initial predictions (the reference refines toward its own
    prediction, cifar_iterative_mc.py:380-386). A sample is active while it
    is flagged and its MSP is below ``msp_stop``; each iteration steps the
    active samples alone (``loss_kind``: "logit_margin", "entropy" or
    "pseudo_label", summed over the batch) and re-scores their MSP. Returns
    (x_refined, iterations run)."""
    per_sample = {
        "logit_margin": lambda lg: _margin_per_sample(lg, labels),
        "entropy": _entropy_per_sample,
        "pseudo_label": lambda lg: -_picked(F.log_softmax(lg, dim=-1), torch.argmax(lg, -1)),
    }
    if loss_kind not in per_sample:
        raise ValueError(loss_kind)
    loss_of = per_sample[loss_kind]
    xc = x.detach()
    with torch.no_grad():
        init_logits = model_fn(xc)
    labels = torch.argmax(init_logits, dim=-1)
    active = flagged.bool() & (_msp(init_logits) < msp_stop)
    it = 0
    while it < max_iters and bool(active.any()):
        g = input_gradient(lambda xb: torch.sum(loss_of(model_fn(xb))), xc)
        step = torch.clamp(xc - eps * torch.sign(g), clip_min, clip_max)
        xc = _where_rows(active, step, xc)
        with torch.no_grad():
            active = active & (_msp(model_fn(xc)) < msp_stop)
        it += 1
    return xc, it


def single_step_refine(model_fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                       flagged: torch.Tensor, eps: float = 0.03) -> torch.Tensor:
    """One reverse-FGSM step on the flagged samples alone, toward the model's
    own prediction (pipenline/cifar_gradient_transformations.py:75-157)."""
    x = x.detach()
    with torch.no_grad():
        labels = torch.argmax(model_fn(x), dim=-1)
    g = input_gradient(lambda xb: -torch.mean(_picked(F.log_softmax(model_fn(xb), dim=-1),
                                                   labels)), x)
    return _where_rows(flagged.bool(), torch.clamp(x - eps * torch.sign(g), 0.0, 1.0), x)
