"""Prediction-flip analysis, failure-prediction heads and symbolic rules
(PyTorch).

Counterpart of ``imagetransformations_tpu/evalx/analysis.py:24-121``:
- fall_2025/tent_finalanalysis.py:120-227 (compute_flip_analysis) ->
  ``flip_analysis``: which predictions an intervention flips correct <->
  incorrect.
- fall_2025/shannonentropy_fullclassifiers.py -> ``FailureHead``: a small
  MLP on {entropy, margin, msp, energy} (+ penultimate features) trained to
  predict misclassification, with ``torch.optim.Adam`` (optax's ``adam`` at
  the same eps) on optax's sigmoid cross-entropy.
- fall_2025/2026shannon_symbollic.py:75-89 -> ``superclass_confusion_rule``:
  flag a sample when its top-k classes span several superclasses.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from imagetransformations_tpu_torch.core.precision import full_f32
from imagetransformations_tpu_torch.uq.knn import top_k_indices


def flip_analysis(logits_before: torch.Tensor, logits_after: torch.Tensor,
                  labels: torch.Tensor) -> dict:
    """Count the prediction flips an intervention induces."""
    p0 = torch.argmax(logits_before, dim=-1)
    p1 = torch.argmax(logits_after, dim=-1)
    c0, c1 = p0 == labels, p1 == labels
    return {
        "n": int(labels.shape[0]),
        "acc_before": float(torch.mean(c0.to(torch.float32))),
        "acc_after": float(torch.mean(c1.to(torch.float32))),
        "fixed": int(torch.sum(~c0 & c1)),  # incorrect -> correct
        "broken": int(torch.sum(c0 & ~c1)),  # correct -> incorrect
        "changed": int(torch.sum(p0 != p1)),
        "stable_correct": int(torch.sum(c0 & c1)),
        "stable_incorrect": int(torch.sum(~c0 & ~c1)),
    }


def _sigmoid_bce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """optax.sigmoid_binary_cross_entropy, term for term."""
    return -labels * F.logsigmoid(logits) - (1.0 - labels) * F.logsigmoid(-logits)


class FailureHead:
    """MLP predicting P(misclassified) from uncertainty features.

    Features per sample: [entropy, margin, msp, energy] (+ optional
    penultimate features), standardized; ``fit`` runs full-batch Adam."""

    def __init__(self, hidden: int = 32, seed: int = 0):
        self.hidden = hidden
        self.seed = seed
        self.params = None

    @staticmethod
    def features_from_logits(logits: torch.Tensor, extra: torch.Tensor | None = None):
        from imagetransformations_tpu_torch.uq import metrics as um

        feats = torch.stack([um.shannon_entropy(logits), um.margin(logits), um.msp(logits),
                             um.energy_score(logits)], dim=-1)
        if extra is not None:
            feats = torch.cat([feats, extra], dim=-1)
        mu = torch.mean(feats, 0, keepdim=True)
        sd = torch.std(feats, 0, keepdim=True, correction=0) + 1e-6
        return (feats - mu) / sd

    @staticmethod
    def _forward(p: dict, f: torch.Tensor) -> torch.Tensor:
        h = torch.relu(f @ p["w1"] + p["b1"])
        return (h @ p["w2"] + p["b2"])[:, 0]

    def fit(self, feats: torch.Tensor, failed: torch.Tensor, steps: int = 500,
            lr: float = 1e-2, init: tuple | None = None) -> "FailureHead":
        """Train on ``feats`` [N, d] against ``failed`` [N]. ``init = (w1
        [d, hidden], w2 [hidden, 1])``, arrays or tensors, before the 0.3
        scale; else standard normals from a generator seeded with
        ``seed`` (w1 then w2). Biases start at 0."""
        d, dev = feats.shape[-1], feats.device
        if init is None:
            g = torch.Generator(device=dev).manual_seed(self.seed)
            init = (torch.randn((d, self.hidden), generator=g, device=dev),
                    torch.randn((self.hidden, 1), generator=g, device=dev))
        w1, w2 = (torch.as_tensor(w, dtype=torch.float32).to(dev) for w in init)
        params = {"w1": w1 * 0.3, "b1": torch.zeros(self.hidden, device=dev),
                  "w2": w2 * 0.3, "b2": torch.zeros(1, device=dev)}
        params = {k: v.requires_grad_(True) for k, v in params.items()}
        y = failed.to(torch.float32)
        opt = torch.optim.Adam(params.values(), lr=lr, eps=1e-8)
        with full_f32(), torch.enable_grad():
            for _ in range(steps):
                opt.zero_grad(set_to_none=True)
                torch.mean(_sigmoid_bce(self._forward(params, feats), y)).backward()
                opt.step()
        self.params = {k: v.detach() for k, v in params.items()}
        return self

    def predict_proba(self, feats: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), full_f32():
            return torch.sigmoid(self._forward(self.params, feats))


def superclass_confusion_rule(logits: torch.Tensor, class_to_super: torch.Tensor,
                              k: int = 3) -> torch.Tensor:
    """True where the top-k classes span more than one superclass (the
    symbolic unreliability rule, 2026shannon_symbollic.py:75-89);
    ``class_to_super``: [C] int. The top k is ``lax.top_k``'s set
    (``uq.knn.top_k_indices``)."""
    supers = class_to_super[top_k_indices(logits, k)]  # [B, k]
    return torch.any(supers != supers[:, :1], dim=-1)
