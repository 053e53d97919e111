"""Deep k-NN uncertainty over train-feature neighbourhoods (PyTorch).

Counterpart of ``imagetransformations_tpu/uq/knn.py:19-64``. Parity:
- pipeline/metrics/dknn2.py:38-106 — k=10 cosine neighbours of penultimate
  features; uncertainty = entropy of the neighbour-label histogram.
- pipeline/metrics/feature.py:38-80 — k=1 euclidean distance; prediction =
  the nearest neighbour's label.

Neighbour search is one [B, D] x [D, N] product in true f32 (``full_f32``)
and a top-k. Ties: ``lax.top_k`` puts the lower index first among equal
values, ``torch.topk`` promises no order. Only the set of the k neighbours
matters here, and only a tie at the k-th place can change it: there
``top_k_indices`` takes the lower train indices, as ``lax.top_k`` does, so
the port's set is JAX's. The entropy of the neighbour counts is taken in
f64 and rounded to f32, so that every device gives the same value.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from imagetransformations_tpu_torch.core.image import trig_f32
from imagetransformations_tpu_torch.core.precision import full_f32


def top_k_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """[..., k] indices of the k largest of ``scores`` along the last axis,
    the lower index winning a tie at the k-th place (``lax.top_k``'s set;
    the order within the set is ``torch.topk``'s). Rows whose k-th value
    is tied across the boundary (one host read to find them) are ranked
    by a stable descending sort."""
    vals, idx = torch.topk(scores, k, dim=-1)
    kth = vals[..., -1:]
    tied = torch.sum(scores >= kth, dim=-1) > k
    if bool(tied.any()):
        order = torch.sort(scores[tied], dim=-1, descending=True, stable=True).indices
        idx = idx.clone()
        idx[tied] = order[..., :k]
    return idx


def _normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=eps)


def _sq_distances(train_feats: torch.Tensor, query_feats: torch.Tensor) -> torch.Tensor:
    """|q|^2 - 2 q.t + |t|^2, [B, N], in the JAX package's order."""
    return (torch.sum(query_feats ** 2, -1, keepdim=True)
            - (2.0 * query_feats) @ train_feats.T
            + torch.sum(train_feats ** 2, -1)[None, :])


def similarities(train_feats: torch.Tensor, query_feats: torch.Tensor,
                 metric: str = "cosine") -> torch.Tensor:
    """[B, N] scores, larger = nearer: cosine similarities ("cosine"), else
    negative squared euclidean distances; true f32 (``full_f32``)."""
    with torch.no_grad(), full_f32():
        if metric == "cosine":
            return _normalize(query_feats) @ _normalize(train_feats).T
        return -_sq_distances(train_feats, query_feats)


def knn_label_entropy(
    train_feats: torch.Tensor,
    train_labels: torch.Tensor,
    query_feats: torch.Tensor,
    k: int = 10,
    num_classes: int = 10,
    metric: str = "cosine",
    base2: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(uncertainty [B], majority label [B]) from the k nearest train
    features ("cosine", else euclidean); the majority is the lowest class
    among equal counts."""
    idx = top_k_indices(similarities(train_feats, query_feats, metric), k)
    neigh = train_labels.long()[idx]  # [B, k]
    hist = torch.sum(F.one_hot(neigh, num_classes), dim=1)  # [B, C] counts
    p = hist.to(torch.float64) / k
    logp = torch.where(p > 0, torch.log2(p) if base2 else torch.log(p),
                       torch.zeros((), dtype=p.dtype, device=p.device))
    ent = -torch.sum(p * logp, dim=-1)
    return ent.to(torch.float32), torch.argmax(hist, dim=-1)


def nearest_feature_distance(
    train_feats: torch.Tensor,
    train_labels: torch.Tensor,
    query_feats: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(euclidean distance to the nearest train feature, its label) —
    feature.py; the first of equal distances."""
    d2 = -similarities(train_feats, query_feats, "euclidean")
    idx = torch.argmin(d2, dim=-1)
    dist = trig_f32(torch.sqrt, torch.clamp(torch.gather(d2, 1, idx[:, None])[:, 0], min=0.0))
    return dist, train_labels[idx]
