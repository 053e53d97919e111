"""Spatially sharded Gaussian blur: rows over a mesh, halo rows between
neighbours (PyTorch).

Counterpart of ``imagetransformations_tpu/ops/sharded_stencil.py``. The
batch sharding of ``pipeline.sharding`` is a pure map; for images too large
for one device (or one image at the least latency) the rows are sharded
instead, and each shard takes the p = ksize // 2 rows next to its inner
borders from its neighbours (JAX: ``ppermute`` over the ICI mesh; here a
``.to(device)`` copy between slots, or a send and a receive between the
ranks of a process mesh). Each shard then blurs its strip with
the port's own ``ops.stencil.gaussian_blur`` (the ``blur_separable``
kernel, #6, for a CUDA u8 batch; cv2's 8U integers) and keeps its own
rows. The strip's own reflect-101 borders are the image's at the global top
and bottom and touch only halo rows elsewhere, so the result equals the
unsharded ``gaussian_blur``, and ``cv2.GaussianBlur``, byte for byte.

Reference behavior: transformation.py:228-257 (apply_blur); the reference
has no distributed execution at all.
"""

from __future__ import annotations

import torch

from imagetransformations_tpu_torch.ops.stencil import cv2_gaussian_ksize, gaussian_blur
from imagetransformations_tpu_torch.core import mesh as cm
from imagetransformations_tpu_torch.core.mesh import Mesh, ShardedBatch, split


def _blur_strip(own: torch.Tensor, top, bottom, radius: float) -> torch.Tensor:
    """``own`` rows blurred with the halo rows above (``top``) and below
    (``bottom``; None at the image's border) as their neighbours."""
    strip = torch.cat([t for t in (top, own, bottom) if t is not None], dim=1)
    start = 0 if top is None else int(top.shape[1])
    return gaussian_blur(strip, float(radius))[:, start: start + own.shape[1]].contiguous()


def sharded_gaussian_blur(img, radius: float, mesh: Mesh | cm.ProcessMesh,
                          axis: str = "data") -> ShardedBatch:
    """cv2-semantics Gaussian blur of an [N, H, W, C] batch (u8 or f32; a
    tensor, an array or a row-sharded ``ShardedBatch``) with the ROW
    dimension split over ``mesh[axis]``. H must divide into the shards, each
    of more than p rows (``ValueError`` otherwise, as in JAX). Returns the
    blurred batch sharded by rows (``dim`` 1). On a process mesh each rank
    blurs its strip, its halo rows sent to and received from its
    neighbours in one ``batch_isend_irecv`` (JAX's ``ppermute`` pair)."""
    n_shards = mesh.shape[axis]
    if radius == 0:
        return split(img, mesh, axis, 1)
    p = cv2_gaussian_ksize(float(radius)) // 2
    h = int(img.shape[1])
    if h % n_shards or h // n_shards <= p:
        raise ValueError(f"H={h} must be divisible by {n_shards} shards of > {p} rows")
    rows = split(img, mesh, axis, 1).shards
    if isinstance(mesh, cm.ProcessMesh):
        r, (own,) = mesh.rank, rows
        sends = {}
        if r > 0:
            sends[r - 1] = own[:, :p]
        if r < n_shards - 1:
            sends[r + 1] = own[:, -p:]
        got = cm.exchange(sends, mesh)
        out = _blur_strip(own, got.get(r - 1), got.get(r + 1), radius)
        return ShardedBatch((out,), mesh, axis, 1)
    outs = []
    for i, (own, dev) in enumerate(zip(rows, mesh.devices)):
        top = rows[i - 1][:, -p:].to(dev) if i > 0 else None
        bottom = rows[i + 1][:, :p].to(dev) if i < n_shards - 1 else None
        outs.append(_blur_strip(own, top, bottom, radius))
    return ShardedBatch(tuple(outs), mesh, axis, 1)
