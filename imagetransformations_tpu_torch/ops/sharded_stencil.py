"""Spatially sharded Gaussian blur: rows over a mesh, halo rows between
neighbours (PyTorch).

Counterpart of ``imagetransformations_tpu/ops/sharded_stencil.py``. The
batch sharding of ``pipeline.sharding`` is a pure map; for images too large
for one device (or one image at the least latency) the rows are sharded
instead, and each shard takes the p = ksize // 2 rows next to its inner
borders from its neighbours (JAX: ``ppermute`` over the ICI mesh; here a
``.to(device)`` copy between slots). Each shard then blurs its strip with
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
from imagetransformations_tpu_torch.pipeline.sharding import Mesh, ShardedBatch, split


def sharded_gaussian_blur(img, radius: float, mesh: Mesh, axis: str = "data") -> ShardedBatch:
    """cv2-semantics Gaussian blur of an [N, H, W, C] batch (u8 or f32; a
    tensor, an array or a row-sharded ``ShardedBatch``) with the ROW
    dimension split over ``mesh[axis]``. H must divide into the shards, each
    of more than p rows (``ValueError`` otherwise, as in JAX). Returns the
    blurred batch sharded by rows (``dim`` 1)."""
    n_shards = mesh.shape[axis]
    if radius == 0:
        return split(img, mesh, axis, 1)
    p = cv2_gaussian_ksize(float(radius)) // 2
    h = int(img.shape[1])
    if h % n_shards or h // n_shards <= p:
        raise ValueError(f"H={h} must be divisible by {n_shards} shards of > {p} rows")
    rows = split(img, mesh, axis, 1).shards
    outs = []
    for i, (own, dev) in enumerate(zip(rows, mesh.devices)):
        top = [rows[i - 1][:, -p:].to(dev)] if i > 0 else []
        bottom = [rows[i + 1][:, :p].to(dev)] if i < n_shards - 1 else []
        strip = torch.cat(top + [own] + bottom, dim=1)
        start = p if top else 0
        outs.append(gaussian_blur(strip, float(radius))[:, start: start + own.shape[1]]
                    .contiguous())
    return ShardedBatch(tuple(outs), mesh, axis, 1)
