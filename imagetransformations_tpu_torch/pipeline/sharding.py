"""Multi-device batch sharding on a one-process device mesh (PyTorch).

Counterpart of ``imagetransformations_tpu/pipeline/sharding.py``. The JAX
package lays the NHWC batch out over a 1-D ``jax.sharding.Mesh`` of one
process's local devices and runs each op on every device's block (the
transforms are a pure map over images: no collectives; the metric
reductions ``psum`` a scalar). The port keeps that design in one process:

- ``Mesh`` (``core.mesh``): an ordered tuple of ``torch.device`` slots
  and one axis name; ``mesh.shape[axis]`` is the number of slots, as in
  JAX. A device may fill several slots, so one H100 holds 4 shards
  (``data_mesh(4, device="cuda:0")``) and the CPU 8, and the shard
  arithmetic and the halo exchange (``ops.sharded_stencil``) run for real
  on one card.
- ``ShardedBatch`` (``core.mesh``): one tensor a slot, in batch order
  (``dim`` 0; rows for the halo blur), each on its slot's device, with
  ``gather()``.
- ``shard_images`` splits a batch over the slots (the batch must divide
  the axis, as JAX's ``P(axis)`` placement requires); ``sharded_apply``
  runs a per-batch function on each shard; ``psum_mean`` and
  ``sharded_accuracy`` reduce per-shard means, weighted as JAX's ``psum``
  pair weights them; ``sharded_chain_fn`` runs a whole chain (the fused
  kernels included) on each shard with that shard's slice of every
  per-image parameter.

The host issues the shards one after another; on distinct devices the
launches are asynchronous, so their kernels can overlap. The reference's
only parallelism is a torch DataParallel wrap (attacks/fgsm.py:58).

Each function also takes a ``ProcessMesh`` (``core.mesh``), whose
slots are the ranks of a ``torch.distributed`` group: there a
``ShardedBatch`` holds this rank's shard alone (its ``shape`` the global
one), ``gather()`` is an ``all_gather`` in rank order, ``psum_mean`` an
``all_reduce``, each function runs on the local shard, and
``model_replicas`` broadcasts rank 0's weights. Every rank calls each
function with the same global arguments.
"""

from __future__ import annotations

import copy
from typing import Callable

import numpy as np
import torch

from imagetransformations_tpu_torch.core import mesh as cm
from imagetransformations_tpu_torch.core.mesh import (  # noqa: F401
    Mesh,
    ProcessMesh,
    ShardedBatch,
    _slot_device,
    home_device,
    init_process_mesh,
    local_slots,
    local_view,
    psum_mean,
    shard_images,
    split,
)


def data_mesh(n_devices: int | None = None, axis: str = "data",
              device: str | torch.device | None = None) -> Mesh:
    """1-D mesh. Without ``device``: every visible CUDA device, or the
    first ``n_devices`` (it raises without a GPU). With ``device``:
    ``n_devices`` slots (default 1) on that one device."""
    if device is not None:
        return Mesh((_slot_device(device),) * int(n_devices or 1), (axis,))
    if not torch.cuda.is_available():
        raise RuntimeError("data_mesh runs on the visible CUDA devices and none is available; "
                           "pass device='cpu' for a mesh of CPU slots")
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(tuple(devs), (axis,))


def sharded_apply(fn: Callable[..., torch.Tensor], mesh: Mesh | ProcessMesh,
                  axis: str = "data") -> Callable[..., ShardedBatch]:
    """``fn`` (a pure per-batch function, first argument the NHWC batch) on
    each shard of the batch, on its slot's device; the outputs keep the
    input's placement."""

    def wrapped(images, *args, **kwargs) -> ShardedBatch:
        xs = shard_images(images, mesh, axis)
        return ShardedBatch(tuple(fn(s, *args, **kwargs) for s in xs.shards), mesh, axis)

    return wrapped


def sharded_accuracy(logits, labels, mesh: Mesh | ProcessMesh, axis: str = "data") -> float:
    """Global accuracy over batch-sharded logits and labels without
    gathering them: each shard scores itself, and only the per-shard means
    cross devices (``psum_mean``)."""
    lg, lb = shard_images(logits, mesh, axis), shard_images(labels, mesh, axis)
    correct = tuple((torch.argmax(a, dim=-1) == b).to(torch.float32)
                    for a, b in zip(lg.shards, lb.shards))
    return float(psum_mean(ShardedBatch(correct, mesh, axis), axis))


def model_replicas(model_fn, mesh: Mesh | ProcessMesh) -> list:
    """``model_fn`` for each local slot: an ``nn.Module`` is copied once to
    each distinct device that does not hold it; any other callable serves
    every slot as it is. On a process mesh the module's parameters and
    buffers are then overwritten with rank 0's (``broadcast``), so every
    rank runs the same weights."""
    slots = [d for _, d in local_slots(mesh)]
    if not isinstance(model_fn, torch.nn.Module):
        return [model_fn] * len(slots)
    home = next((p.device for p in model_fn.parameters()), None)
    by_device: dict = {}
    for d in slots:
        if d not in by_device:
            by_device[d] = model_fn if home is None or d == home else copy.deepcopy(model_fn).to(d)
    if isinstance(mesh, ProcessMesh):
        m = by_device[mesh.device]
        cm.broadcast_([*m.parameters(), *m.buffers()])
    return [by_device[d] for d in slots]


def sharded_chain_fn(chain, mesh: Mesh | ProcessMesh, axis: str = "data", **build_kwargs):
    """Batch-data-parallel chain: each slot runs the whole chain (the fused
    kernels included) on its shard. Returns ``fn(images, generator=None)
    -> ShardedBatch``; the batch must divide the axis.

    Per-image parameter arrays (a length-N ``angle`` / ``factor`` / ...
    in an ``OpSpec``) are lifted out of the specs, and each shard's chain
    gets its slice; 0-d arrays become plain numbers. For a rotation angle
    array within 45 degrees the budget of the WHOLE batch (its max |angle|
    rounded up to 5 degrees, JAX's ``_round_budget``) goes to every shard
    as ``max_angle_deg``, as JAX injects it before ``shard_map``: a shard
    whose angles lie in a lower band runs the per-image-angle kernels with
    the global budget (which clips none of its angles; the pixels are the
    one-device chain's). ``build_kwargs`` go to ``build_chain_fn``; each
    shard's chain runs on its slot's device, and ``generator`` feeds the
    noise ops of every shard in turn (one generator: slots on one device;
    on a process mesh each rank's own). On a process mesh each rank runs
    its shard with its slice, and the budget is the whole batch's, which
    every rank holds.
    """
    from imagetransformations_tpu_torch.pipeline.chain import OpSpec, _round_budget, build_chain_fn

    n_shards = mesh.shape[axis]
    chain = list(chain)
    lifted: list[tuple[int, str]] = []  # (spec index, param key)
    arrays: list = []
    for si, sp in enumerate(chain):
        new_params = dict(sp.params)
        for k, v in sp.params.items():
            if isinstance(v, (int, float, bool, str)) or v is None:
                continue
            host = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            if host.ndim < 1:
                new_params[k] = float(host)
                continue
            lifted.append((si, k))
            arrays.append(v)
            amax = float(np.abs(host).max()) if host.size else 0.0
            if (sp.name == "rotation" and k == "angle" and "max_angle_deg" not in sp.params
                    and amax <= 45.0):
                new_params["max_angle_deg"] = _round_budget(amax)
        chain[si] = OpSpec(sp.name, new_params)

    def fn(images, generator: torch.Generator | None = None) -> ShardedBatch:
        xs = shard_images(images, mesh, axis)
        n = len(xs)
        step = n // n_shards
        outs = []
        for (i, dev), x in zip(local_slots(mesh), xs.shards):
            local = list(chain)
            for (si, k), v in zip(lifted, arrays):
                if len(v) != n:
                    raise ValueError(f"per-image parameter {chain[si].name}.{k} has {len(v)} "
                                     f"values for a batch of {n}")
                p = dict(local[si].params)
                p[k] = v[i * step: (i + 1) * step]
                local[si] = OpSpec(local[si].name, p)
            outs.append(build_chain_fn(local, device=dev, **build_kwargs)(x, generator))
        return ShardedBatch(tuple(outs), mesh, axis)

    return fn
