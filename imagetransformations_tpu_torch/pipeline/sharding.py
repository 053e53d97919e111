"""Multi-device batch sharding on a one-process device mesh (PyTorch).

Counterpart of ``imagetransformations_tpu/pipeline/sharding.py``. The JAX
package lays the NHWC batch out over a 1-D ``jax.sharding.Mesh`` of one
process's local devices and runs each op on every device's block (the
transforms are a pure map over images: no collectives; the metric
reductions ``psum`` a scalar). The port keeps that design in one process:

- ``Mesh``: an ordered tuple of ``torch.device`` slots and one axis name;
  ``mesh.shape[axis]`` is the number of slots, as in JAX. A device may fill
  several slots, so one H100 holds 4 shards (``data_mesh(4,
  device="cuda:0")``) and the CPU 8, and the shard arithmetic and the halo
  exchange (``ops.sharded_stencil``) run for real on one card.
- ``ShardedBatch``: one tensor a slot, in batch order (``dim`` 0; rows for
  the halo blur), each on its slot's device, with ``gather()``.
- ``shard_images`` splits a batch over the slots (the batch must divide
  the axis, as JAX's ``P(axis)`` placement requires); ``sharded_apply``
  runs a per-batch function on each shard; ``psum_mean`` and
  ``sharded_accuracy`` reduce per-shard means, weighted as JAX's ``psum``
  pair weights them; ``sharded_chain_fn`` runs a whole chain (the fused
  kernels included) on each shard with that shard's slice of every
  per-image parameter.

No ``torch.distributed``: NCCL refuses two ranks on one GPU, and the JAX
mesh is one process too. The host issues the shards one after another; on
distinct devices the launches are asynchronous, so their kernels can
overlap. The reference's only parallelism is a torch DataParallel wrap
(attacks/fgsm.py:58).
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch


def _slot_device(d) -> torch.device:
    d = torch.device(d)
    return torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D device mesh of one process: ``devices[i]`` holds shard i of
    every array sharded over ``axis_names[0]``."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("data",)

    def __post_init__(self):
        devices = tuple(_slot_device(d) for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        if len(self.axis_names) != 1:
            raise ValueError(f"the port's mesh has one axis, got {self.axis_names}")
        object.__setattr__(self, "devices", devices)
        object.__setattr__(self, "axis_names", tuple(self.axis_names))

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis_names[0]: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)


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


@dataclasses.dataclass(frozen=True)
class ShardedBatch:
    """An array split over a mesh axis along ``dim``: ``shards[i]`` on
    ``mesh.devices[i]``, in order."""

    shards: tuple[torch.Tensor, ...]
    mesh: Mesh
    axis: str = "data"
    dim: int = 0

    @property
    def shape(self) -> tuple[int, ...]:
        s = list(self.shards[0].shape)
        s[self.dim] = sum(int(t.shape[self.dim]) for t in self.shards)
        return tuple(s)

    def __len__(self) -> int:
        return self.shape[0]

    def gather(self, device: str | torch.device | None = None) -> torch.Tensor:
        """The whole array on ``device`` (default: the first slot's)."""
        dev = self.mesh.devices[0] if device is None else torch.device(device)
        return torch.cat([t.to(dev) for t in self.shards], dim=self.dim)

    def __array__(self, dtype=None, copy=None):
        out = self.gather("cpu").numpy()
        return out if dtype is None else out.astype(dtype)


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, ShardedBatch):
        return x.gather()
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def split(x, mesh: Mesh, axis: str = "data", dim: int = 0) -> ShardedBatch:
    """``x`` (an array, a tensor or a ``ShardedBatch``) cut into equal
    blocks along ``dim``, block i moved to ``mesh.devices[i]``."""
    n_shards = mesh.shape[axis]
    x = _as_tensor(x)
    size = int(x.shape[dim])
    if size % n_shards:
        raise ValueError(f"dimension {dim} of size {size} does not divide into "
                         f"{n_shards} shards over mesh axis {axis!r}")
    step = size // n_shards
    return ShardedBatch(tuple(x.narrow(dim, i * step, step).contiguous().to(d)
                              for i, d in enumerate(mesh.devices)), mesh, axis, dim)


def shard_images(images, mesh: Mesh, axis: str = "data") -> ShardedBatch:
    """Place an NHWC batch (or any batch-major array) with its batch
    dimension split over the mesh; a batch already so placed is returned
    as it is."""
    if (isinstance(images, ShardedBatch) and images.mesh == mesh and images.axis == axis
            and images.dim == 0):
        return images
    return split(images, mesh, axis, 0)


def sharded_apply(fn: Callable[..., torch.Tensor], mesh: Mesh,
                  axis: str = "data") -> Callable[..., ShardedBatch]:
    """``fn`` (a pure per-batch function, first argument the NHWC batch) on
    each shard of the batch, on its slot's device; the outputs keep the
    input's placement."""

    def wrapped(images, *args, **kwargs) -> ShardedBatch:
        xs = shard_images(images, mesh, axis)
        return ShardedBatch(tuple(fn(s, *args, **kwargs) for s in xs.shards), mesh, axis)

    return wrapped


def psum_mean(x: ShardedBatch | Sequence[torch.Tensor], axis_name: str = "data") -> torch.Tensor:
    """The cross-shard mean of JAX's ``psum(mean(x)) / psum(1)``: each
    shard's mean, summed in slot order on the first shard's device, over
    the number of shards (equal shards: the global mean)."""
    shards = x.shards if isinstance(x, ShardedBatch) else tuple(x)
    dev = shards[0].device
    total = None
    for s in shards:
        m = torch.mean(s).to(dev)
        total = m if total is None else total + m
    return total / torch.tensor(float(len(shards)), dtype=total.dtype, device=dev)


def sharded_accuracy(logits, labels, mesh: Mesh, axis: str = "data") -> float:
    """Global accuracy over batch-sharded logits and labels without
    gathering them: each shard scores itself, and only the per-shard means
    cross devices (``psum_mean``)."""
    lg, lb = shard_images(logits, mesh, axis), shard_images(labels, mesh, axis)
    correct = [(torch.argmax(a, dim=-1) == b).to(torch.float32)
               for a, b in zip(lg.shards, lb.shards)]
    return float(psum_mean(correct, axis))


def model_replicas(model_fn, mesh: Mesh) -> list:
    """``model_fn`` for each slot: an ``nn.Module`` is copied once to each
    distinct device that does not hold it; any other callable serves
    every slot as it is."""
    if not isinstance(model_fn, torch.nn.Module):
        return [model_fn] * mesh.size
    home = next((p.device for p in model_fn.parameters()), None)
    by_device: dict = {}
    for d in mesh.devices:
        if d not in by_device:
            by_device[d] = model_fn if home is None or d == home else copy.deepcopy(model_fn).to(d)
    return [by_device[d] for d in mesh.devices]


def sharded_chain_fn(chain, mesh: Mesh, axis: str = "data", **build_kwargs):
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
    noise ops of every shard in turn (one generator: slots on one device).
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
        for i, (x, dev) in enumerate(zip(xs.shards, mesh.devices)):
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
