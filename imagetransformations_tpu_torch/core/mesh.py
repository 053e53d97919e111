"""The mesh types, the sharded batch and the collectives of a process group
(PyTorch): the leaf under ``pipeline.sharding`` and the training paths.

Two meshes of one axis each count the slots of JAX's 1-D mesh:

- ``Mesh``: an ordered tuple of ``torch.device`` slots of one process;
  ``mesh.shape[axis]`` is the number of slots. A device may fill several
  slots, so one H100 holds 4 shards and the CPU 8.
- ``ProcessMesh``: the ranks of a ``torch.distributed`` group, one slot a
  rank (``init_process_mesh``), over the axis ``"data"``. The JAX package's global mesh counts every
  host's devices, and each host feeds its own (``jax.process_index()``,
  ``make_array_from_process_local_data``); GSPMD then inserts the
  cross-shard collectives, BatchNorm's batch means included. The port's
  counterpart is one process a slot, the idiom of PyTorch's data
  parallelism.

``ShardedBatch`` holds one tensor a local slot (on a ``ProcessMesh``: this
rank's shard alone, its ``shape`` the global one); ``gather()`` is a
concatenation, or an ``all_gather`` in rank order. ``psum_mean`` reduces
per-shard means as JAX's ``psum`` pair does.

The backend is ``nccl`` where every rank of the host has a GPU of its own,
and ``gloo`` otherwise (ranks that share a card, or CPU ranks);
``ProcessMesh.backend`` says which. NCCL refuses two ranks on one GPU. gloo
takes CUDA tensors in ``broadcast`` and ``all_reduce`` only, so every other
collective (``all_gather``, ``exchange``'s sends and receives) passes its
tensors through ``_wire``, which stages them through the host there.
``_wire`` is the only place the backend is read.

``batch_mesh(mesh)`` is the scope in which a training step runs a sharded
batch: ``models._layers.BatchNorm`` reads it and takes its batch
statistics over every rank (``all_reduce_sum``, differentiable). Every
rank must reach every collective in the same order; a rank that fails ends
the run (``torchrun`` stops the others). Imports torch and numpy only.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import os
from typing import ClassVar, Iterable, Sequence

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class ProcessMesh:
    """A 1-D mesh of processes: this process is slot ``rank`` of
    ``world_size``, its shard on ``device``. ``mesh.shape["data"]`` counts
    every rank, as JAX's global mesh counts every host's devices."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    axis_names: ClassVar[tuple[str, ...]] = ("data",)

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis_names[0]: self.world_size}

    @property
    def size(self) -> int:
        return self.world_size


def _env_int(name: str, default: int | None = None) -> int:
    value = os.environ.get(name)
    if value is None:
        if default is None:
            raise RuntimeError(f"init_process_mesh: {name} is not set; run under torchrun or "
                               "pass rank, world_size and init_method")
        return default
    return int(value)


def init_process_mesh(device: str | torch.device | None = None, *,
                      init_method: str | None = None, rank: int | None = None,
                      world_size: int | None = None) -> ProcessMesh:
    """Join the process group and return this rank's ``ProcessMesh``.

    Without ``init_method`` the group is ``torchrun``'s (``env://``: rank,
    world size, ``MASTER_ADDR`` / ``MASTER_PORT`` from the environment);
    with it (``tcp://localhost:PORT``, say) ``rank`` and ``world_size`` are
    the caller's, or the environment's. ``device``: None or "cuda" means
    ``cuda:{LOCAL_RANK % device_count}`` and raises without a GPU; "cpu"
    puts the rank on the CPU. The backend is ``nccl`` when the ranks of
    this host (``LOCAL_WORLD_SIZE``, else the world) fit one GPU each, and
    ``gloo`` otherwise. A group already initialized is joined as it is."""
    want = torch.device("cuda" if device is None else device)
    rank = _env_int("RANK") if rank is None else int(rank)
    world = _env_int("WORLD_SIZE") if world_size is None else int(world_size)
    local_rank = _env_int("LOCAL_RANK", rank)
    if want.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_process_mesh: no CUDA device is available; pass "
                               "device='cpu' for a mesh of CPU ranks")
        n_gpus = torch.cuda.device_count()
        dev = torch.device("cuda", local_rank % n_gpus)
        torch.cuda.set_device(dev)
        backend = "nccl" if _env_int("LOCAL_WORLD_SIZE", world) <= n_gpus else "gloo"
    else:
        dev, backend = torch.device("cpu"), "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world)
    return ProcessMesh(dist.get_rank(), dist.get_world_size(), dev, dist.get_backend())


def _wire(mesh: ProcessMesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` as the backend carries it outside ``broadcast`` / ``all_reduce``:
    a host copy of a CUDA tensor under gloo, else ``t`` itself."""
    return t.cpu() if mesh.backend == "gloo" and t.is_cuda else t


def all_gather(t: torch.Tensor, mesh: ProcessMesh) -> list[torch.Tensor]:
    """Every rank's ``t`` (equal shapes), in rank order, on ``t``'s device."""
    wire = _wire(mesh, t.contiguous())
    parts = [torch.empty_like(wire) for _ in range(mesh.size)]
    dist.all_gather(parts, wire)
    return [p.to(t.device) for p in parts]


def exchange(sends: dict[int, torch.Tensor], mesh: ProcessMesh) -> dict[int, torch.Tensor]:
    """Point to point: ``sends[peer]`` goes to ``peer``, and from each such
    peer a tensor of the same shape and dtype comes back (one
    ``batch_isend_irecv``, JAX's ``ppermute`` pair); ``{peer: received}``
    on the sent tensors' devices."""
    ops, received = [], {}
    for peer, t in sends.items():
        wire = _wire(mesh, t.contiguous())
        received[peer] = torch.empty_like(wire)
        ops.append(dist.P2POp(dist.isend, wire, peer))
        ops.append(dist.P2POp(dist.irecv, received[peer], peer))
    for req in dist.batch_isend_irecv(ops) if ops else ():
        req.wait()
    return {peer: r.to(sends[peer].device) for peer, r in received.items()}


def broadcast_(tensors: Iterable[torch.Tensor], src: int = 0) -> None:
    """Overwrite each tensor with rank ``src``'s, in place."""
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src)


class _AllReduceSum(torch.autograd.Function):
    """Σ over ranks; its gradient is the Σ over ranks of the gradients (every
    rank's loss depends on the sum), so a backward through it needs every
    rank too."""

    @staticmethod
    def forward(ctx, t):
        out = t.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.clone()
        dist.all_reduce(out)
        return out


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Σ of ``t`` over the ranks, differentiable (the idiom of
    ``torch.distributed.nn.functional.all_reduce``, deprecated in recent
    PyTorch); every rank gets the same bits."""
    return _AllReduceSum.apply(t)


def mean_over_ranks(t: torch.Tensor, mesh: ProcessMesh) -> torch.Tensor:
    """JAX's ``psum(t) / psum(1)``: the ranks' values summed, over their
    number (no gradient)."""
    out = t.detach().clone()
    dist.all_reduce(out)
    return out / torch.tensor(float(mesh.size), dtype=out.dtype, device=out.device)


def average_gradients(params: Iterable[torch.Tensor], mesh: ProcessMesh) -> None:
    """Each parameter's ``.grad`` replaced by the mean over ranks of every
    rank's (one flat ``all_reduce``): with each rank's loss its shard's mean,
    the whole batch's gradient, the same bits on every rank."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = mean_over_ranks(torch.cat([g.reshape(-1) for g in grads]), mesh)
    offset = 0
    for g in grads:
        g.copy_(flat[offset: offset + g.numel()].view_as(g))
        offset += g.numel()


_BATCH_MESH: contextvars.ContextVar[ProcessMesh | None] = contextvars.ContextVar(
    "batch_mesh", default=None)


@contextlib.contextmanager
def batch_mesh(mesh: ProcessMesh | None):
    """Scope of a forward on this rank's shard of a batch sharded over
    ``mesh`` (None: a whole batch, no scope): training-mode BatchNorm takes
    its statistics over every rank's shard."""
    token = _BATCH_MESH.set(mesh)
    try:
        yield
    finally:
        _BATCH_MESH.reset(token)


def current_batch_mesh() -> ProcessMesh | None:
    return _BATCH_MESH.get()


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


def local_slots(mesh) -> tuple[tuple[int, torch.device], ...]:
    """(slot index, device) of each slot this process computes: every slot
    of a ``Mesh``, this rank's of a ``ProcessMesh``."""
    if isinstance(mesh, ProcessMesh):
        return ((mesh.rank, mesh.device),)
    return tuple(enumerate(mesh.devices))


def home_device(mesh) -> torch.device:
    """Where this process gathers a mesh's arrays: a ``Mesh``'s first slot,
    a ``ProcessMesh``'s own device."""
    return local_slots(mesh)[0][1]


@dataclasses.dataclass(frozen=True)
class ShardedBatch:
    """An array split over a mesh axis along ``dim``: ``shards[i]`` on
    ``mesh.devices[i]``, in order; on a ``ProcessMesh``, ``shards`` is this
    rank's shard alone (the shards are equal)."""

    shards: tuple[torch.Tensor, ...]
    mesh: Mesh | ProcessMesh
    axis: str = "data"
    dim: int = 0

    @property
    def shape(self) -> tuple[int, ...]:
        s = list(self.shards[0].shape)
        s[self.dim] = (sum(int(t.shape[self.dim]) for t in self.shards)
                       * (self.mesh.size // len(self.shards)))
        return tuple(s)

    def __len__(self) -> int:
        return self.shape[0]

    def gather(self, device: str | torch.device | None = None) -> torch.Tensor:
        """The whole array on ``device`` (default: the first slot's; a
        process mesh's: this rank's), on every rank of a process mesh."""
        dev = home_device(self.mesh) if device is None else torch.device(device)
        parts = (all_gather(self.shards[0], self.mesh)
                 if isinstance(self.mesh, ProcessMesh) else self.shards)
        return torch.cat([t.to(dev) for t in parts], dim=self.dim)

    def __array__(self, dtype=None, copy=None):
        out = self.gather("cpu").numpy()
        return out if dtype is None else out.astype(dtype)


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, ShardedBatch):
        return x.gather()
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def split(x, mesh: Mesh | ProcessMesh, axis: str = "data", dim: int = 0) -> ShardedBatch:
    """``x`` (an array, a tensor or a ``ShardedBatch``) cut into equal
    blocks along ``dim``, block i moved to ``mesh.devices[i]`` (on a
    process mesh: this rank's block to its device)."""
    n_shards = mesh.shape[axis]
    x = _as_tensor(x)
    size = int(x.shape[dim])
    if size % n_shards:
        raise ValueError(f"dimension {dim} of size {size} does not divide into "
                         f"{n_shards} shards over mesh axis {axis!r}")
    step = size // n_shards
    return ShardedBatch(tuple(x.narrow(dim, i * step, step).contiguous().to(d)
                              for i, d in local_slots(mesh)), mesh, axis, dim)


def shard_images(images, mesh: Mesh | ProcessMesh, axis: str = "data") -> ShardedBatch:
    """Place an NHWC batch (or any batch-major array) with its batch
    dimension split over the mesh; a batch already so placed is returned
    as it is."""
    if (isinstance(images, ShardedBatch) and images.mesh == mesh and images.axis == axis
            and images.dim == 0):
        return images
    return split(images, mesh, axis, 0)


def local_view(x) -> tuple[torch.Tensor, ProcessMesh | None]:
    """What this process computes on: a ``ShardedBatch`` on a process mesh
    gives (this rank's shard, the mesh); one on a one-process mesh (its
    gathered whole, None); anything else (itself, None)."""
    if isinstance(x, ShardedBatch):
        if isinstance(x.mesh, ProcessMesh):
            return x.shards[0], x.mesh
        return x.gather(), None
    return x, None


def psum_mean(x: ShardedBatch | Sequence[torch.Tensor], axis_name: str = "data") -> torch.Tensor:
    """The cross-shard mean of JAX's ``psum(mean(x)) / psum(1)``: each
    shard's mean, summed in slot order on the first shard's device, over
    the number of shards (equal shards: the global mean). On a process
    mesh: this rank's mean, ``all_reduce``d, over the number of ranks."""
    if isinstance(x, ShardedBatch) and isinstance(x.mesh, ProcessMesh):
        return mean_over_ranks(torch.mean(x.shards[0]), x.mesh)
    shards = x.shards if isinstance(x, ShardedBatch) else tuple(x)
    dev = shards[0].device
    total = None
    for s in shards:
        m = torch.mean(s).to(dev)
        total = m if total is None else total + m
    return total / torch.tensor(float(len(shards)), dtype=total.dtype, device=dev)
