"""Host-side data I/O: folder walkers, CIFAR-10-C npy loaders, device prefetch.

Counterpart of ``imagetransformations_tpu/pipeline/io.py``, the reference's
L0 layer:

- ``load_folder_images``  <- transformation.py:73-89 (walk dir for images)
- ``load_cifar10c_npy``   <- transformation.py:19-71 (npy corruption tensors,
  fixed severity sample indices) and FINAL_cifar_corrupted.py:45-48
  (sev*10000 slicing)
- ``shard_files_for_host`` and ``global_batch_from_host_shards`` <- the
  JAX package's multi-host input: a file slice and a batch shard a rank of
  a ``torch.distributed`` group
- ``prefetch_to_device``  <- DataLoader(num_workers=N) equivalent: a
  background thread stages host batches from pinned buffers onto a side
  CUDA stream while the current batch computes.

Images stay NHWC uint8 numpy arrays on the host; PIL is imported only where
a function decodes or encodes through it, and the multithreaded C++ codec
(``pipeline.native_io``) serves the same calls without it.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterable, Iterator

import numpy as np
import torch

from imagetransformations_tpu_torch.core.image import entry_device

IMAGE_EXTS = (".jpeg", ".jpg", ".png")

#: transformation.py:33 — one sample index per severity block of 1001
SEVERITY_SAMPLE_INDICES = (0, 1001, 2002, 3003, 4004)


def walk_image_files(root: str, exts: tuple[str, ...] = IMAGE_EXTS) -> list[str]:
    out = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.lower().endswith(exts):
                out.append(os.path.join(dirpath, f))
    return out


def shard_files_for_host(paths: list[str], process_index: int | None = None,
                         process_count: int | None = None) -> list[str]:
    """Deterministic per-process slice of a global file list.

    Each process walks the same folder and takes its contiguous slice
    ``[idx*n//cnt, (idx+1)*n//cnt)``: shard sizes stay within one file of
    each other, and each process's reads stay sequential. The index and
    the count default to the rank and world size of an initialized
    ``torch.distributed`` group (JAX: ``jax.process_index()`` /
    ``process_count()``), else (0, 1): one process sees the whole list.
    Explicit values win."""
    import torch.distributed as dist

    grouped = dist.is_available() and dist.is_initialized()
    if process_index is None:
        process_index = dist.get_rank() if grouped else 0
    if process_count is None:
        process_count = dist.get_world_size() if grouped else 1
    idx, cnt = int(process_index), int(process_count)
    if cnt <= 1:
        return list(paths)
    if not 0 <= idx < cnt:
        raise ValueError(f"process_index {idx} outside [0, {cnt})")
    start = idx * len(paths) // cnt
    stop = (idx + 1) * len(paths) // cnt
    return list(paths[start:stop])


def global_batch_from_host_shards(local_batch, mesh, axis: str = "data"):
    """The batch as ``evaluate_sharded`` and ``sharded_chain_fn`` consume it.

    On a process mesh (``core.mesh.ProcessMesh``) each rank's
    ``local_batch`` (the rows of its ``shard_files_for_host`` slice) is its
    shard of one global batch, in rank order: JAX's
    ``make_array_from_process_local_data``. The ranks exchange their row
    counts, and unequal shards raise ``ValueError`` on every rank, as JAX's
    batch must divide the axis. In one process it is
    ``pipeline.sharding.shard_images`` of ``local_batch`` over
    ``mesh[axis]``; under a group of more than one process that takes a
    process mesh (``RuntimeError`` otherwise: each process would hold a
    batch of its own)."""
    import torch.distributed as dist

    from imagetransformations_tpu_torch.core.mesh import (
        ProcessMesh, ShardedBatch, _as_tensor, all_gather, shard_images)

    if isinstance(mesh, ProcessMesh):
        local = _as_tensor(local_batch)
        rows = torch.tensor([int(local.shape[0])], dtype=torch.int64, device=mesh.device)
        counts = [int(c) for c in torch.cat(all_gather(rows, mesh))]
        if len(set(counts)) != 1:
            raise ValueError(f"global_batch_from_host_shards: the ranks hold {counts} rows; "
                             f"the batch must split into equal shards over mesh axis {axis!r}")
        return ShardedBatch((local.to(mesh.device),), mesh, axis, 0)
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        raise RuntimeError(
            "global_batch_from_host_shards: under a torch.distributed group of "
            f"{dist.get_world_size()} processes the mesh must be a process mesh "
            "(pipeline.sharding.init_process_mesh)")
    return shard_images(local_batch, mesh, axis)


def load_folder_images(
    root: str, size: tuple[int, int] | None = None, native: bool = False
) -> tuple[np.ndarray, list[str]]:
    """Load a folder of images as one NHWC uint8 batch (+ their paths).

    Images are optionally resized (PIL bilinear) to a common size; without
    ``size`` all images must already share a shape. ``native=True`` routes
    through the multithreaded C++ decoder (``pipeline.native_io``; requires
    ``size``), which itself falls back to PIL when the native build is
    unavailable.
    """
    if native and size is not None:
        from imagetransformations_tpu_torch.pipeline.native_io import load_folder_images_native

        return load_folder_images_native(root, size)

    paths = walk_image_files(root)
    if not paths:
        return np.zeros((0, 0, 0, 3), np.uint8), []
    from PIL import Image

    arrs = []
    for p in paths:
        img = Image.open(p).convert("RGB")
        if size is not None:
            img = img.resize(size, Image.BILINEAR)
        arrs.append(np.asarray(img, np.uint8))
    return np.stack(arrs), paths


def load_cifar10c_npy(
    path: str, severity: int | None = None, sample_only: bool = False
) -> np.ndarray:
    """Load one CIFAR-10-C corruption file -> NHWC uint8.

    Layout: [50000, 32, 32, 3] = 5 severities x 10000 images
    (FINAL_cifar_corrupted.py:45-48). ``severity`` in 1..5 slices one block;
    ``sample_only`` returns the reference's 5 preview indices
    (transformation.py:33).
    """
    arr = np.load(path, mmap_mode="r")
    if arr.ndim == 4 and arr.shape[1] == 3 and arr.shape[-1] != 3:
        arr = np.transpose(arr, (0, 2, 3, 1))  # CHW -> HWC (transformation.py:41-43)
    if sample_only:
        return np.asarray(arr[list(SEVERITY_SAMPLE_INDICES)])
    if severity is not None:
        lo = (severity - 1) * 10000
        return np.asarray(arr[lo : lo + 10000])
    return np.asarray(arr)


def export_corruption_samples(root: str, out_dir: str) -> list[str]:
    """Save one preview PNG per (corruption, severity) from CIFAR-10-C npys.

    transformation.py:19-71 parity: walks for .npy files, slices the fixed
    severity sample indices, writes ``store/``-style PNGs (PIL).
    """
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    written = []
    for name, path in iter_corruption_files(root):
        samples = load_cifar10c_npy(path, sample_only=True)
        for sev, img in enumerate(samples, start=1):
            fn = os.path.join(out_dir, f"{name}_severity{sev}.png")
            Image.fromarray(img).save(fn)
            written.append(fn)
    return written


def iter_corruption_files(root: str) -> Iterator[tuple[str, str]]:
    """Yield (corruption_name, path) for every .npy under root (labels.npy excluded)."""
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.endswith(".npy") and f != "labels.npy":
                yield os.path.splitext(f)[0], os.path.join(dirpath, f)


def batched(arr: np.ndarray, batch_size: int) -> Iterator[np.ndarray]:
    for i in range(0, len(arr), batch_size):
        yield arr[i : i + batch_size]


def prefetch_to_device(host_batches: Iterable, buffer_size: int = 2,
                       device: str | torch.device | None = None) -> Iterator[torch.Tensor]:
    """Host batches (numpy arrays or CPU tensors) as tensors on ``device``,
    in order, staged ahead while the caller computes.

    On CUDA (``device`` None means "cuda", which raises without a GPU): a
    background thread takes each host batch, copies it into a pinned host
    buffer, starts its copy to the card on a side stream and records an
    event there; the consumer's current stream waits on that event before
    the batch is yielded, and the batch is marked as used on that stream
    for the caching allocator. At most ``buffer_size`` batches are staged
    and not yet handed on. ``device="cpu"``: the batches as CPU tensors, in
    order, with no thread.
    """
    if buffer_size < 1:
        raise ValueError(f"buffer_size must be at least 1, got {buffer_size}")
    dev = entry_device(device, "prefetch_to_device")
    if dev.type == "cpu":
        for b in host_batches:
            yield torch.as_tensor(np.ascontiguousarray(b) if isinstance(b, np.ndarray) else b)
        return

    side = torch.cuda.Stream(device=dev)
    slots = threading.Semaphore(buffer_size)
    staged: queue.Queue = queue.Queue()
    stop = threading.Event()
    end = object()

    def producer():
        try:
            for b in host_batches:
                slots.acquire()
                if stop.is_set():
                    return
                host = torch.as_tensor(np.ascontiguousarray(b) if isinstance(b, np.ndarray)
                                       else b).pin_memory()
                with torch.cuda.stream(side):
                    out = host.to(dev, non_blocking=True)
                    ready = torch.cuda.Event()
                    ready.record(side)
                staged.put((out, ready))
        except Exception as e:  # handed to the consumer, which raises it
            staged.put(e)
        finally:
            staged.put(end)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            item = staged.get()
            if item is end:
                return
            if isinstance(item, Exception):
                raise item
            out, ready = item
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(ready)
            out.record_stream(consumer)
            slots.release()
            yield out
    finally:
        stop.set()
        slots.release()


def save_batch_images(
    images,
    paths: list[str],
    out_dir: str,
    suffix: str,
    native: bool = False,
) -> list[str]:
    """Write an NHWC uint8 batch (numpy, or a tensor on any device) back to
    disk as ``{stem}_{suffix}.jpeg`` (parity with transformation.py:160-162);
    returns the paths written.

    ``native=True`` routes through the multithreaded C++ libjpeg encoder
    (``pipeline.native_io.encode_batch``); the default stays on PIL for
    byte-level reproducibility with the reference's saved outputs.
    """
    if isinstance(images, torch.Tensor):
        images = images.cpu().numpy()
    os.makedirs(out_dir, exist_ok=True)
    out_paths = [
        os.path.join(out_dir, f"{os.path.splitext(os.path.basename(p))[0]}_{suffix}.jpeg")
        for p in paths
    ]
    if native:
        from imagetransformations_tpu_torch.pipeline.native_io import encode_batch

        encode_batch(np.asarray(images), out_paths)
        return out_paths
    from PIL import Image

    for img, op in zip(np.asarray(images), out_paths):
        Image.fromarray(img).save(op)
    return out_paths
