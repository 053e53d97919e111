"""Dataset access: CIFAR-10/100 (local), CIFAR-10-C, ImageNet-style folders.

Counterpart of ``imagetransformations_tpu/pipeline/datasets.py`` (which
imports no JAX; the port keeps its own copy). The reference pulls data
through torchvision/tfds downloads (e.g. pipeline/metrics/energy.py:13-18,
swag/cifar_swag.py:91-105); this module reads the same on-disk formats
without a network dependency and returns NHWC uint8 numpy batches + int
labels on the host, ready for ``pipeline.io.prefetch_to_device``.

- CIFAR-10/100: python-pickle batch files under <root>/cifar-10-batches-py
  (or cifar-100-python).
- CIFAR-10-C: .npy corruption tensors (``pipeline.io.load_cifar10c_npy``).
- ImageNet-val style: class-per-folder image tree + synset mapping files
  (attacks/imagenet_caffe_2012 lookup data).
- ``synthetic``: deterministic structured batches for tests/benchmarks
  (numpy's generator: the same arrays as the JAX package's for a seed).
"""

from __future__ import annotations

import os
import pickle

import numpy as np


def load_cifar10(root: str, train: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Read cifar-10-batches-py pickles -> (NHWC uint8, labels int32)."""
    base = os.path.join(root, "cifar-10-batches-py")
    files = (
        [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    )
    xs, ys = [], []
    for f in files:
        with open(os.path.join(base, f), "rb") as fh:
            d = pickle.load(fh, encoding="bytes")
        xs.append(d[b"data"])
        ys.extend(d[b"labels"])
    x = np.concatenate(xs).reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(x), np.asarray(ys, np.int32)


def load_cifar100(root: str, train: bool = False) -> tuple[np.ndarray, np.ndarray]:
    base = os.path.join(root, "cifar-100-python")
    with open(os.path.join(base, "train" if train else "test"), "rb") as fh:
        d = pickle.load(fh, encoding="bytes")
    x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(x), np.asarray(d[b"fine_labels"], np.int32)


def load_imagenet_synsets(caffe_dir: str) -> dict[str, int]:
    """synset_words.txt-style mapping wnid -> class index."""
    path = os.path.join(caffe_dir, "synset_words.txt")
    mapping = {}
    with open(path) as fh:
        for i, line in enumerate(fh):
            mapping[line.split()[0]] = i
    return mapping


def load_imagenet_folder(
    root: str, size: tuple[int, int] = (224, 224), limit: int | None = None
) -> tuple[np.ndarray, np.ndarray, list[str]]:
    """Class-per-subfolder val tree -> (NHWC uint8, labels, paths)."""
    from PIL import Image

    classes = sorted(
        d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
    )
    xs, ys, paths = [], [], []
    for ci, cls in enumerate(classes):
        for f in sorted(os.listdir(os.path.join(root, cls))):
            if not f.lower().endswith((".jpeg", ".jpg", ".png")):
                continue
            p = os.path.join(root, cls, f)
            img = Image.open(p).convert("RGB").resize(size, Image.BILINEAR)
            xs.append(np.asarray(img, np.uint8))
            ys.append(ci)
            paths.append(p)
            if limit and len(xs) >= limit:
                return np.stack(xs), np.asarray(ys, np.int32), paths
    return np.stack(xs), np.asarray(ys, np.int32), paths


def synthetic(
    n: int = 256, hw: tuple[int, int] = (32, 32), num_classes: int = 10, seed: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic structured images whose label is recoverable from pixels
    (class-dependent gradients + noise) — used by tests and smoke benches."""
    rng = np.random.default_rng(seed)
    h, w = hw
    y, x = np.mgrid[0:h, 0:w]
    labels = rng.integers(0, num_classes, n)
    imgs = np.empty((n, h, w, 3), np.uint8)
    for i, lb in enumerate(labels):
        phase = 2 * np.pi * lb / num_classes
        base = 127 + 90 * np.sin(2 * np.pi * (x + y) / (8 + lb) + phase)
        noise = rng.normal(0, 20, (h, w))
        ch = np.clip(base + noise, 0, 255)
        imgs[i, ..., 0] = ch
        imgs[i, ..., 1] = np.clip(255 - ch + rng.normal(0, 10, (h, w)), 0, 255)
        imgs[i, ..., 2] = (lb * 25) % 256
    return imgs, labels.astype(np.int32)
