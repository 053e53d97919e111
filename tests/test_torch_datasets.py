"""The port's dataset readers (``pipeline/datasets.py``) against the JAX package's.

Each test writes its own small CIFAR pickles, synset file or image tree
under ``tmp_path`` (nothing is downloaded); both packages read them, and
the arrays must be identical. ``synthetic`` gives the same arrays as the
JAX package's for a seed.
"""

import pickle

import numpy as np
import pytest
from PIL import Image

from imagetransformations_tpu.pipeline import datasets as jds

from imagetransformations_tpu_torch.pipeline import datasets as tds


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


@pytest.fixture
def cifar_root(tmp_path):
    rng = np.random.default_rng(0)
    base = tmp_path / "cifar-10-batches-py"
    base.mkdir()
    for name in ["test_batch"] + [f"data_batch_{i}" for i in range(1, 6)]:
        d = {b"data": rng.integers(0, 256, (4, 3072), dtype=np.uint8),
             b"labels": rng.integers(0, 10, 4).tolist()}
        with open(base / name, "wb") as fh:
            pickle.dump(d, fh)
    base = tmp_path / "cifar-100-python"
    base.mkdir()
    for name in ("train", "test"):
        d = {b"data": rng.integers(0, 256, (5, 3072), dtype=np.uint8),
             b"fine_labels": rng.integers(0, 100, 5).tolist()}
        with open(base / name, "wb") as fh:
            pickle.dump(d, fh)
    return str(tmp_path)


@pytest.mark.parametrize("train", [False, True])
def test_cifar10_equals_jax(cifar_root, train):
    x, y = tds.load_cifar10(cifar_root, train=train)
    assert x.shape == ((20 if train else 4), 32, 32, 3) and y.dtype == np.int32
    assert x.flags["C_CONTIGUOUS"]
    _same((x, y), jds.load_cifar10(cifar_root, train=train))


@pytest.mark.parametrize("train", [False, True])
def test_cifar100_equals_jax(cifar_root, train):
    x, y = tds.load_cifar100(cifar_root, train=train)
    assert x.shape == (5, 32, 32, 3)
    _same((x, y), jds.load_cifar100(cifar_root, train=train))


def test_imagenet_synsets_and_folder_equal_jax(tmp_path):
    (tmp_path / "caffe").mkdir()
    (tmp_path / "caffe" / "synset_words.txt").write_text(
        "n01440764 tench, Tinca tinca\nn01443537 goldfish\n")
    assert tds.load_imagenet_synsets(str(tmp_path / "caffe")) == \
        jds.load_imagenet_synsets(str(tmp_path / "caffe")) == {"n01440764": 0, "n01443537": 1}
    rng = np.random.default_rng(1)
    root = tmp_path / "val"
    for cls in ("n01443537", "n01440764"):
        (root / cls).mkdir(parents=True)
        for i, ext in enumerate(("png", "jpeg", "txt")):
            img = rng.integers(0, 256, (20 + i, 30, 3), dtype=np.uint8)
            if ext == "txt":
                (root / cls / f"{i}.txt").write_text("not an image")
            else:
                Image.fromarray(img).save(root / cls / f"{i}.{ext}")
    got = tds.load_imagenet_folder(str(root), size=(16, 12))
    assert got[0].shape == (4, 12, 16, 3) and got[1].tolist() == [0, 0, 1, 1]
    _same(got, jds.load_imagenet_folder(str(root), size=(16, 12)))
    _same(tds.load_imagenet_folder(str(root), size=(16, 12), limit=3),
          jds.load_imagenet_folder(str(root), size=(16, 12), limit=3))


@pytest.mark.parametrize("seed,hw", [(0, (32, 32)), (7, (20, 28))])
def test_synthetic_equals_jax(seed, hw):
    got = tds.synthetic(n=12, hw=hw, num_classes=5, seed=seed)
    assert got[0].shape == (12, *hw, 3) and got[0].dtype == np.uint8
    _same(got, jds.synthetic(n=12, hw=hw, num_classes=5, seed=seed))
