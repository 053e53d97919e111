"""The port's folder I/O (``pipeline/io.py``, ``pipeline/native_io.py``).

Mirrors the JAX package's tests/test_native_loader.py for the port's ctypes
binding of ``native/loader.cpp`` (built with g++ into the package's
``_build/``, never into ``native/``), and holds the port's loaders to the
JAX package's with the same codec: identical arrays. The folder walk, the
per-process shard, the CIFAR-10-C loaders, the batch writer and the CPU
route of ``prefetch_to_device`` are checked on small files under
``tmp_path``. Tests that need the native codec skip without g++, libjpeg or
libpng; ``prefetch_to_device`` on the card is in tests/test_torch_cuda_kernels.py.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from imagetransformations_tpu.pipeline import io as jio
from imagetransformations_tpu.pipeline import native_io as jnative

from imagetransformations_tpu_torch.pipeline import io as tio
from imagetransformations_tpu_torch.pipeline import native_io as tnative

@pytest.fixture
def native():
    if not tnative.native_available():
        pytest.skip(f"native codec unavailable: {tnative.build_error()}")
    return tnative


@pytest.fixture
def image_dir(tmp_path, rng):
    for i, (size, fmt) in enumerate([((40, 30), "PNG"), ((64, 64), "JPEG"),
                                     ((100, 50), "JPEG")]):
        img = rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)
        Image.fromarray(img).save(tmp_path / f"im{i}.{fmt.lower()}", format=fmt)
    return tmp_path


def test_decode_batch_exact_vs_pil(image_dir, native):
    for p in sorted(str(p) for p in image_dir.iterdir()):
        ref = np.asarray(Image.open(p).convert("RGB"))
        out = native.decode_batch([p], (ref.shape[1], ref.shape[0]))
        np.testing.assert_array_equal(out[0], ref)


def test_decode_batch_resized_matches_cv2_and_jax(image_dir, native):
    """Point-sampled bilinear (cv2 INTER_LINEAR) within 1 LSB; the JAX
    binding of the same loader gives the same bytes."""
    import cv2

    paths = sorted(str(p) for p in image_dir.iterdir())
    out = native.decode_batch(paths, (32, 32), n_threads=2)
    assert out.shape == (3, 32, 32, 3)
    for i, p in enumerate(paths):
        src = np.asarray(Image.open(p).convert("RGB"))
        ref = cv2.resize(src, (32, 32), interpolation=cv2.INTER_LINEAR)
        assert np.abs(out[i].astype(int) - ref.astype(int)).max() <= 1
    if jnative.native_available():
        np.testing.assert_array_equal(out, jnative.decode_batch(paths, (32, 32), n_threads=2))


def test_load_folder_native_equals_jax(image_dir, native):
    batch, paths = native.load_folder_images_native(str(image_dir), (16, 16))
    assert batch.shape == (3, 16, 16, 3) and len(paths) == 3
    jbatch, jpaths = jnative.load_folder_images_native(str(image_dir), (16, 16))
    assert paths == jpaths
    np.testing.assert_array_equal(batch, jbatch)


def test_load_folder_pil_equals_jax(image_dir):
    """PIL decode and PIL bilinear resize, as the JAX loader does."""
    for size in (None, (24, 20)):
        if size is None:
            for p in image_dir.iterdir():
                if p.name != "im0.png":
                    p.unlink()
        batch, paths = tio.load_folder_images(str(image_dir), size=size)
        jbatch, jpaths = jio.load_folder_images(str(image_dir), size=size)
        assert paths == jpaths and batch.dtype == np.uint8
        np.testing.assert_array_equal(batch, jbatch)


def test_missing_file_raises(image_dir, native):
    with pytest.raises(IOError):
        native.decode_batch([str(image_dir / "nope.jpeg")], (8, 8))


def test_native_encode_roundtrip(tmp_path, rng, native):
    base = rng.integers(90, 110, (3, 48, 48, 3)).astype(np.uint8)
    paths = [str(tmp_path / f"im{i}.jpeg") for i in range(3)]
    native.encode_batch(base, paths, quality=95, n_threads=2)
    back = native.decode_batch(paths, (48, 48))
    assert np.abs(back.astype(int) - base.astype(int)).max() <= 24  # jpeg loss
    with pytest.raises(ValueError):
        native.encode_batch(base[..., :1], paths)


def test_the_library_is_built_into_the_package(native):
    path = tnative.library_path()
    assert path.parent == tnative.BUILD_DIR and path.exists()
    assert path.parent.name == "_build"
    assert path.parent.parent.name == "imagetransformations_tpu_torch"
    assert tnative.SOURCE == tnative.SOURCE.parents[1] / "native" / "loader.cpp"


def test_save_batch_images_native_and_pil(tmp_path, rng):
    imgs = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    written = tio.save_batch_images(torch.from_numpy(imgs), ["a.png", "b.png"],
                                    str(tmp_path / "pil"), "x")
    assert [os.path.basename(p) for p in written] == ["a_x.jpeg", "b_x.jpeg"]
    jio.save_batch_images(imgs, ["a.png", "b.png"], str(tmp_path / "jax"), "x")
    for name in ("a_x.jpeg", "b_x.jpeg"):  # PIL's encoder, byte for byte
        assert (tmp_path / "pil" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    if tnative.native_available():
        tio.save_batch_images(imgs, ["a.png", "b.png"], str(tmp_path / "n"), "x", native=True)
        assert sorted(p.name for p in (tmp_path / "n").iterdir()) == ["a_x.jpeg", "b_x.jpeg"]


def test_walk_and_shard(tmp_path):
    for d in ("b", "a"):
        (tmp_path / d).mkdir()
        for f in ("z.PNG", "y.jpg", "x.txt", "w.jpeg"):
            (tmp_path / d / f).write_bytes(b"")
    paths = tio.walk_image_files(str(tmp_path))
    assert paths == jio.walk_image_files(str(tmp_path))
    assert len(paths) == 6 and not any(p.endswith(".txt") for p in paths)
    files = [f"f{i}" for i in range(10)]
    shards = [tio.shard_files_for_host(files, i, 3) for i in range(3)]
    assert shards == [jio.shard_files_for_host(files, i, 3) for i in range(3)]
    assert sum(shards, []) == files and {len(s) for s in shards} == {3, 4}
    assert tio.shard_files_for_host(files) == files
    with pytest.raises(ValueError):
        tio.shard_files_for_host(files, 3, 3)


def test_cifar10c_loaders_and_preview_export(tmp_path):
    root = tmp_path / "c10c"
    root.mkdir()
    rng = np.random.default_rng(0)
    hwc = rng.integers(0, 256, (4005, 2, 4, 3), dtype=np.uint8)
    np.save(root / "fog.npy", hwc)
    np.save(root / "snow.npy", hwc.transpose(0, 3, 1, 2))  # CHW on disk
    np.save(root / "labels.npy", np.zeros(4005, np.int64))
    assert [n for n, _ in tio.iter_corruption_files(str(root))] == ["fog", "snow"]
    for name in ("fog", "snow"):
        p = str(root / f"{name}.npy")
        np.testing.assert_array_equal(tio.load_cifar10c_npy(p), hwc)
        np.testing.assert_array_equal(tio.load_cifar10c_npy(p, sample_only=True),
                                      hwc[list(tio.SEVERITY_SAMPLE_INDICES)])
        np.testing.assert_array_equal(tio.load_cifar10c_npy(p, severity=1),
                                      jio.load_cifar10c_npy(p, severity=1))
    written = tio.export_corruption_samples(str(root), str(tmp_path / "out"))
    assert len(written) == 10 and written == jio.export_corruption_samples(
        str(root), str(tmp_path / "out"))
    np.testing.assert_array_equal(np.asarray(Image.open(written[2])), hwc[2002])


def test_batched_and_cpu_prefetch(rng):
    arr = rng.integers(0, 256, (7, 4, 4, 3), dtype=np.uint8)
    chunks = list(tio.batched(arr, 3))
    assert [len(c) for c in chunks] == [3, 3, 1]
    got = list(tio.prefetch_to_device(tio.batched(arr, 3), device="cpu"))
    assert all(isinstance(g, torch.Tensor) and g.device.type == "cpu" for g in got)
    np.testing.assert_array_equal(torch.cat(got).numpy(), arr)
    with pytest.raises(ValueError):
        list(tio.prefetch_to_device(chunks, buffer_size=0, device="cpu"))


def test_prefetch_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(tio.prefetch_to_device([np.zeros((1, 2, 2, 3), np.uint8)]))


def test_empty_folder(tmp_path):
    batch, paths = tio.load_folder_images(str(tmp_path))
    assert paths == [] and batch.shape == (0, 0, 0, 3)
    batch, paths = tnative.load_folder_images_native(str(tmp_path), (8, 6))
    assert paths == [] and batch.shape == (0, 6, 8, 3)
