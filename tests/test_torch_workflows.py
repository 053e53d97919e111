"""The port's ``workflows.transform_folder`` (transformation.py __main__).

Mirrors the JAX package's tests/test_workflows.py::test_transform_folder:
a folder of two images through the 8-type sweep gives 16 files. The port's
draws come from a ``torch.Generator`` and cannot replay ``jax.random``'s, so
the files are bound to their values instead: rerunning the sweep with the
same generator seed, each file's name carries its image's value
(``{stem}_{type}_{round(v, 2)}_corrupted.jpeg``) and its bytes equal PIL's
encoding of the recomputed image. With ``size`` and the native codec the
decode and encode go through ``native/loader.cpp``.
"""

import io
import os

import numpy as np
import pytest
import torch
from PIL import Image

import imagetransformations_tpu_torch as port
from imagetransformations_tpu_torch.pipeline import native_io
from imagetransformations_tpu_torch.pipeline.io import load_folder_images
from imagetransformations_tpu_torch.pipeline.chain import OpSpec, build_chain_fn
from imagetransformations_tpu_torch.workflows import chain_folder, transform_folder

TYPES = {"scale", "rotation", "lighten_darken", "gaussian_noise", "translation", "contrast",
         "blur", "shear"}


@pytest.fixture
def src(tmp_path, rng):
    d = tmp_path / "src"
    d.mkdir()
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)).save(d / f"im{i}.jpeg")
    return d


def test_transform_folder(tmp_path, src):
    stats = {}
    out = transform_folder(str(src), str(tmp_path / "dst"), device="cpu", stats=stats)
    assert set(out) == TYPES
    assert len(list((tmp_path / "dst").iterdir())) == 16  # 2 imgs x 8 types
    assert stats["images"] == 2 and all(stats[k] >= 0 for k in
                                        ("decode_s", "h2d_s", "compute_s", "d2h_s", "encode_s"))


def test_files_bind_to_the_recomputed_sweep(tmp_path, src):
    gen = torch.Generator().manual_seed(11)
    written = transform_folder(str(src), str(tmp_path / "dst"), generator=gen, device="cpu")
    imgs, paths = load_folder_images(str(src))
    res = port.apply_all_transformations(imgs, torch.Generator().manual_seed(11), device="cpu")
    for t, (vals, arrs) in res.items():
        for i, p in enumerate(paths):
            stem = os.path.splitext(os.path.basename(p))[0]
            name = f"{stem}_{t}_{round(float(vals[i]), 2)}_corrupted.jpeg"
            assert written[t][i] == name
            buf = io.BytesIO()
            Image.fromarray(arrs[i].numpy()).save(buf, format="JPEG")
            assert (tmp_path / "dst" / name).read_bytes() == buf.getvalue(), name


def test_native_codec_with_a_size(tmp_path, src):
    if not native_io.native_available():
        pytest.skip(f"native codec unavailable: {native_io.build_error()}")
    written = transform_folder(str(src), str(tmp_path / "dst"), size=(24, 20), device="cpu")
    assert set(written) == TYPES
    files = sorted((tmp_path / "dst").iterdir())
    assert len(files) == 16
    assert np.asarray(Image.open(files[0])).shape == (20, 24, 3)


def test_empty_folder_and_default_device(tmp_path, monkeypatch):
    (tmp_path / "empty").mkdir()
    assert transform_folder(str(tmp_path / "empty"), str(tmp_path / "o"), device="cpu") == {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        transform_folder(str(tmp_path / "empty"), str(tmp_path / "o"))


def test_chain_folder_writes_the_chain_fn_array(tmp_path, src):
    chain = [OpSpec("blur", {"radius": 1.5}), OpSpec("rotation", {"angle": 15.0}),
             OpSpec("grayscale")]
    stats = {}
    written = chain_folder(str(src), str(tmp_path / "dst"), chain, device="cpu", stats=stats)
    imgs, paths = load_folder_images(str(src))
    arr = build_chain_fn(chain, device="cpu")(imgs).numpy()
    assert [os.path.basename(p) for p in written] == ["im0_chained.jpeg", "im1_chained.jpeg"]
    for a, p in zip(arr, written):
        buf = io.BytesIO()
        Image.fromarray(a).save(buf, format="JPEG")
        assert open(p, "rb").read() == buf.getvalue()
    assert stats["images"] == 2 and stats["compute_s"] >= 0
