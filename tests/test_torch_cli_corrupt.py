"""The port's ``corrupt`` command (``python -m imagetransformations_tpu_torch
corrupt``) on the CPU, against the JAX package's on the same folder.

Mirrors tests/test_cli.py's corrupt cases (a subset run writes its 8 files
with the JAX names; the validation messages). On the deterministic
corruptions the PNGs are within the generators' budgets of the JAX CLI's:
1 LSB (defocus_blur, zoom_blur, brightness, contrast, pixelate,
gaussian_blur, saturate), the JPEG budget (more than 1 LSB on at most 0.5%
of values, at most 32), 0 LSB (translation), and for rotation, where the
port follows Pillow, ROADMAP C.2.9's 0.5% of pixels. The random ones draw
from one generator a (corruption, severity) cell: one seed gives the same
bytes, whatever else the run asks for; another seed other bytes. The
default device is the card, and without one the command fails.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from imagetransformations_tpu.__main__ import main as jmain

from imagetransformations_tpu_torch.__main__ import main

DETERMINISTIC = {"defocus_blur": 1, "zoom_blur": 1, "brightness": 1, "contrast": 1,
                 "pixelate": 1, "gaussian_blur": 1, "saturate": 1, "translation": 0}
RANDOM = ("gaussian_noise", "shot_noise", "impulse_noise", "glass_blur", "motion_blur", "snow",
          "frost", "fog", "elastic_transform", "speckle_noise", "spatter")


def _write_images(d, n=2, size=(32, 32)):
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)).save(
            os.path.join(d, f"im{i}.png"))


def _read(d):
    return {f: np.asarray(Image.open(os.path.join(d, f))) for f in sorted(os.listdir(d))}


def _lsb(a, b):
    return np.abs(a.astype(np.int64) - b.astype(np.int64))


def test_cli_corrupt_subset(tmp_path, capsys):
    in_dir, out_dir = str(tmp_path / "in"), str(tmp_path / "c")
    _write_images(in_dir)
    main(["corrupt", in_dir, out_dir, "--corruptions=gaussian_noise,brightness",
          "--severities=1,5", "--device=cpu"])
    outs = sorted(os.listdir(out_dir))
    assert len(outs) == 8
    assert "im0_gaussian_noise_severity1.png" in outs
    assert "im1_brightness_severity5.png" in outs
    assert "wrote 8 corrupted images (2 corruptions x 2 severities)" in capsys.readouterr().out


def test_cli_corrupt_validates_args(tmp_path):
    in_dir = str(tmp_path / "in")
    _write_images(in_dir, n=1)
    with pytest.raises(SystemExit, match="unknown corruptions"):
        main(["corrupt", in_dir, str(tmp_path / "o"), "--corruptions=rain", "--device=cpu"])
    with pytest.raises(SystemExit, match="severities must be"):
        main(["corrupt", in_dir, str(tmp_path / "o"), "--severities=0,6", "--device=cpu"])
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    with pytest.raises(SystemExit, match="no images found"):
        main(["corrupt", empty, str(tmp_path / "o"), "--device=cpu"])


def test_cli_corrupt_defaults_to_the_card(tmp_path, monkeypatch):
    in_dir = str(tmp_path / "in")
    _write_images(in_dir, n=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["corrupt", in_dir, str(tmp_path / "o"), "--corruptions=brightness"])


def test_cli_corrupt_unique_stems(tmp_path):
    in_dir = tmp_path / "in"
    _write_images(str(in_dir / "a"), n=1)
    _write_images(str(in_dir / "b"), n=1)
    out_dir = str(tmp_path / "o")
    main(["corrupt", str(in_dir), out_dir, "--corruptions=contrast", "--severities=2",
          "--device=cpu"])
    assert sorted(os.listdir(out_dir)) == ["a_im0_contrast_severity2.png",
                                           "b_im0_contrast_severity2.png"]


def test_cli_corrupt_deterministic_within_budget_of_jax(tmp_path, capsys):
    in_dir = str(tmp_path / "in")
    _write_images(in_dir)
    names = ",".join([*DETERMINISTIC, "jpeg_compression", "rotation"])
    port, jax_ = str(tmp_path / "port"), str(tmp_path / "jax")
    main(["corrupt", in_dir, port, f"--corruptions={names}", "--severities=2,5", "--device=cpu"])
    jmain(["corrupt", in_dir, jax_, f"--corruptions={names}", "--severities=2,5"])
    got, want = _read(port), _read(jax_)
    assert sorted(got) == sorted(want) and len(got) == 2 * 10 * 2
    for fn, arr in got.items():
        d = _lsb(arr, want[fn])
        name = fn.split("_", 1)[1].rsplit("_severity", 1)[0]
        if name == "jpeg_compression":
            assert (d > 1).mean() <= 0.005 and d.max() <= 32, fn
        elif name == "rotation":
            assert (d > 0).any(axis=-1).mean() <= 0.005, fn
        else:
            assert d.max() <= DETERMINISTIC[name], fn


def test_cli_corrupt_random_seeded(tmp_path):
    in_dir = str(tmp_path / "in")
    _write_images(in_dir)
    runs = {}
    for label, extra in (("a", ["--seed=4"]), ("b", ["--seed=4"]), ("c", ["--seed=5"])):
        out = str(tmp_path / label)
        main(["corrupt", in_dir, out, f"--corruptions={','.join(RANDOM)}", "--severities=3",
              "--device=cpu", *extra])
        runs[label] = {f: open(os.path.join(out, f), "rb").read() for f in os.listdir(out)}
    assert runs["a"] == runs["b"]
    assert all(runs["a"][f] != runs["c"][f] for f in runs["a"])
    # one cell's bytes do not depend on the other cells of the run
    alone = str(tmp_path / "alone")
    main(["corrupt", in_dir, alone, "--corruptions=fog", "--severities=3", "--device=cpu",
          "--seed=4"])
    for f in os.listdir(alone):
        assert open(os.path.join(alone, f), "rb").read() == runs["a"][f]
