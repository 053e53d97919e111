"""The port's CLI (``python -m imagetransformations_tpu_torch``).

Mirrors the JAX package's tests/test_cli.py for the commands the port has
(``transform``, ``chain``): ``parse_ops`` semantics, ``chain`` end to end on
a tmp folder, its argument errors, unknown commands and help. The array the
port's ``chain`` saves equals the port's ``build_chain_fn`` at 0 LSB, and
the JAX CLI's within that chain's budget (the stream chain: <= 1 LSB on
<= 0.1% of values, tests/test_torch_chain.py, measured 0 here; the strict
chain, whose blur is cv2's and rotation PIL's: <= 2 LSB on <= 10%,
measured 1 LSB on 7.7%); the files equal PIL's encoding of that array, byte
for byte, and the JAX CLI's files where the arrays are equal. The commands
run with ``--device=cpu``; the default is the card, and without one they
fail. ``sweep`` and ``report`` run in tests/test_torch_cli_sweep.py,
``corrupt`` in tests/test_torch_cli_corrupt.py.
"""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from imagetransformations_tpu.__main__ import main as jmain
from imagetransformations_tpu.pipeline import chain as jchain

from imagetransformations_tpu_torch.__main__ import main, parse_ops
from imagetransformations_tpu_torch.pipeline import chain as tchain
from imagetransformations_tpu_torch.pipeline import io as tio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_parse_ops_default_and_explicit_keys():
    chain = parse_ops("blur:1.5,rotation:15,grayscale,blur:radius=2.5")
    assert [c.name for c in chain] == ["blur", "rotation", "grayscale", "blur"]
    assert chain[0].params == {"radius": 1.5}
    assert chain[1].params == {"angle": 15.0}
    assert not chain[2].params
    assert chain[3].params == {"radius": 2.5}
    assert all(isinstance(c, tchain.OpSpec) for c in chain)


def test_parse_ops_motion_blur_int_and_errors():
    (op,) = parse_ops("motion_blur:7")
    assert op.params == {"ksize": 7} and isinstance(op.params["ksize"], int)
    with pytest.raises(SystemExit, match="unknown op"):
        parse_ops("sepia:1.0")
    with pytest.raises(SystemExit, match="needs a value"):
        parse_ops("blur")
    with pytest.raises(SystemExit, match="empty chain"):
        parse_ops(" , ")


def _write_images(d, n=2, size=(40, 32)):
    os.makedirs(d, exist_ok=True)
    rng = np.random.default_rng(0)
    for i in range(n):
        Image.fromarray(
            rng.integers(0, 256, (size[1], size[0], 3), dtype=np.uint8)
        ).save(os.path.join(d, f"im{i}.png"))


def _pil_jpeg(arr) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG")
    return buf.getvalue()


def test_cli_chain_end_to_end(tmp_path, capsys):
    in_dir, out_dir = str(tmp_path / "in"), str(tmp_path / "out")
    _write_images(in_dir)
    main(["chain", in_dir, out_dir, "--ops=blur:1.0,grayscale", "--device=cpu"])
    outs = sorted(os.listdir(out_dir))
    assert len(outs) == 2 and all("chained" in f for f in outs)
    arr = np.asarray(Image.open(os.path.join(out_dir, outs[0])).convert("RGB"))
    assert np.array_equal(arr[..., 0], arr[..., 1])
    assert "applied 2 ops to 2 images" in capsys.readouterr().out


@pytest.mark.parametrize("spec,strict", [("blur:1.5,rotation:15,grayscale", False),
                                         ("blur:1.5,rotation:15,grayscale", True)])
def test_cli_chain_saves_the_chain_fn_array_and_matches_jax(tmp_path, spec, strict):
    in_dir = str(tmp_path / "in")
    _write_images(in_dir, n=3, size=(48, 40))
    flags = ["--strict-parity"] if strict else []
    main(["chain", in_dir, str(tmp_path / "port"), f"--ops={spec}", "--device=cpu", *flags])
    jmain(["chain", in_dir, str(tmp_path / "jax"), f"--ops={spec}", *flags])
    imgs, paths = tio.load_folder_images(in_dir)
    ops = parse_ops(spec)
    arr = tchain.build_chain_fn(ops, strict_parity=strict, device="cpu")(imgs).numpy()
    jarr = np.asarray(jchain.build_chain_fn(
        [jchain.OpSpec(o.name, o.params) for o in ops], strict_parity=strict)(jnp.asarray(imgs)))
    err = np.abs(arr.astype(int) - jarr.astype(int))
    if strict:  # cv2's integer blur and PIL's rotation against JAX's f32 ones
        assert err.max() <= 2 and (err > 0).mean() <= 0.10, (err.max(), (err > 0).mean())
    else:
        assert err.max() <= 1 and (err > 0).mean() <= 0.001, (err.max(), (err > 0).mean())
    for a, ja, p in zip(arr, jarr, paths):
        name = f"{os.path.splitext(os.path.basename(p))[0]}_chained.jpeg"
        data = (tmp_path / "port" / name).read_bytes()
        assert data == _pil_jpeg(a)
        assert ((tmp_path / "jax" / name).read_bytes() == data) == np.array_equal(a, ja)


def test_cli_chain_requires_ops_and_images(tmp_path):
    in_dir, out_dir = str(tmp_path / "in"), str(tmp_path / "out")
    _write_images(in_dir)
    with pytest.raises(SystemExit, match="requires --ops"):
        main(["chain", in_dir, out_dir, "--device=cpu"])
    empty = str(tmp_path / "empty")
    os.makedirs(empty)
    with pytest.raises(SystemExit, match="no images found"):
        main(["chain", empty, out_dir, "--ops=blur:1.0", "--device=cpu"])
    with pytest.raises(SystemExit, match="usage"):
        main(["chain", in_dir, "--ops=blur:1.0", "--device=cpu"])


def test_cli_defaults_to_the_card(tmp_path, monkeypatch):
    in_dir = str(tmp_path / "in")
    _write_images(in_dir, n=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in (["transform", in_dir, str(tmp_path / "t")],
                ["chain", in_dir, str(tmp_path / "c"), "--ops=blur:1.0"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(cmd)


@pytest.mark.parametrize("cmd,item", [("sweep", "A.6"), ("report", "A.6")])
def test_unported_commands_name_their_roadmap_item(cmd, item, tmp_path, monkeypatch):
    """The commands of ROADMAP {item} are ported: they no longer exit naming
    it, and run on the card by default (without one they fail); so does the
    sweep's --data-parallel, ported with ROADMAP A.9
    (tests/test_torch_cli_sweep.py runs both commands,
    tests/test_torch_evaluate_sharded.py the sweep on a CPU mesh)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [cmd, f"--data-root={tmp_path}", f"--out-dir={tmp_path / 'out'}"]
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv)
    if cmd == "sweep":
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv + ["--data-parallel=true"])


def test_cli_unknown_command_and_help(capsys):
    with pytest.raises(SystemExit, match="unknown command"):
        main(["frobnicate"])
    with pytest.raises(SystemExit):
        main(["--help"])
    assert "transform IN_DIR OUT_DIR" in capsys.readouterr().out


def test_python_dash_m_transform(tmp_path):
    """``python -m imagetransformations_tpu_torch transform IN OUT`` in a
    process of its own, on the CPU."""
    in_dir, out_dir = str(tmp_path / "in"), str(tmp_path / "out")
    _write_images(in_dir, n=2, size=(32, 32))
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-m", "imagetransformations_tpu_torch", "transform",
                          in_dir, out_dir, "--device=cpu", "--seed=3", "--stats"],
                         cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "wrote 16 transformed images (8 transform types)" in res.stdout
    assert len(os.listdir(out_dir)) == 16
    stats = json.loads(res.stdout.strip().splitlines()[-1])
    assert stats["images"] == 2 and {"decode_s", "h2d_s", "compute_s", "d2h_s",
                                     "encode_s"} <= set(stats)
