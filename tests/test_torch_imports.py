"""The PyTorch port stands alone: no JAX, nothing of the JAX package.

An AST scan of every module of imagetransformations_tpu_torch/ and of
chip_smoke.py, and a subprocess that imports and runs the port with jax and
imagetransformations_tpu blocked.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "imagetransformations_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "imagetransformations_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "tools" / "profile_torch_port.py",
                                         ROOT / "tools" / "time_blur.py",
                                         ROOT / "tools" / "time_resample.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_port_files_found():
    names = {p.relative_to(ROOT).as_posix() for p in _port_files()}
    assert "imagetransformations_tpu_torch/ops/hopper/megakernel.py" in names
    assert "imagetransformations_tpu_torch/pipeline/chain.py" in names
    assert "imagetransformations_tpu_torch/pipeline/batch.py" in names
    assert "imagetransformations_tpu_torch/ops/hopper/resample.py" in names
    assert "imagetransformations_tpu_torch/ops/hopper/rotate_gather.py" in names
    assert "imagetransformations_tpu_torch/ops/warp.py" in names
    assert "imagetransformations_tpu_torch/ops/hopper/blur.py" in names
    assert "imagetransformations_tpu_torch/ops/hopper/shear.py" in names
    assert "imagetransformations_tpu_torch/ops/histogram.py" in names
    assert "imagetransformations_tpu_torch/ops/elementwise.py" in names
    assert "imagetransformations_tpu_torch/ops/noise.py" in names
    assert "chip_smoke.py" in names


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree) if _forbidden(m)]
    assert not bad, f"{path}: imports {bad}"


def test_forbidden_rule_spares_the_port_itself():
    assert _forbidden("imagetransformations_tpu.ops.pallas")
    assert _forbidden("jax.numpy")
    assert not _forbidden("imagetransformations_tpu_torch.ops")


def test_port_runs_with_jax_blocked():
    code = """
import sys
for name in ("jax", "jaxlib", "imagetransformations_tpu"):
    sys.modules[name] = None  # any import of these now raises ImportError
import numpy as np
import imagetransformations_tpu_torch as port
from imagetransformations_tpu_torch.ops.hopper import _lib, megakernel, shear
from imagetransformations_tpu_torch.core import image
from imagetransformations_tpu_torch.ops import stencil
x = np.random.default_rng(0).integers(0, 256, (1, 40, 36, 3), dtype=np.uint8)
chain = [port.OpSpec("blur", {"radius": 1.5}), port.OpSpec("rotation", {"angle": 15.0}),
         port.OpSpec("grayscale")]
out = port.build_chain_fn(chain, device="cpu")(x)
assert tuple(out.shape) == x.shape
angles = np.asarray([7.5], np.float32)
out = port.fused_blur_rotate_batched(out, 0.0, angles, stream=False)
res = port.apply_all_transformations(x, 0, device="cpu")
assert sorted(res) == sorted(port.PARAM_GRIDS)
res = port.apply_all_transformations(x, 0, device="cpu", pil_parity_scale_shear=False,
                                     pil_parity_rotation=True)
assert sorted(res) == sorted(port.PARAM_GRIDS)
import torch
t = torch.from_numpy(x)
assert port.apply_rotation(t, 60.0).shape == t.shape and port.random_zoom(t, 0.3).shape == t.shape
from imagetransformations_tpu_torch.ops.hopper import blur
from imagetransformations_tpu_torch.ops import histogram, noise
assert port.blur_separable(t, 1.5).shape == t.shape
assert port.shear_rows(t, np.zeros(40, np.float32), postop="grayscale").shape == t.shape
assert port.shear_rows_per_image(t, np.zeros((1, 40), np.float32)).shape == t.shape
assert port.rotate_3shear(t, 70.0).shape == port.blur_rotate_fused(t, 1.5, 10.0).shape == t.shape
ops = [port.OpSpec(n, p) for n, p in (("blur", {"radius": 1.5}), ("rotation", {"angle": 60.0}),
       ("histogram_equalization", {}), ("shot_noise", {"lam": 10.0}), ("scale", {"factor": 1.1}))]
g = torch.Generator().manual_seed(0)
for strict in (False, True):
    assert port.build_chain_fn(ops, strict_parity=strict, device="cpu")(x, g).shape == x.shape
print("ok")
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_kernel_build_is_hopper_and_fma_free():
    """The CUDA sources are built for sm_90a without FMA contraction; the
    flags are part of the build hash, and nothing is built at import."""
    from imagetransformations_tpu_torch.ops.hopper import _lib

    flags = " ".join(_lib.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-fmad=false" in flags
    for name in _lib.SIGNATURES:
        assert (_lib.CSRC / f"{name}.cu").is_file()
        assert _lib.library_path(name).parent == _lib.BUILD_DIR
    assert _lib._loaded == {} or all(n in _lib.SIGNATURES for n in _lib._loaded)
