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
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sklearn", "imagetransformations_tpu")


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                         ROOT / "tools" / "check_spans.py",
                                         ROOT / "tools" / "time_blur.py",
                                         ROOT / "tools" / "time_resample.py",
                                         ROOT / "tools" / "run_uq_phases.py",
                                         ROOT / "tools" / "run_adapt_phases.py",
                                         ROOT / "tools" / "run_mesh_phases.py",
                                         ROOT / "tools" / "run_process_mesh.py"]


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
    for module in ("pipeline/io.py", "pipeline/native_io.py", "pipeline/datasets.py",
                   "workflows.py", "__main__.py", "utils/config.py", "core/precision.py",
                   "models/resnet.py", "models/simple_cnn.py", "models/bayesian.py",
                   "models/imagenet.py", "models/convert.py", "models/training.py",
                   "uq/metrics.py", "uq/calibration.py", "uq/mahalanobis.py", "uq/odin.py",
                   "evalx/harness.py", "evalx/report.py", "utils/demo.py",
                   "uq/mc.py", "uq/swag.py", "uq/sgld.py", "uq/laplace.py", "uq/knn.py",
                   "evalx/analysis.py", "attacks/fgsm.py", "attacks/pgd.py",
                   "adapt/refine.py", "utils/checkpoint.py", "adapt/tent.py",
                   "adapt/conditional.py", "adapt/tta.py", "adapt/matta.py", "adapt/posthoc.py",
                   "adapt/augmix.py", "adapt/_optim.py", "utils/profiling.py",
                   "adapt/patches.py", "adapt/evolution.py", "pipeline/sharding.py",
                   "ops/sharded_stencil.py", "core/mesh.py"):
        assert f"imagetransformations_tpu_torch/{module}" in names
    assert "chip_smoke.py" in names
    assert "tools/run_process_mesh.py" in names


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree) if _forbidden(m)]
    assert not bad, f"{path}: imports {bad}"


@pytest.mark.parametrize("path", sorted([*(PORT / "core").glob("*.py"),
                                         *(PORT / "models").glob("*.py")]),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_core_and_models_import_no_pipeline(path):
    """The mesh types and collectives live in ``core.mesh``: the models
    layer (BatchNorm's cross-rank statistics, the train step) reads them
    there, never through the transform pipeline."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree) if m.startswith("imagetransformations_tpu_torch.pipeline")]
    assert not bad, f"{path}: imports {bad}"


def test_forbidden_rule_spares_the_port_itself():
    assert _forbidden("imagetransformations_tpu.ops.pallas")
    assert _forbidden("jax.numpy")
    assert not _forbidden("imagetransformations_tpu_torch.ops")


def test_port_runs_with_jax_blocked():
    code = """
import sys
for name in ("jax", "jaxlib", "optax", "sklearn", "imagetransformations_tpu"):
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
import tempfile
from imagetransformations_tpu_torch import __main__ as cli, workflows
from imagetransformations_tpu_torch.pipeline import datasets, io, native_io
from imagetransformations_tpu_torch.utils import config
assert datasets.synthetic(n=2)[0].shape == (2, 32, 32, 3)
assert config.FrameworkConfig.from_cli(["--device=cpu"]).device == "cpu"
assert [b.shape[0] for b in io.prefetch_to_device(io.batched(x, 1), device="cpu")] == [1]
with tempfile.TemporaryDirectory() as d:
    assert workflows.transform_folder(d, d, device="cpu") == {}
    assert io.load_folder_images(d)[1] == []
    assert native_io.load_folder_images_native(d, (8, 8))[1] == []
assert [o.name for o in cli.parse_ops("blur:1.5,grayscale")] == ["blur", "grayscale"]
from imagetransformations_tpu_torch import models, uq
from imagetransformations_tpu_torch.evalx import harness, report
from imagetransformations_tpu_torch.models import training
from imagetransformations_tpu_torch.uq import calibration, mahalanobis, odin
from imagetransformations_tpu_torch.utils import demo
net = models.CifarResNet((1, 1, 1), device="cpu")
assert models.load_torch_state_dict(models.CifarResNet((1, 1, 1), device="cpu"),
                                   net.state_dict())
space = models.resnet.cifar_model_space
res = harness.evaluate_batched(net, space, x[:, :32, :32], np.zeros(1, np.int32), device="cpu")
assert 0.0 <= res["accuracy"] <= 1.0 and sorted(res["metrics"]) == sorted(harness.DEFAULT_METRICS)
sweep = harness.corruption_sweep(net, space, x[:, :32, :32], np.zeros(1, np.int32),
                                 corruption_names=("rotation",), severities=(1,), device="cpu")
assert report.summary_table(sweep)[0]["corruption"] == "rotation"
assert float(calibration.auroc(torch.tensor([0.1, 0.9]), torch.tensor([0.0, 1.0]))) == 1.0
assert training.make_train_step and odin.odin_score and mahalanobis.fit and demo.get_data
assert uq.shannon_entropy(torch.zeros(1, 4)).shape == (1,)
from imagetransformations_tpu_torch import adapt, attacks
from imagetransformations_tpu_torch.adapt import refine
from imagetransformations_tpu_torch.evalx import analysis
from imagetransformations_tpu_torch.uq import knn, laplace, mc, sgld, swag
from imagetransformations_tpu_torch.utils import checkpoint
xm = space(torch.from_numpy(x[:, :32, :32]))
y0 = torch.zeros(1, dtype=torch.int64)
assert attacks.pgd_attack(net, xm, y0, torch.Generator(), steps=1).shape == xm.shape
assert refine.refine_batch(net, xm, torch.ones(1, dtype=torch.bool), max_iters=1)[1] <= 1
with tempfile.TemporaryDirectory() as d:
    out = workflows.swag_pipeline(net, lambda: [(xm, y0)] * 2, xm, torch.Generator(),
                                  num_weight_samples=2, eval_mc_samples=1, max_rank=2,
                                  device="cpu")
    checkpoint.save_checkpoint(d, {"n": out["swag_state"].n_models}, step=1)
    assert checkpoint.load_checkpoint(d)["n"] == 2
assert workflows.refinement_pipeline(net, space, x[:, :32, :32], np.zeros(1, np.int32),
                                     max_iters=1, device="cpu")["n"] == 1
assert analysis.flip_analysis(torch.zeros(1, 2), torch.zeros(1, 2), y0)["n"] == 1
assert mc.bald(torch.zeros(2, 1, 3)).shape == (1,) and sgld.SGLD and laplace.fit and knn.top_k_indices
from imagetransformations_tpu_torch.adapt import augmix, conditional, matta, posthoc, tent, tta
from imagetransformations_tpu_torch.utils import profiling
x8 = np.repeat(x[:, :32, :32], 2, axis=0)
x8[1] = 7  # a flat image: below the entropy gate
xm8 = space(torch.from_numpy(x8))
y8 = torch.zeros(2, dtype=torch.int64)
batches = [(xm8, torch.from_numpy(x8))] * 2
for proto in ("continuous", "reset", "conditional"):
    assert 0.0 <= tent.evaluate_with_tent(net, batches, [y8, y8], protocol=proto, device="cpu") <= 1
sweep = workflows.tent_sweep(net, ("brightness",), (1,), x8, y8, space, batch_size=1,
                             device="cpu")
assert sorted(sweep["brightness"][1]) == ["baseline", "conditional", "continuous", "reset"]
res = conditional.conditional_transform_eval(net, space, x8, y8, chain, device="cpu")
assert res["n_flagged"] == 1
probs = tta.predict_with_tta(lambda u8: net(space(u8)), x8, torch.Generator(), device="cpu")
vp = tta.adaptive_view_probs(lambda u8: net(space(u8)), x8, torch.Generator(), device="cpu")
assert probs.shape == (2, 10) and tta.fit_adaptive_weights(vp, y8).shape == (5,)
assert matta.fit_matta_weights(vp, y8, steps=2).shape == (5, 10)
iso = posthoc.IsotonicRegressionCalibration().fit(probs, y8)
assert iso.calibrate(probs).shape == (2, 10)
assert posthoc.EnsembleTemperatureScaling().fit(net(xm8), y8, steps=2).weights.shape == (5,)
assert augmix.augmix(x8, torch.Generator(), device="cpu").shape == x8.shape
assert profiling.op_throughput(lambda a: a + 1, torch.from_numpy(x8), 1, 2)["ms_per_op"] > 0
from imagetransformations_tpu_torch import core, evalx, pipeline, utils
names = {port: ("as_batch", "as_float", "to_uint8_rint", "to_uint8_trunc"),
         core: ("as_batch", "as_float", "to_uint8_rint", "to_uint8_trunc", "restore_layout",
                "PARAM_GRIDS", "ParamGrid", "sample_params", "sample_all"),
         pipeline: ("Chain", "OpSpec", "build_chain_fn", "apply_all_transformations",
                    "transform_batch", "load_folder_images", "prefetch_to_device",
                    "shard_files_for_host", "global_batch_from_host_shards", "data_mesh",
                    "shard_images", "sharded_apply"),
         evalx: ("CORRUPTIONS", "corrupt", "evaluate_batched", "corruption_sweep",
                 "analyze_uncertainty_thresholds", "evaluate_sharded"),
         utils: ("FrameworkConfig", "RefineConfig", "SweepConfig", "save_checkpoint",
                 "load_checkpoint", "op_throughput", "trace"),
         adapt: ("augmix", "conditional", "evolution", "matta", "patches", "posthoc", "refine",
                 "tent", "tta")}
missing = [f"{m.__name__}.{n}" for m, ns in names.items() for n in ns if not hasattr(m, n)]
assert not missing, missing
assert sorted(core.sample_all(torch.Generator(), 3)) == sorted(port.PARAM_GRIDS)
assert pipeline.transform_batch(x, chain, device="cpu").shape == x.shape
from imagetransformations_tpu_torch.adapt import evolution, patches
from imagetransformations_tpu_torch.ops.sharded_stencil import sharded_gaussian_blur
from imagetransformations_tpu_torch.pipeline import sharding
x01 = torch.from_numpy(x8).float() / 255.0
assert patches.adet_operator(x01, torch.ones(4, 4, 3), torch.Generator()).shape == x01.shape
assert patches.restorative_patches_per_image(lambda z: net(z.permute(0, 3, 1, 2)), x01,
                                             patch_hw=(3, 3), iters=1, device="cpu")[1].shape[0] == 2
ind = evolution.Individual([("blur", 1.0), ("sharpness", 1.5)])
assert 0.5 <= evolution.fitness_fn(net, space, x8, ind, device="cpu") <= 1.0
mesh = pipeline.data_mesh(2, device="cpu")
assert sharding.sharded_chain_fn(chain, mesh)(x8).gather().shape == x8.shape
assert sharded_gaussian_blur(x8, 1.5, mesh).gather().shape == x8.shape
assert pipeline.global_batch_from_host_shards(x8, mesh).shape == x8.shape
assert 0.0 <= harness.evaluate_sharded(net, space, x8, y8, mesh)["accuracy"] <= 1.0
assert pipeline.build_chain_fn(chain, jit=False, device="cpu")(x8).shape == x8.shape
sys.path.insert(0, "tools")
import run_process_mesh
pmesh = sharding.init_process_mesh("cpu", init_method="file://" + tempfile.mktemp(),
                                   rank=0, world_size=1)
assert (pmesh.backend, pmesh.shape) == ("gloo", {"data": 1})
assert pipeline.shard_files_for_host(["a", "b"]) == ["a", "b"]
assert pipeline.global_batch_from_host_shards(x8, pmesh).gather().shape == x8.shape
assert sharded_gaussian_blur(x8, 1.5, pmesh).gather().shape == x8.shape
assert 0.0 <= harness.evaluate_sharded(net, space, x8, y8, pmesh)["accuracy"] <= 1.0
step = training.make_train_step(net, torch.optim.SGD(net.parameters(), lr=0.0))
assert step(sharding.shard_images(xm8, pmesh), y8)[0].shape == ()
assert run_process_mesh.SIZES["small"]["blocks"] == (1, 1, 1)
torch.distributed.destroy_process_group()
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
