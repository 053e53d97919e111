"""The port's process mesh (``core.mesh.ProcessMesh``) on a group of 4 gloo
ranks on the CPU, against the JAX package (CPU, 4 of its 8 virtual
devices) and against the port's one-device run of the same workload.

One module-scoped run of ``tools/run_process_mesh.py`` under
``python -m torch.distributed.run --standalone --nproc-per-node=4``
(``torch.set_num_threads(1)`` a rank) on ``make_inputs("small")`` with a
depth-8 CIFAR ResNet carried from flax (``test_torch_uq_mc.carried``); the
ranks write their results, and the references are computed here (the
one-device run of the same workload while the ranks run). Budgets, with
what was measured in brackets:

- ``shard_files_for_host`` under the group: JAX's slice for each rank
  (equal); ``global_batch_from_host_shards``: JAX's global array of the
  concatenated rows (equal); ``psum_mean`` rtol 1e-6 of JAX's ``psum``
  pair (0); ``sharded_accuracy`` equal;
- the four ``sharded_chain_fn`` chains (rank 0's per-image angles in a
  lower band) and ``sharded_gaussian_blur`` at 2x64x48x3 (two interior
  shards): 0 LSB against the port's one-device call and, for the blur,
  ``cv2.GaussianBlur`` (0);
- ``evaluate_sharded``: logits rtol 2e-5 / atol 1e-6 of JAX's
  ``evaluate_sharded`` (JAX's own budget; 9.5e-7 absolute), accuracy
  equal; the sweep's cells: accuracy equal and AUROC within 1e-6 of the
  one-device sweep (0);
- ``make_train_step`` (SGD with momentum, standard normal inputs as in
  ``test_torch_training.py``) against JAX's loss, gradients and running
  statistics on the whole batch: loss rtol 1e-5 (1.0e-7), gradients rtol
  1e-3 / atol 1e-5 (1.3e-5 of the largest entry), running statistics rtol
  1e-5 / atol 1e-6 (8.3e-7: the port's one-device step on these weights is
  as far, on a mean of 1.4e-3); every rank's parameters, buffers,
  gradients and loss equal bit for bit; the parameters after 2 steps
  within 1e-5 of each tensor's largest entry of the one-device run's
  (1.0e-6); ``adversarial_train_step`` the same against one device (loss
  rtol 1e-5: 0; parameters 1.2e-6);
- a TENT step against JAX's ``make_tent_step`` on the whole batch: logits
  atol 5e-5 (1.2e-5); the BatchNorm parameters after it within lr / 20 =
  5e-5 of JAX's (1.4e-5), and after 2 steps of the one-device run's
  (1.8e-6), every rank's equal: Adam moves an element by lr g / (|g| +
  1e-8), so where a gradient is within ~1e-6 of 0 its rounding sets a
  share of lr (the port's one-device step is 1.3e-5 from JAX's there);
  ``evaluate_with_tent`` continuous: accuracy equal to one device's;
- ``bma_logits`` with each rank's samples drawn from its own seed: rank
  0's used (bit-equal to one device), rtol 1e-4 / atol 1e-5 of JAX's
  (6e-5 relative, 1.7e-6 absolute); ``fgsm_attack`` atol 1e-5 of one
  device (0) and JAX's on all but 0.1% of values (the attacks tests'
  budget, for a gradient sign near 0; 0);
- the one-device ``BatchNorm`` bit-identical to its rule before the mesh.
"""

import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import optax
import pytest
import torch

import cv2
import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from imagetransformations_tpu.adapt import tent as jt
from imagetransformations_tpu.attacks import fgsm as jf
from imagetransformations_tpu.evalx import harness as jh
from imagetransformations_tpu.models import CifarResNet as JResNet
from imagetransformations_tpu.models.resnet import normalize_cifar
from imagetransformations_tpu.pipeline import io as jio
from imagetransformations_tpu.pipeline import sharding as jsh
from imagetransformations_tpu.uq import swag as jswag
from imagetransformations_tpu_torch import models as pm
from imagetransformations_tpu_torch.models._layers import BatchNorm
from imagetransformations_tpu_torch.models.convert import _entries
from imagetransformations_tpu_torch.core import mesh as cm
from imagetransformations_tpu_torch.pipeline import io as pio

from test_torch_uq_mc import carried

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import run_process_mesh as rpm  # noqa: E402

WORLD, SEED = 4, 3


def _nhwc(t) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(t).transpose(0, 2, 3, 1))


def _stacked_tree(port, stacked: dict) -> dict:
    """Port-named [S, ...] parameter samples as a flax params tree of
    [S, ...] leaves (``convert._entries``'s map, sample by sample)."""
    tree: dict = {}
    for key, coll, path, to_flax, _ in _entries(port):
        if coll != "params":
            continue
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.stack([np.asarray(to_flax(v), np.float32)
                                   for v in stacked[key].numpy()])
    return tree


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(inputs, rank results, one-device result, flax variables, port
    module): one 4-rank run and the port's one-device run here."""
    variables, port = carried(lambda: pm.CifarResNet((1, 1, 1), device="cpu"), SEED)
    inputs = rpm.make_inputs("small", SEED, WORLD, model_state=port.state_dict())
    d = tmp_path_factory.mktemp("process_mesh")
    torch.save(inputs, d / "inputs.pt")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={WORLD}", str(ROOT / "tools" / "run_process_mesh.py"),
         "--device=cpu", f"--inputs={d / 'inputs.pt'}", f"--out={d / 'out'}"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        n = torch.get_num_threads()
        torch.set_num_threads(1)
        try:  # the one-device run while the ranks run
            one = rpm.run_all(inputs, None, "cpu")["out"]
        finally:
            torch.set_num_threads(n)
        stdout, stderr = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:  # torchrun and its ranks
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
    assert proc.returncode == 0, stdout[-4000:] + stderr[-8000:]
    ranks = [torch.load(d / "out" / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return dict(inputs=inputs, ranks=ranks, out=ranks[0]["out"], one=one,
                variables=variables, port=port)


@pytest.fixture(scope="module")
def jmesh():
    return JMesh(np.asarray(jax.devices()[:WORLD]), ("data",))


def test_ranks_ran_gloo_on_the_cpu(run):
    assert [r["rank"] for r in run["ranks"]] == list(range(WORLD))
    assert {(r["world"], r["backend"], r["device"]) for r in run["ranks"]} == {
        (WORLD, "gloo", "cpu")}


@pytest.mark.parametrize("rank", range(WORLD))
def test_shard_files_for_host_under_the_group(run, rank):
    files = run["inputs"]["files"]
    assert run["ranks"][rank]["out"]["files"] == jio.shard_files_for_host(files, rank, WORLD)


def test_shard_files_for_host_without_a_group():
    files = [f"f{i}" for i in range(7)]
    assert pio.shard_files_for_host(files) == jio.shard_files_for_host(files) == files
    assert pio.shard_files_for_host(files, 1, 3) == jio.shard_files_for_host(files, 1, 3)


def test_global_batch_from_host_shards(run, jmesh):
    rows = run["inputs"]["host_rows"]
    want = np.asarray(jio.global_batch_from_host_shards(rows, jmesh))
    for r in run["ranks"]:
        np.testing.assert_array_equal(r["out"]["global_batch"].numpy(), want)


def test_psum_mean(run, jmesh):
    values = run["inputs"]["psum"]["values"]
    fn = jax.jit(jax.shard_map(lambda v: jsh.psum_mean(v, "data"), mesh=jmesh,
                               in_specs=P("data"), out_specs=P()))
    want = float(fn(jnp.asarray(values)))
    for r in run["ranks"]:
        np.testing.assert_allclose(float(r["out"]["psum_mean"]), want, rtol=1e-6)


def test_sharded_accuracy(run, jmesh):
    ps = run["inputs"]["psum"]
    want = jsh.sharded_accuracy(jnp.asarray(ps["logits"]), jnp.asarray(ps["labels"]), jmesh)
    assert {r["out"]["sharded_accuracy"] for r in run["ranks"]} == {want}


def _shards(run, key, dim):
    """The ranks' shards of a run's output, in rank order."""
    return torch.cat([r["out"][key] for r in run["ranks"]], dim=dim)


@pytest.mark.parametrize("kernel", rpm.CHAINS)
def test_sharded_chain_fn(run, kernel):
    assert float(np.abs(run["inputs"]["angles"][: 8 // WORLD]).max()) <= rpm.BAND
    assert run["out"][kernel].shape[0] == 8 // WORLD
    assert torch.equal(_shards(run, kernel, 0), run["one"][kernel])


def test_sharded_gaussian_blur(run):
    imgs = run["inputs"]["blur_images"]
    assert imgs.shape == (2, 64, 48, 3) and run["out"]["blur"].shape[1] == 64 // WORLD
    want = np.stack([cv2.GaussianBlur(im, (9, 9), rpm.BLUR_RADIUS,
                                      borderType=cv2.BORDER_REFLECT_101) for im in imgs])
    np.testing.assert_array_equal(_shards(run, "blur", 1).numpy(), want)
    assert torch.equal(_shards(run, "blur", 1), run["one"]["blur"])


def test_evaluate_sharded(run, jmesh):
    jmodel, variables = JResNet((1, 1, 1)), run["variables"]
    imgs, labels = run["inputs"]["images"], run["inputs"]["labels"]
    want = jh.evaluate_sharded(lambda x: jmodel.apply(variables, x, False),
                               lambda u8: normalize_cifar(u8.astype(jnp.float32) / 255.0),
                               jnp.asarray(imgs), jnp.asarray(labels), jmesh)
    for r in run["ranks"]:
        got = r["out"]["evaluate"]
        assert got["accuracy"] == want["accuracy"]
        np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]),
                                   rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("cell", [f"sweep {n} {s}" for n, s in rpm.SWEEP_CELLS])
def test_sweep_cell(run, cell):
    want = run["one"][cell]
    for r in run["ranks"]:
        got = r["out"][cell]
        assert got["accuracy"] == want["accuracy"]
        for m, a in want["auroc"].items():
            assert abs(got["auroc"][m] - a) <= 1e-6, m


@pytest.fixture(scope="module")
def jax_train(run):
    """JAX's loss, gradient and running statistics of one training step on
    the whole batch (``models.training.make_train_step``'s loss)."""
    jmodel, variables = JResNet((1, 1, 1)), run["variables"]
    x = jnp.asarray(_nhwc(run["inputs"]["train_x"]))
    y = jnp.asarray(run["inputs"]["labels"][: len(x)].astype(np.int32))

    def loss_fn(p):
        logits, upd = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]}, x,
                                   True, mutable=["batch_stats"])
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()
        return ce, upd["batch_stats"]

    (loss, stats), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])
    return float(loss), grads, stats


@pytest.mark.parametrize("what", ["loss", "gradients", "running_statistics", "ranks_equal",
                                  "one_device"])
def test_make_train_step(run, jax_train, what):
    train = run["out"]["train"]
    loss, grads, stats = jax_train
    entries = list(_entries(run["port"]))
    if what == "loss":
        np.testing.assert_allclose(float(train["loss_acc"][0][0]), loss, rtol=1e-5)
    elif what == "gradients":
        for key, coll, path, to_flax, _ in entries:
            if coll == "params":
                np.testing.assert_allclose(to_flax(train["grads"][key].numpy()),
                                           _leaf(grads, path), rtol=1e-3, atol=1e-5,
                                           err_msg=key)
    elif what == "running_statistics":
        for key, coll, path, _, _ in entries:
            if coll == "batch_stats":
                np.testing.assert_allclose(train["buffers"][key].numpy(), _leaf(stats, path),
                                           rtol=1e-5, atol=1e-6, err_msg=key)
    elif what == "ranks_equal":
        for r in run["ranks"][1:]:
            other = r["out"]["train"]
            for part in ("params", "buffers", "grads"):
                for k, v in train[part].items():
                    assert torch.equal(other[part][k], v), (part, k)
            for a, b in zip(other["loss_acc"], train["loss_acc"]):
                assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    else:
        one = run["one"]["train"]
        for k, v in one["params"].items():
            assert float((train["params"][k] - v).abs().max()) <= 1e-5 * float(v.abs().max()), k
        for a, b in zip(train["loss_acc"], one["loss_acc"]):
            np.testing.assert_allclose(float(a[0]), float(b[0]), rtol=1e-5)
            assert float(a[1]) == float(b[1])


def test_adversarial_train_step(run):
    got, one = run["out"]["adv_train"], run["one"]["adv_train"]
    np.testing.assert_allclose([float(v) for v in got["loss"]], [float(v) for v in one["loss"]],
                               rtol=1e-5)
    for k, v in one["params"].items():
        assert float((got["params"][k] - v).abs().max()) <= 1e-5 * float(v.abs().max()), k
        for r in run["ranks"][1:]:
            assert torch.equal(r["out"]["adv_train"]["params"][k], got["params"][k]), k


@pytest.fixture(scope="module")
def jax_tent(run):
    """JAX's first TENT step on the whole first batch: (logits, BatchNorm
    parameters after it), BatchNorm in batch-statistics mode."""
    jmodel, variables = JResNet((1, 1, 1)), run["variables"]
    b = rpm.SIZES["small"]["tent"][1]
    x = jnp.asarray(_nhwc(rpm.model_space(run["inputs"]["images"][:b])))

    def apply_bn(p, xb):
        out, _ = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]}, xb,
                              train=True, mutable=["batch_stats"])
        return out

    state, tx = jt.init_tent(variables["params"], lr=rpm.TENT_LR)
    state, logits = jt.make_tent_step(apply_bn, tx)(state, x)
    return np.asarray(logits), jt.merge_params(state.bn_params, state.frozen_params)


@pytest.mark.parametrize("what", ["logits", "batchnorm_parameters", "one_device"])
def test_tent_step(run, jax_tent, what):
    logits, params = jax_tent
    steps = run["out"]["tent_steps"]
    if what == "logits":
        np.testing.assert_allclose(steps["logits"][0].numpy(), logits, atol=5e-5)
    elif what == "batchnorm_parameters":
        for key, coll, path, to_flax, _ in _entries(run["port"]):
            if key in steps["bn"][0]:
                np.testing.assert_allclose(to_flax(steps["bn"][0][key].numpy()),
                                           _leaf(params, path), atol=rpm.TENT_LR / 20,
                                           err_msg=key)
    else:
        for got, want in zip(steps["bn"], run["one"]["tent_steps"]["bn"]):
            for k, v in want.items():
                np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=rpm.TENT_LR / 20,
                                           err_msg=k)
        for r in run["ranks"][1:]:
            for k, v in steps["bn"][-1].items():
                assert torch.equal(r["out"]["tent_steps"]["bn"][-1][k], v), k


def test_evaluate_with_tent(run):
    assert {r["out"]["tent_accuracy"] for r in run["ranks"]} == {run["one"]["tent_accuracy"]}


def test_bma_logits(run):
    jmodel, variables = JResNet((1, 1, 1)), run["variables"]
    samples = run["out"]["bma_samples"]  # rank 0's draws
    assert not torch.equal(run["ranks"][1]["out"]["bma_samples"]["fc.weight"],
                           samples["fc.weight"])
    stacked = _stacked_tree(run["port"], samples)
    nb = rpm.SIZES["small"]["bma"]
    x = jnp.asarray(_nhwc(rpm.model_space(run["inputs"]["images"][:nb])))
    want = np.asarray(jax.jit(lambda st, xb: jswag.bma_logits(
        lambda p, xi: jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]}, xi,
                                   train=False), st, xb))(stacked, x))
    for r in run["ranks"]:
        assert torch.equal(r["out"]["bma"], run["one"]["bma"])
        np.testing.assert_allclose(r["out"]["bma"].numpy(), want, rtol=1e-4, atol=1e-5)


def test_fgsm_attack(run):
    jmodel, variables = JResNet((1, 1, 1)), run["variables"]
    nf = rpm.SIZES["small"]["fgsm"]
    x = rpm.model_space(run["inputs"]["images"][:nf])
    y = run["inputs"]["labels"][:nf].astype(np.int32)
    want = np.asarray(jf.fgsm_attack(lambda xb: jmodel.apply(variables, xb, False),
                                     jnp.asarray(_nhwc(x)), jnp.asarray(y), rpm.FGSM_EPS,
                                     -3.0, 3.0))
    for r in run["ranks"]:
        got = r["out"]["fgsm"]
        np.testing.assert_allclose(got.numpy(), run["one"]["fgsm"].numpy(), atol=1e-5)
        d = np.abs(_nhwc(got) - want)
        assert (d > 1e-5).mean() <= 1e-3 and d.max() <= 2 * rpm.FGSM_EPS + 1e-5


def test_one_device_batchnorm_is_unchanged(rng):
    """Outside a mesh scope the training BatchNorm is its two-pass rule bit
    for bit: the output and the running statistics."""
    x = torch.from_numpy(rng.normal(1.0, 2.0, (6, 4, 5, 5)).astype(np.float32))
    bn = BatchNorm(4, device="cpu")
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([0.5, 1.5, -1.0, 2.0]))
        bn.bias.copy_(torch.tensor([0.1, -0.2, 0.3, 0.0]))
    rm, rv = bn.running_mean.clone(), bn.running_var.clone()
    mean = x.mean((0, 2, 3))
    centered = x - mean[:, None, None]
    var = (centered * centered).mean((0, 2, 3))
    want = (centered * (torch.rsqrt(var + 1e-5) * bn.weight)[:, None, None]
            + bn.bias[:, None, None])
    with cm.batch_mesh(None):
        got = bn(x, True)
    assert cm.current_batch_mesh() is None
    assert torch.equal(got, want)
    assert torch.equal(bn.running_mean, 0.9 * rm + 0.1 * mean)
    assert torch.equal(bn.running_var, 0.9 * rv + 0.1 * var)
