"""The port's sharded evaluation against its one-device evaluation and the
JAX package's mesh evaluation (8 virtual CPU devices, ``tests/conftest.py``).

- ``evaluate_sharded`` on 8 CPU slots: with and without padding (61 rows,
  and a 2-row tail batch that needs 6 rows of pad), with a ``corrupt_fn``
  on numpy draws made for the padded batch: accuracy equal and logits
  within rtol 2e-5 / atol 1e-6 (JAX's own budget for its sharded
  evaluation) of the port's ``evaluate_batched`` and of JAX's
  ``evaluate_sharded``;
- ``corruption_sweep(mesh=)``: cell for cell equal to the port's one-device
  sweep where the set divides the axis (accuracy equal, AUROC within
  1e-6, JAX's own budget), and against JAX's mesh sweep on the cells whose
  bytes both packages agree on (ROADMAP C.3): accuracy within 1/n, AUROC
  within 0.01, as ``test_torch_harness_sweep.py`` holds the one-device
  sweeps;
- ``sweep --data-parallel=true --mesh-slots=4 --device=cpu``: the JAX CLI's
  line, and the table of ``corruption_sweep`` on the same mesh.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagetransformations_tpu.evalx import harness as jh
from imagetransformations_tpu.pipeline.datasets import synthetic
from imagetransformations_tpu.pipeline.sharding import data_mesh as j_data_mesh
from imagetransformations_tpu_torch.__main__ import main
from imagetransformations_tpu_torch.evalx import harness as ph
from imagetransformations_tpu_torch.pipeline import sharding as ps
from imagetransformations_tpu_torch.utils import demo

from test_torch_models import _torch_threads  # noqa: F401

RTOL, ATOL = 2e-5, 1e-6


@pytest.fixture(scope="module")
def linear():
    rng = np.random.default_rng(17)
    w = (rng.standard_normal((3072, 10)) * 0.01).astype(np.float32)
    imgs, labels = synthetic(n=64)
    wj, wt = jnp.asarray(w), torch.from_numpy(w)
    return dict(
        imgs=np.asarray(imgs), labels=np.asarray(labels),
        jfn=lambda x: x.reshape(x.shape[0], -1) @ wj,
        jto=lambda x: x.astype(jnp.float32) / 255.0,
        pfn=lambda x: x.reshape(x.shape[0], -1) @ wt,
        pto=lambda x: x.to(torch.float32) / 255.0,
        jmesh=j_data_mesh(), pmesh=ps.data_mesh(8, device="cpu"))


def _close(got, want):
    assert got["accuracy"] == want["accuracy"]
    assert tuple(got["logits"].shape) == tuple(np.shape(want["logits"]))
    np.testing.assert_allclose(got["logits"].numpy(), np.asarray(want["logits"]), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("rows,batch_size", [(64, None), (61, None), (66, 64), (64, 20)])
def test_evaluate_sharded_matches(linear, rows, batch_size):
    s = linear
    imgs = np.concatenate([s["imgs"], s["imgs"][:2]])[:rows]
    labels = np.concatenate([s["labels"], s["labels"][:2]])[:rows]
    got = ph.evaluate_sharded(s["pfn"], s["pto"], imgs, labels, s["pmesh"],
                              batch_size=batch_size)
    _close(got, ph.evaluate_batched(s["pfn"], s["pto"], imgs, labels, device="cpu"))
    _close(got, jh.evaluate_sharded(s["jfn"], s["jto"], jnp.asarray(imgs), jnp.asarray(labels),
                                    s["jmesh"], batch_size=batch_size))
    np.testing.assert_array_equal(got["correct"].numpy(),
                                  (got["logits"].argmax(-1).numpy() == labels).astype(np.float32))


def test_evaluate_sharded_generates_on_the_padded_batch(linear):
    """``corrupt_fn`` runs on each padded batch before the forward: numpy
    draws made for the padded batch give the one-device result on the same
    corrupted rows; a deterministic corruption gives JAX's."""
    s = linear
    imgs, labels = s["imgs"][:61], s["labels"][:61]
    rng = np.random.default_rng(5)
    draws = ph.numpy_draws(np.concatenate([imgs, imgs[-1:].repeat(3, 0)]), "gaussian_noise", 3,
                           rng)
    seen = []

    def noisy(xb, generator):
        seen.append(int(xb.shape[0]))
        return ph.corrupt(xb, "gaussian_noise", 3, noise=torch.from_numpy(draws["noise"]))

    got = ph.evaluate_sharded(s["pfn"], s["pto"], imgs, labels, s["pmesh"], corrupt_fn=noisy)
    assert seen == [64]
    corrupted = ph.corrupt(torch.from_numpy(imgs), "gaussian_noise", 3,
                           noise=torch.from_numpy(draws["noise"][:61]))
    _close(got, ph.evaluate_batched(s["pfn"], s["pto"], corrupted, labels, device="cpu"))

    def contrast(xb, generator):
        return ph.corrupt(xb, "contrast", 4)

    got = ph.evaluate_sharded(s["pfn"], s["pto"], imgs, labels, s["pmesh"], corrupt_fn=contrast)
    fn, sevs = jh.CORRUPTIONS["contrast"]
    want = jh.evaluate_sharded(s["jfn"], s["jto"], jnp.asarray(imgs), jnp.asarray(labels),
                               s["jmesh"], corrupt_fn=lambda x, k: fn(x, sevs[3], k))
    _close(got, want)
    # the default generator is seeded (JAX: key(0)): two runs agree
    def drawn(xb, generator):
        return ph.corrupt(xb, "gaussian_noise", 2, generator)

    a = ph.evaluate_sharded(s["pfn"], s["pto"], imgs, labels, s["pmesh"], corrupt_fn=drawn)
    b = ph.evaluate_sharded(s["pfn"], s["pto"], imgs, labels, s["pmesh"], corrupt_fn=drawn)
    assert torch.equal(a["logits"], b["logits"])


def test_model_replicas():
    net = torch.nn.Linear(3, 2)
    mesh = ps.data_mesh(3, device="cpu")
    assert ps.model_replicas(net, mesh) == [net] * 3
    f = lambda x: x  # noqa: E731
    assert ps.model_replicas(f, mesh) == [f] * 3


def test_sweep_mesh_matches(linear):
    s = linear
    metrics = ("shannon_entropy", "msp", "margin", "energy")
    kw = dict(severities=(1, 4), metric_names=metrics, batch_size=12, device="cpu")
    # 32 rows on 8 slots: no pad, so every cell draws what the one-device sweep draws
    names = ("gaussian_noise", "contrast", "rotation")
    imgs, labels = s["imgs"][:32], s["labels"][:32]
    one = ph.corruption_sweep(s["pfn"], s["pto"], imgs, labels, seed=3, corruption_names=names,
                              **kw)
    got = ph.corruption_sweep(s["pfn"], s["pto"], imgs, labels, seed=3, corruption_names=names,
                              mesh=s["pmesh"], **kw)
    for name in names:
        for sev in (1, 4):
            assert got[name][sev]["accuracy"] == one[name][sev]["accuracy"], (name, sev)
            for m, auc in one[name][sev]["auroc"].items():
                assert got[name][sev]["auroc"][m] == pytest.approx(auc, abs=1e-6)
    # 30 rows (2 of pad) against JAX's mesh sweep on its byte-equal cells
    names = ("defocus_blur", "pixelate", "jpeg_compression")
    imgs, labels = s["imgs"][:30], s["labels"][:30]
    got = ph.corruption_sweep(s["pfn"], s["pto"], imgs, labels, corruption_names=names,
                              mesh=s["pmesh"], **kw)
    want = jh.corruption_sweep(s["jfn"], s["jto"], jnp.asarray(imgs), jnp.asarray(labels),
                               jax.random.key(0), corruption_names=names, severities=(1, 4),
                               metric_names=metrics, batch_size=12, mesh=s["jmesh"])
    one = ph.corruption_sweep(s["pfn"], s["pto"], imgs, labels, corruption_names=names, **kw)
    for name in names:
        for sev in (1, 4):
            g, w = got[name][sev], want[name][sev]
            assert abs(g["accuracy"] - w["accuracy"]) <= 1 / 30, (name, sev)
            assert g["accuracy"] == one[name][sev]["accuracy"]
            assert list(g["auroc"]) == list(w["auroc"])
            for m in g["auroc"]:
                assert abs(g["auroc"][m] - w["auroc"][m]) <= 0.01, (name, sev, m)
                assert g["auroc"][m] == pytest.approx(one[name][sev]["auroc"][m], abs=1e-6)
    with pytest.raises(ValueError, match="single-device"):
        ph.corruption_sweep(s["pfn"], s["pto"], imgs, labels, mesh=s["pmesh"],
                            uq_extras={"feats_logits_fn": None}, device="cpu")


def test_sweep_data_parallel_command(tmp_path, monkeypatch, capsys):
    get_data = demo.get_data
    monkeypatch.setattr(demo, "get_data", lambda root, verbose=False: get_data(
        root, n_train=64, n_test=32, verbose=verbose))
    out_dir = tmp_path / "out"
    main(["sweep", f"--data-root={tmp_path}", f"--out-dir={out_dir}", "--severities=1",
          "--metrics=msp,energy", "--device=cpu", "--seed=2", "--data-parallel=true",
          "--mesh-slots=4"])
    text = capsys.readouterr().out
    assert "data-parallel sweep over 4 devices" in text
    with open(out_dir / "sweep.json") as fh:
        saved = json.load(fh)
    xtr, ytr, xte, yte = demo.get_data(str(tmp_path))
    _, to_model, model = demo.get_model(xtr, ytr, device="cpu", seed=2)
    want = ph.corruption_sweep(model, to_model, xte, yte, seed=2, severities=(1,),
                               metric_names=("msp", "energy"),
                               mesh=ps.data_mesh(4, device="cpu"), device="cpu")
    assert saved == {n: {"1": v[1]} for n, v in want.items()}
    # one slot, or no --data-parallel: no mesh (and no line)
    from imagetransformations_tpu_torch.__main__ import _sweep_mesh
    from imagetransformations_tpu_torch.utils.config import SweepConfig

    assert _sweep_mesh(SweepConfig.from_cli(["--data-parallel=true"]), "cpu") is None
    assert _sweep_mesh(SweepConfig.from_cli(["--mesh-slots=4"]), "cpu") is None
    cfg = SweepConfig.from_cli(["--data-parallel=true", "--mesh-slots=2"])
    assert _sweep_mesh(cfg, "cpu") == ps.data_mesh(2, device="cpu")
