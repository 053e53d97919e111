"""The port's evaluation harness against the JAX package's (CPU):
``evaluate_batched``, ``analyze_uncertainty_thresholds`` and
``corruption_sweep`` with ``uq_extras`` (ODIN and Mahalanobis).

One CIFAR ResNet of depth 8 (1, 1, 1), its weights made in flax and carried
across with ``from_flax``, on u8 images from a numpy seed, with a batch
size that does not divide n. Budgets: accuracy equal, metrics rtol 1e-5
(atol 1e-6), thresholds and AUROC atol 1e-5; the sweep equals the port's
own composition bit for bit, and JAX's sweep, on the cells whose corrupted
bytes both packages agree on, within 1/n in accuracy and 0.01 in AUROC.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagetransformations_tpu import models as jm
from imagetransformations_tpu.evalx import harness as jh
from imagetransformations_tpu_torch import models as pm
from imagetransformations_tpu_torch.evalx import harness as ph
from imagetransformations_tpu_torch.models.resnet import cifar_model_space
from imagetransformations_tpu_torch.uq import mahalanobis as pmh

from test_torch_models import _torch_threads, flax_variables  # noqa: F401

BLOCKS = (1, 1, 1)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(21)
    imgs = rng.integers(0, 256, (64, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, 64).astype(np.int32)
    jmodel = jm.CifarResNet(BLOCKS)
    x0 = np.zeros((1, 32, 32, 3), np.float32)
    variables = flax_variables(jmodel, x0, 5)
    port = pm.from_flax(pm.CifarResNet(BLOCKS, device="cpu"), variables)

    def jfn(x):
        return jmodel.apply(variables, x)

    def jfeats(x):
        return jmodel.apply(variables, x, method=jmodel.features_and_logits)

    def jto(u8):
        return jm.resnet.normalize_cifar(u8.astype(jnp.float32) / 255.0)

    return dict(imgs=imgs, labels=labels, port=port, jfn=jax.jit(jfn), jfeats=jfeats, jto=jto)


def test_evaluate_batched_and_thresholds(setup):
    s = setup
    metrics = ph.DEFAULT_METRICS + ("tsallis", "dempster_shafer")
    got = ph.evaluate_batched(s["port"], cifar_model_space, s["imgs"], s["labels"],
                              batch_size=24, metric_names=metrics, device="cpu")
    want = jh.evaluate_batched(s["jfn"], s["jto"], jnp.asarray(s["imgs"]),
                               jnp.asarray(s["labels"]), batch_size=24, metric_names=metrics)
    assert got["accuracy"] == want["accuracy"]
    np.testing.assert_array_equal(got["correct"].numpy(), np.asarray(want["correct"]))
    assert tuple(got["logits"].shape) == (64, 10)
    for m in metrics:
        np.testing.assert_allclose(got["metrics"][m].numpy(), np.asarray(want["metrics"][m]),
                                   rtol=1e-5, atol=1e-6, err_msg=m)
    # the padded batch changes nothing: one batch of all 64 gives the same logits
    whole = ph.evaluate_batched(s["port"], cifar_model_space, s["imgs"], s["labels"],
                                batch_size=64, metric_names=(), device="cpu")
    np.testing.assert_allclose(whole["logits"].numpy(), got["logits"].numpy(), rtol=1e-6,
                               atol=1e-6)
    table = ph.analyze_uncertainty_thresholds(got["metrics"], got["correct"])
    jtable = jh.analyze_uncertainty_thresholds(want["metrics"], want["correct"])
    assert sorted(table) == sorted(jtable)  # JAX returns its dicts key-sorted
    for m in metrics:
        for k in ("threshold", "auroc", "flagged_error_rate"):
            np.testing.assert_allclose(table[m][k], jtable[m][k], rtol=0, atol=1e-5,
                                       err_msg=f"{m} {k}")
        assert table[m]["n_flagged"] == jtable[m]["n_flagged"], m
    assert ph.analyze_uncertainty_thresholds({}, got["correct"]) == {}


def _uq_extras(port, imgs, backend):
    """ODIN and a Mahalanobis fit on the clean features (port's fit)."""
    with torch.no_grad():
        feats = port.features(cifar_model_space(torch.from_numpy(imgs)))
    st = pmh.fit(feats)
    return {"feats_logits_fn": port.features_and_logits, "maha_mean": st.mean,
            "maha_precision": st.precision} if backend == "torch" else st


def test_sweep_equals_its_own_composition(setup):
    """Cell by cell, bit for bit: ``corrupt`` with the cell's generator, the
    batched forward, the statistics."""
    s = setup
    imgs, labels, port = s["imgs"][:20], s["labels"][:20], s["port"]
    names = ("gaussian_noise", "glass_blur", "rotation", "contrast")
    extras = _uq_extras(port, imgs, "torch")
    metrics = ("shannon_entropy", "msp", "energy")
    out = ph.corruption_sweep(port, cifar_model_space, imgs, labels, seed=3,
                              corruption_names=names, severities=(2, 5), batch_size=8,
                              metric_names=metrics, uq_extras=extras, device="cpu")
    x, y = torch.from_numpy(imgs), torch.from_numpy(labels)
    st = pmh.MahalanobisState(extras["maha_mean"], extras["maha_precision"])
    from imagetransformations_tpu_torch.uq.calibration import auroc
    from imagetransformations_tpu_torch.uq.metrics import CONFIDENCE_METRICS
    from imagetransformations_tpu_torch.uq.odin import odin_uncertainty

    for name in names:
        for sev in (2, 5):
            c = ph.corrupt(x, name, sev, ph.corruption_generator(3, name, sev, x.device))
            res = ph.evaluate_batched(port, cifar_model_space, c, y, batch_size=8,
                                      metric_names=metrics, device="cpu")
            xm = cifar_model_space(c)
            with torch.no_grad():
                feats = port.features(xm)
            od = torch.cat([odin_uncertainty(port, xm[i: i + 8]) for i in range(0, 20, 8)])
            err = 1.0 - res["correct"]
            want = {m: float(auroc(-res["metrics"][m] if m in CONFIDENCE_METRICS
                                   else res["metrics"][m], err)) for m in metrics}
            want["odin"] = float(auroc(od, err))
            want["mahalanobis"] = float(auroc(pmh.score(st, feats), err))
            assert out[name][sev]["accuracy"] == res["accuracy"], (name, sev)
            assert out[name][sev]["auroc"] == want, (name, sev)


def test_sweep_against_jax(setup):
    """The cells whose corrupted bytes both packages give alike (ROADMAP
    C.3: defocus_blur, pixelate, jpeg_compression), with ODIN and
    Mahalanobis: accuracy within 1/n, AUROC within 0.01."""
    s = setup
    imgs, labels, port = s["imgs"][:32], s["labels"][:32], s["port"]
    names = ("defocus_blur", "pixelate", "jpeg_compression")
    sevs = (1, 4)
    for name in names:
        for sev in sevs:
            a = ph.corrupt(torch.from_numpy(imgs), name, sev).numpy()
            b = np.asarray(jh.corrupt(jnp.asarray(imgs), name, sev, jax.random.key(0)))
            np.testing.assert_array_equal(a, b, err_msg=f"{name} {sev}")
    st = _uq_extras(port, imgs, "state")
    metrics = ("shannon_entropy", "msp", "margin", "energy")
    got = ph.corruption_sweep(port, cifar_model_space, imgs, labels, corruption_names=names,
                              severities=sevs, batch_size=12, metric_names=metrics,
                              uq_extras={"feats_logits_fn": port.features_and_logits,
                                         "maha_mean": st.mean, "maha_precision": st.precision},
                              device="cpu")
    want = jh.corruption_sweep(s["jfn"], s["jto"], jnp.asarray(imgs), jnp.asarray(labels),
                               jax.random.key(0), corruption_names=names, severities=sevs,
                               batch_size=12, metric_names=metrics,
                               uq_extras={"feats_logits_fn": s["jfeats"],
                                          "maha_mean": st.mean.numpy(),
                                          "maha_precision": st.precision.numpy()})
    for name in names:
        for sev in sevs:
            g, w = got[name][sev], want[name][sev]
            assert abs(g["accuracy"] - w["accuracy"]) <= 1 / 32, (name, sev)
            assert list(g["auroc"]) == list(w["auroc"])
            for m in g["auroc"]:
                assert abs(g["auroc"][m] - w["auroc"][m]) <= 0.01, (name, sev, m)


def test_sweep_defaults_and_unported_paths(setup, monkeypatch):
    s = setup
    imgs, labels = s["imgs"][:8], s["labels"][:8]
    out = ph.corruption_sweep(s["port"], cifar_model_space, imgs, labels, severities=(1,),
                              batch_size=8, metric_names=(), device="cpu")
    assert list(out) == list(ph.CORRUPTIONS)
    assert all(set(v) == {1} and v[1]["auroc"] == {} for v in out.values())
    # the mesh paths (ROADMAP A.9) run: one CPU slot gives the one-device
    # result; the ODIN / Mahalanobis columns stay a one-device path
    from imagetransformations_tpu_torch.pipeline.sharding import data_mesh

    one = data_mesh(device="cpu")
    got = ph.evaluate_sharded(s["port"], cifar_model_space, imgs, labels, one)
    want = ph.evaluate_batched(s["port"], cifar_model_space, imgs, labels, device="cpu")
    assert got["accuracy"] == want["accuracy"]
    with pytest.raises(ValueError, match="single-device"):
        ph.corruption_sweep(s["port"], cifar_model_space, imgs, labels, mesh=one,
                            uq_extras={}, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (ph.evaluate_batched, ph.corruption_sweep):
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(s["port"], cifar_model_space, imgs, labels)
