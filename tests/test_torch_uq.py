"""The port's uncertainty metrics, calibration, Mahalanobis and ODIN against
the JAX package's (CPU).

Five sets of random logits [256, 10] from numpy seeds, the later ones with
ties (logits rounded to a coarse grid, repeated rows, constant columns);
budgets rtol 1e-5, atol 1e-6 unless a test says otherwise. ``auroc`` and
``aupr`` are also held to sklearn.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagetransformations_tpu.uq import calibration as jc
from imagetransformations_tpu.uq import mahalanobis as jmh
from imagetransformations_tpu.uq import metrics as jmet
from imagetransformations_tpu.uq import odin as jo
from imagetransformations_tpu_torch.uq import calibration as pc
from imagetransformations_tpu_torch.uq import mahalanobis as pmh
from imagetransformations_tpu_torch.uq import metrics as pmet
from imagetransformations_tpu_torch.uq import odin as po

from test_torch_models import _torch_threads  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
SEEDS = range(5)


def logits_and_labels(seed):
    """Random logits [256, 10] and labels; seeds 1-4 carry ties."""
    rng = np.random.default_rng(seed)
    lg = rng.normal(0, 3, (256, 10)).astype(np.float32)
    if seed >= 1:
        lg = np.round(lg * 2) / 2  # coarse grid: tied scores and tied top-2
    if seed >= 2:
        lg[::7] = lg[3]  # repeated rows
    if seed >= 3:
        lg[:, 4] = lg[:, 2]  # tied classes
    if seed == 4:
        lg[:32] = 0.0  # uniform predictions
    return lg, rng.integers(0, 10, 256).astype(np.int32)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(pmet.LOGIT_METRICS))
def test_logit_metrics(name, seed):
    lg, _ = logits_and_labels(seed)
    close(pmet.LOGIT_METRICS[name](torch.from_numpy(lg)).numpy(),
          jmet.LOGIT_METRICS[name](jnp.asarray(lg)))


def test_registries_match():
    assert list(pmet.LOGIT_METRICS) == list(jmet.LOGIT_METRICS)
    assert pmet.CONFIDENCE_METRICS == jmet.CONFIDENCE_METRICS


@pytest.mark.parametrize("seed", SEEDS)
def test_per_sample_and_calibration(seed):
    lg, y = logits_and_labels(seed)
    t, ty = torch.from_numpy(lg), torch.from_numpy(y)
    j, jy = jnp.asarray(lg), jnp.asarray(y)
    close(pmet.nll_per_sample(t, ty), jmet.nll_per_sample(j, jy))
    close(pmet.brier_score(t, ty), jmet.brier_score(j, jy))
    close(pmet.shannon_entropy(t, base2=False), jmet.shannon_entropy(j, base2=False))
    close(pmet.tsallis_entropy(t, 2.0), jmet.tsallis_entropy(j, 2.0))
    close(pmet.renyi_entropy(t, 3.0), jmet.renyi_entropy(j, 3.0))
    p, jp = torch.softmax(t, -1), jax.nn.softmax(j, -1)
    for name in ("ece", "nll", "brier", "accuracy"):
        close(getattr(pc, name)(p, ty), getattr(jc, name)(jp, jy))
    for a, b in zip(pc.calibration_bins(p, ty, 15), jc.calibration_bins(jp, jy, 15)):
        close(a, b)
    correct = (np.argmax(lg, -1) == y).astype(np.float32)
    conf = pmet.msp(t)
    jconf = jmet.msp(j)
    tc, jcr = torch.from_numpy(correct), jnp.asarray(correct)
    for name in ("aurc", "excess_aurc", "area_under_lift_curve", "coverage_for_accuracy"):
        close(getattr(pc, name)(conf, tc), getattr(jc, name)(jconf, jcr))
    close(pc.coverage_for_accuracy(conf, tc, 0.5, 20),
          jc.coverage_for_accuracy(jconf, jcr, 0.5, 20))
    for a, b in zip(pc.risk_coverage_curve(conf, tc), jc.risk_coverage_curve(jconf, jcr)):
        close(a, b)
    ent, jent = pmet.shannon_entropy(t), jmet.shannon_entropy(j)
    close(pc.pearsonr(ent, conf), jc.pearsonr(jent, jconf))
    close(pc.spearmanr(ent, conf), jc.spearmanr(jent, jconf))
    close(pc.spearmanr(torch.ones(256), conf), jc.spearmanr(jnp.ones(256), jconf))
    err, jerr = 1.0 - tc, 1.0 - jcr
    close(pc.youden_threshold(ent, err), jc.youden_threshold(jent, jerr))


@pytest.mark.parametrize("seed", SEEDS)
def test_auroc_and_aupr_against_jax_and_sklearn(seed):
    from sklearn.metrics import average_precision_score, roc_auc_score

    lg, y = logits_and_labels(seed)
    err = (np.argmax(lg, -1) != y).astype(np.float32)
    for score in (pmet.shannon_entropy, pmet.energy_score, pmet.ratio):
        s = score(torch.from_numpy(lg))
        a = pc.auroc(s, torch.from_numpy(err))
        assert a.dtype == torch.float32
        close(a, jc.auroc(jnp.asarray(s.numpy()), jnp.asarray(err)))
        close(a, roc_auc_score(err, s.numpy()))
        ap = pc.aupr(s, torch.from_numpy(err))
        close(ap, jc.aupr(jnp.asarray(s.numpy()), jnp.asarray(err)))
        if len(np.unique(s.numpy())) == len(s):  # sklearn groups ties; the step rule does not
            close(ap, average_precision_score(err, s.numpy()))


def test_auroc_rank_sum_in_f64():
    """At 10 000 samples the rank sum passes 2^24; the f64 sum gives sklearn's
    value to f32 rounding."""
    from sklearn.metrics import roc_auc_score

    rng = np.random.default_rng(7)
    s = np.round(rng.normal(size=10000), 2).astype(np.float32)
    t = (rng.uniform(size=10000) < 0.3).astype(np.float32)
    got = float(pc.auroc(torch.from_numpy(s), torch.from_numpy(t)))
    assert got == float(np.float32(roc_auc_score(t, s)))


def test_fit_temperature():
    lg, y = logits_and_labels(0)
    got = pc.fit_temperature(torch.from_numpy(lg), torch.from_numpy(y))
    close(got, jc.fit_temperature(jnp.asarray(lg), jnp.asarray(y)), rtol=1e-4)


@pytest.mark.parametrize("per_class", [False, True])
def test_mahalanobis(per_class):
    rng = np.random.default_rng(11)
    feats = (rng.normal(size=(512, 16)) @ rng.normal(size=(16, 16))).astype(np.float32)
    labels = rng.integers(0, 10, 512).astype(np.int32)
    test = (rng.normal(size=(128, 16)) * 1.5).astype(np.float32)
    lab = labels if per_class else None
    st = pmh.fit(torch.from_numpy(feats), None if lab is None else torch.from_numpy(lab))
    js = jmh.fit(jnp.asarray(feats), None if lab is None else jnp.asarray(lab))
    assert st.per_class == js.per_class == per_class
    # rtol 1e-4 of the largest entry: f32 inversion errors scale with the
    # matrix (its condition number here is ~1e3), not with each entry
    for a, b in ((st.mean, js.mean), (st.precision, js.precision)):
        b = np.asarray(b)
        close(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max())
    # the same state on both sides
    same = jmh.MahalanobisState(jnp.asarray(st.mean.numpy()), jnp.asarray(st.precision.numpy()),
                                per_class)
    close(pmh.score(st, torch.from_numpy(test)), jmh.score(same, jnp.asarray(test)), atol=0)


def _tiny_model(seed):
    """A small conv net, the same weights in torch and in jnp (NCHW)."""
    rng = np.random.default_rng(seed)
    w1 = (rng.normal(size=(8, 3, 3, 3)) * 0.3).astype(np.float32)
    w2 = (rng.normal(size=(10, 8)) * 0.5).astype(np.float32)

    def torch_fn(x):
        h = torch.tanh(torch.nn.functional.conv2d(x, torch.from_numpy(w1), padding=1))
        return h.mean(dim=(2, 3)) @ torch.from_numpy(w2).T

    def jax_fn(x):
        h = jnp.tanh(jax.lax.conv_general_dilated(x, jnp.asarray(w1), (1, 1), [(1, 1)] * 2))
        return h.mean(axis=(2, 3)) @ jnp.asarray(w2).T

    return torch_fn, jax_fn


def test_odin_and_generalized_search():
    tf, jf = _tiny_model(0)
    x = np.random.default_rng(1).normal(size=(16, 3, 8, 8)).astype(np.float32)
    for t, e in ((1000.0, 0.0014), (10.0, 0.05)):
        close(po.odin_score(tf, torch.from_numpy(x), t, e), jo.odin_score(jf, jnp.asarray(x), t, e),
              rtol=0, atol=1e-5)
        close(po.odin_uncertainty(tf, torch.from_numpy(x), t, e),
              jo.odin_uncertainty(jf, jnp.asarray(x), t, e), rtol=0, atol=1e-5)
    eps, scores = po.generalized_odin_search(tf, torch.from_numpy(x), temperature=10.0)
    jeps, jscores = jo.generalized_odin_search(jf, jnp.asarray(x), temperature=10.0)
    close(scores, jscores, rtol=0, atol=1e-5)
    assert float(eps) == float(jeps)
    with torch.no_grad():  # ODIN takes its gradient whatever the caller's mode
        close(po.odin_score(tf, torch.from_numpy(x)), jo.odin_score(jf, jnp.asarray(x)),
              rtol=0, atol=1e-5)


def test_decision_change_and_gradient_uncertainty():
    """The perturbation comes from the generator: with eps = 0 both equal
    JAX's; a fixed generator repeats."""
    tf, jf = _tiny_model(2)
    x = np.random.default_rng(3).normal(size=(8, 3, 8, 8)).astype(np.float32)
    tx, key = torch.from_numpy(x), jax.random.key(0)
    close(pmet.decision_change(tf, tx, None, 0.0),
          jmet.decision_change(jf, jnp.asarray(x), key, 0.0))
    g = lambda: torch.Generator().manual_seed(4)  # noqa: E731
    got = pmet.gradient_uncertainty(tf, tx, g(), 0.05)
    assert torch.equal(got, pmet.gradient_uncertainty(tf, tx, g(), 0.05))
    # JAX on the same perturbed input (its own eps = 0 on x + noise)
    noisy = x + 0.05 * torch.randn(x.shape, generator=g()).numpy()
    clean = jf(jnp.asarray(x))

    def per_sample(xi, target):
        return jnp.mean((jf(xi[None])[0] - target) ** 2)

    jg = jax.vmap(jax.grad(per_sample))(jnp.asarray(noisy), clean)
    close(got, jnp.sqrt(jnp.sum(jg.reshape(8, -1) ** 2, -1)), rtol=1e-4, atol=1e-6)
    dc = pmet.decision_change(tf, tx, g(), 0.05)
    close(dc, jmet.least_confidence(jf(jnp.asarray(noisy))))
