"""The port's MATTA / VATTA (``adapt.matta``) and post-hoc calibration
(``adapt.posthoc``) against the JAX package's (CPU).

View probabilities and logits from numpy seeds (the later ones on a coarse
grid, so that confidences tie), labels drawn from them. Budgets:

- ``apply_matta`` / ``apply_vatta``, the calibrators' ``calibrate`` at the
  same fitted values, TTA-boosted calibration: within 1e-6;
- ``fit_matta_weights`` (200 Adam steps) against optax: within 1e-5 of
  JAX's weights (measured 3.1e-6); ``EnsembleTemperatureScaling.fit`` (300
  steps): its weights within 1e-7 (measured 5.6e-9); ``TemperatureScaling``
  (``fit_temperature``: torch's Adam against optax's) within 1e-5
  relative (measured 1.2e-6);
- ``find_optimal_rho`` (a ternary search on a piecewise-constant ECE, whose
  comparisons flip on an ulp): the same rho, or JAX's ECE at the port's
  rho within 0.01 of its value at JAX's rho (measured: the same rho in
  all three cases); with the NLL as the criterion (flat at its minimum)
  JAX's NLL at the port's rho within 1e-6 of its value at JAX's rho;
- the isotonic calibrators against the JAX classes (scikit-learn) within
  1e-9, on f32 and f64 probabilities with tied and near-tied (< 1e-6)
  confidences; ``IsotonicFit`` against ``sklearn.isotonic`` itself the
  same, thresholds included.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from sklearn.isotonic import IsotonicRegression

from imagetransformations_tpu.adapt import matta as jm
from imagetransformations_tpu.adapt import posthoc as jp
from imagetransformations_tpu.uq.calibration import ece as j_ece
from imagetransformations_tpu_torch.adapt import matta as pmm
from imagetransformations_tpu_torch.adapt import posthoc as pp

from test_torch_models import _torch_threads  # noqa: F401

TOL, MATTA_TOL, ETS_TOL, TS_RTOL, ISO_TOL = 1e-6, 1e-5, 1e-7, 1e-5, 1e-9
RHO_ECE_TOL, RHO_NLL_TOL = 0.01, 1e-6


def softmax(x, axis=-1):
    e = np.exp(x - x.max(axis, keepdims=True))
    return (e / e.sum(axis, keepdims=True)).astype(np.float32)


def view_data(seed, v=4, b=96, c=10):
    """[V, B, C] view probabilities (views: noisy copies of one logit set)
    and labels drawn from the first view; seed >= 1 on a coarse grid."""
    rng = np.random.default_rng(seed)
    base = rng.normal(0, 2.0, (b, c))
    lg = base[None] + rng.normal(0, 0.7, (v, b, c))
    if seed >= 1:
        lg = np.round(lg * 2) / 2
    probs = softmax(lg.astype(np.float32))
    labels = np.array([rng.choice(c, p=p / p.sum()) for p in probs[0].astype(np.float64)],
                      np.int32)
    return probs, labels


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol)


@pytest.mark.parametrize("seed", range(3))
def test_apply_matta_vatta(seed):
    vp, _ = view_data(seed)
    rng = np.random.default_rng(seed + 10)
    wm = rng.normal(0, 1, (vp.shape[0], vp.shape[2])).astype(np.float32)
    wv = rng.normal(0, 1, vp.shape[0]).astype(np.float32)
    close(pmm.apply_matta(torch.from_numpy(vp), torch.from_numpy(wm)),
          jm.apply_matta(jnp.asarray(vp), jnp.asarray(wm)))
    close(pmm.apply_vatta(torch.from_numpy(vp), torch.from_numpy(wv)),
          jm.apply_vatta(jnp.asarray(vp), jnp.asarray(wv)))


@pytest.mark.parametrize("per_class", [True, False])
@pytest.mark.parametrize("seed", range(3))
def test_fit_matta_weights(seed, per_class):
    vp, y = view_data(seed)
    want = jm.fit_matta_weights(jnp.asarray(vp), jnp.asarray(y), per_class=per_class)
    got = pmm.fit_matta_weights(torch.from_numpy(vp), torch.from_numpy(y), per_class=per_class)
    assert got.shape == want.shape and got.dtype == np.float32
    close(got, want, MATTA_TOL)


@pytest.mark.parametrize("seed", range(3))
def test_find_optimal_rho(seed):
    vp, y = view_data(seed)
    orig, aug = vp[0], vp[1:].mean(0)
    want = jm.find_optimal_rho(jnp.asarray(orig), jnp.asarray(aug), jnp.asarray(y))
    got = pmm.find_optimal_rho(torch.from_numpy(orig), torch.from_numpy(aug), torch.from_numpy(y))
    assert 0.0 <= got <= 1.0
    if got != want:

        def jece(r):
            return float(j_ece(r * jnp.asarray(orig) + (1.0 - r) * jnp.asarray(aug),
                               jnp.asarray(y)))

        assert jece(got) <= jece(want) + RHO_ECE_TOL
    # a criterion of the caller's, the NLL: near its minimum the compared
    # values differ by ulps, so the searches may stop at another rho, at the
    # same NLL
    yt = torch.from_numpy(y).long()
    crit_p = lambda p: float(-torch.log(p[torch.arange(len(y)), yt]).mean())  # noqa: E731
    crit_j = lambda p: float(-jnp.log(p[jnp.arange(len(y)), jnp.asarray(y)]).mean())  # noqa: E731
    rp = pmm.find_optimal_rho(torch.from_numpy(orig), torch.from_numpy(aug), yt, crit_p)
    rj = jm.find_optimal_rho(jnp.asarray(orig), jnp.asarray(aug), jnp.asarray(y), crit_j)

    def jnll(r):
        return crit_j(r * jnp.asarray(orig) + (1.0 - r) * jnp.asarray(aug))

    assert jnll(rp) <= jnll(rj) + RHO_NLL_TOL


@pytest.mark.parametrize("seed", range(2))
def test_temperature_scaling(seed):
    rng = np.random.default_rng(seed)
    lg = (rng.normal(0, 1, (500, 10)) * 3).astype(np.float32)
    y = np.array([rng.choice(10, p=p / p.sum()) for p in softmax(lg / 3).astype(np.float64)],
                 np.int32)
    want = jp.TemperatureScaling().fit(jnp.asarray(lg), jnp.asarray(y))
    got = pp.TemperatureScaling().fit(torch.from_numpy(lg), torch.from_numpy(y))
    assert got.temperature == pytest.approx(want.temperature, rel=TS_RTOL)
    got.temperature = want.temperature
    close(got.calibrate(torch.from_numpy(lg)), want.calibrate(jnp.asarray(lg)))


@pytest.mark.parametrize("seed", range(2))
def test_ensemble_temperature_scaling(seed):
    rng = np.random.default_rng(seed)
    lg = (rng.normal(0, 1, (400, 10)) * (2 + seed)).astype(np.float32)
    y = rng.integers(0, 10, 400).astype(np.int32)
    want = jp.EnsembleTemperatureScaling().fit(jnp.asarray(lg), jnp.asarray(y))
    got = pp.EnsembleTemperatureScaling().fit(torch.from_numpy(lg), torch.from_numpy(y))
    close(got.weights, want.weights, ETS_TOL)
    got.weights = want.weights
    close(got.calibrate(torch.from_numpy(lg)), want.calibrate(jnp.asarray(lg)))


def iso_data(seed, dtype, n=400, c=6):
    """Probabilities with exact ties (repeated rows, a coarse grid) and
    near-ties (< 1e-6 apart); labels from them."""
    rng = np.random.default_rng(seed)
    lg = rng.normal(0, 2, (n, c))
    lg[: n // 4] = np.round(lg[: n // 4])
    lg[n // 4: n // 2] = lg[:1]
    probs = softmax(lg).astype(dtype)
    probs[n // 2: n // 2 + 20] = probs[n // 2] + rng.uniform(0, 5e-7, (20, c)).astype(dtype)
    y = np.array([rng.choice(c, p=p / p.sum()) for p in probs.astype(np.float64)], np.int32)
    return probs, y


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", range(3))
def test_isotonic_calibrators_match_sklearn(seed, dtype):
    probs, y = iso_data(seed, dtype)
    test = iso_data(seed + 10, dtype)[0]
    for pcls, jcls in ((pp.IsotonicRegressionCalibration, jp.IsotonicRegressionCalibration),
                       (pp.AccuracyPreservingIsotonicRegression,
                        jp.AccuracyPreservingIsotonicRegression)):
        got, want = pcls().fit(probs, y), jcls().fit(probs, y)
        for p in (probs, test):
            g, w = got.calibrate(p), want.calibrate(p)
            assert g.dtype == w.dtype
            close(g, w, ISO_TOL)
    # tensors in, as the card's callers pass them
    t = pp.IsotonicRegressionCalibration().fit(torch.from_numpy(probs), torch.from_numpy(y))
    close(t.calibrate(torch.from_numpy(test)),
          jp.IsotonicRegressionCalibration().fit(probs, y).calibrate(test), ISO_TOL)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("bounds", [(None, None), (0.0, 1.0), (1e-6, 1.0), (0.2, 0.7)])
@pytest.mark.parametrize("seed", range(3))
def test_isotonic_fit_matches_sklearn(seed, bounds, dtype):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, 300).astype(dtype)
    x[:60] = np.round(x[:60] * 8) / 8  # ties
    x[60:90] = x[60] + rng.uniform(0, 9e-7, 30).astype(dtype)  # near-ties
    y = (rng.uniform(0, 1, 300) < x).astype(np.float64)
    if seed == 2:
        y = rng.normal(x, 0.3)  # real-valued targets
    ours = pp.IsotonicFit(*bounds).fit(x, y)
    ref = IsotonicRegression(y_min=bounds[0], y_max=bounds[1], out_of_bounds="clip").fit(x, y)
    np.testing.assert_array_equal(ours.x_thresholds, ref.X_thresholds_)
    close(ours.y_thresholds, ref.y_thresholds_, ISO_TOL)
    t = np.concatenate([rng.uniform(-0.2, 1.2, 200), x[:50]]).astype(dtype)
    g, w = ours.predict(t), ref.predict(t)
    assert g.dtype == w.dtype
    close(g, w, ISO_TOL)


def test_isotonic_fit_single_point():
    ours = pp.IsotonicFit(0.0, 1.0).fit(np.full(5, 0.3, np.float32), np.ones(5))
    ref = IsotonicRegression(y_min=0.0, y_max=1.0, out_of_bounds="clip").fit(
        np.full(5, 0.3, np.float32), np.ones(5))
    t = np.asarray([0.1, 0.3, 0.9], np.float32)
    np.testing.assert_array_equal(ours.predict(t), ref.predict(t))


def test_tta_boosted_calibration():
    rng = np.random.default_rng(5)
    w = rng.normal(0, 0.05, (3072, 10)).astype(np.float32)
    x = rng.integers(0, 256, (16, 32, 32, 3), dtype=np.uint8)
    y = rng.integers(0, 10, 16).astype(np.int32)
    wt, wj = torch.from_numpy(w), jnp.asarray(w)
    pfn = lambda v: (v.reshape(v.shape[0], -1).to(torch.float32) / 255.0) @ wt  # noqa: E731
    jfn = lambda v: (v.reshape(v.shape[0], -1).astype(jnp.float32) / 255.0) @ wj  # noqa: E731
    jcal = jp.TTABoostedCalibration(jp.TemperatureScaling(), [lambda v: v[:, ::-1],
                                                              lambda v: v[:, :, ::-1]])
    jcal.fit(jfn(jnp.asarray(x)), jnp.asarray(y))
    pcal = pp.TTABoostedCalibration(pp.TemperatureScaling(jcal.base.temperature),
                                    [lambda v: torch.flip(v, (1,)), lambda v: torch.flip(v, (2,))])
    close(pcal.calibrate_with_model(pfn, torch.from_numpy(x)),
          jcal.calibrate_with_model(jfn, jnp.asarray(x)))
    assert pcal.fit(pfn(torch.from_numpy(x)), torch.from_numpy(y)) is pcal
