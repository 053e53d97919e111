"""Post-hoc calibration (PyTorch and numpy): temperature scaling, an
ensemble of temperatures, isotonic regression, and TTA-boosted calibration.

Counterpart of ``imagetransformations_tpu/adapt/posthoc.py``
(fall_2025/post_hoc_aaryaa.py):

- TemperatureScaling (:72-110): ``uq.calibration.fit_temperature`` (Adam
  on log T);
- EnsembleTemperatureScaling (:112-163): softmax weights over the fixed
  temperatures {1, 1.5, 2, 3, 4}, by 300 Adam steps on the NLL (optax's
  Adam, ``adapt._optim``);
- IsotonicRegressionCalibration (:165-216): one-vs-rest isotonic fits,
  one a class, renormalised;
- AccuracyPreservingIsotonicRegression (:218-274): an isotonic fit of the
  top probability, the argmax kept;
- TTABoostedCalibration (:276-350): calibrated probabilities averaged
  over augmented views.

The JAX package fits the isotonic calibrators with scikit-learn's
``IsotonicRegression(out_of_bounds="clip")``. The port has its own fit
(``IsotonicFit``), with scikit-learn's rules, and needs no scikit-learn.
The isotonic calibrators, as in JAX, take and return numpy arrays on the
host; the temperature ones take logits tensors and run on their device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from imagetransformations_tpu_torch.adapt import _optim
from imagetransformations_tpu_torch.core.image import to_host
from imagetransformations_tpu_torch.core.precision import full_f32
from imagetransformations_tpu_torch.uq.calibration import fit_temperature


@dataclasses.dataclass
class TemperatureScaling:
    temperature: float = 1.0

    def fit(self, logits: torch.Tensor, labels: torch.Tensor) -> "TemperatureScaling":
        self.temperature = float(fit_temperature(logits, labels))
        return self

    def calibrate(self, logits: torch.Tensor) -> torch.Tensor:
        t = torch.tensor(self.temperature, dtype=torch.float32).to(logits.device)
        return torch.softmax(logits / t, dim=-1)


def _ensemble_probs(logits: torch.Tensor, ts: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """sum_t w_t softmax(logits / T_t)."""
    member = torch.softmax(logits[None] / ts[:, None, None], dim=-1)
    with full_f32():
        return torch.einsum("t,tbc->bc", w, member)


@dataclasses.dataclass
class EnsembleTemperatureScaling:
    temperatures: tuple[float, ...] = (1.0, 1.5, 2.0, 3.0, 4.0)
    weights: np.ndarray | None = None

    def fit(self, logits: torch.Tensor, labels: torch.Tensor,
            steps: int = 300) -> "EnsembleTemperatureScaling":
        """Weights softmax(w), w from zeros by ``steps`` Adam steps at 0.05 on
        the NLL of the mixture (its probabilities clipped to [1e-12, 1])."""
        logits = logits.detach()
        ts = torch.tensor(self.temperatures, dtype=torch.float32).to(logits.device)
        idx = labels.long()[:, None]
        params = {"w": torch.zeros(len(self.temperatures), device=logits.device)}
        state = _optim.adam_init(params)
        for _ in range(int(steps)):
            w = params["w"].requires_grad_(True)
            with full_f32(), torch.enable_grad():
                p = _ensemble_probs(logits, ts, torch.softmax(w, dim=0))
                lp = torch.log(torch.clamp(p, 1e-12, 1.0))
                (g,) = torch.autograd.grad(-torch.mean(torch.gather(lp, 1, idx)), w)
            updates, state = _optim.adam_update({"w": g}, state, 0.05)
            with torch.no_grad():
                params = _optim.apply_updates({"w": w.detach()}, updates)
        self.weights = torch.softmax(params["w"], dim=0).cpu().numpy()
        return self

    def calibrate(self, logits: torch.Tensor) -> torch.Tensor:
        ts = torch.tensor(self.temperatures, dtype=torch.float32).to(logits.device)
        w = torch.tensor(np.asarray(self.weights, np.float32)).to(logits.device)
        return _ensemble_probs(logits, ts, w)


def _make_unique(x: np.ndarray, y: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """scikit-learn's ``_make_unique`` on sorted ``x``: a run of values that
    lie within ``finfo(dtype).resolution`` of the run's first value (1e-6
    for f32, 1e-15 for f64, the difference taken in the dtype) becomes one
    point, its y the mean of the run's. Returns (x, y, count) per point."""
    dt = x.dtype.type
    eps = dt(np.finfo(x.dtype).resolution)
    starts, i, n = [], 0, len(x)
    while i < n:
        starts.append(i)
        j = int(np.searchsorted(x, x[i] + eps, side="left"))
        while j > i + 1 and dt(x[j - 1] - x[i]) >= eps:
            j -= 1
        while j < n and dt(x[j] - x[i]) < eps:
            j += 1
        i = max(j, i + 1)
    starts = np.asarray(starts)
    count = np.diff(np.append(starts, n)).astype(x.dtype)
    return x[starts], (np.add.reduceat(y, starts) / count).astype(x.dtype), count


def _pava(y: np.ndarray, w: np.ndarray) -> np.ndarray:
    """The increasing least-squares fit of ``y`` with weights ``w`` by pool
    adjacent violators, in f64: blocks merge while a block's mean is not
    above the one before it."""
    means, weights, sizes = [], [], []
    for v, wt in zip(y.astype(np.float64), w.astype(np.float64)):
        m, s, k = v, wt, 1
        while means and means[-1] >= m:
            pm, ps, pk = means.pop(), weights.pop(), sizes.pop()
            m = (pm * ps + m * s) / (ps + s)
            s, k = ps + s, pk + k
        means.append(m)
        weights.append(s)
        sizes.append(k)
    return np.repeat(np.asarray(means), sizes)


class IsotonicFit:
    """``sklearn.isotonic.IsotonicRegression(out_of_bounds="clip", y_min,
    y_max)`` by the same rules, in the dtype of ``x`` (f32 or f64, as
    scikit-learn keeps it; y is cast to it): sort by (x, y), merge equal x
    (``_make_unique``) into the mean y, the increasing fit (``_pava``, f64,
    cast back), y clipped to [y_min, y_max], the points inside a run of
    equal y dropped; ``predict`` clips its input to the fitted range and
    interpolates linearly between the points (scipy's ``interp1d``
    arithmetic)."""

    def __init__(self, y_min: float | None = None, y_max: float | None = None):
        self.y_min, self.y_max = y_min, y_max

    def fit(self, x, y) -> "IsotonicFit":
        x = np.asarray(x).reshape(-1)
        if x.dtype not in (np.float32, np.float64):
            x = x.astype(np.float64)
        y = np.asarray(y).reshape(-1).astype(x.dtype)
        order = np.lexsort((y, x))
        ux, uy, uw = _make_unique(x[order], y[order])
        fy = _pava(uy, uw).astype(x.dtype)
        lo = -np.inf if self.y_min is None else self.y_min
        hi = np.inf if self.y_max is None else self.y_max
        np.clip(fy, lo, hi, fy)
        self.x_min, self.x_max = np.min(ux), np.max(ux)
        keep = np.ones(len(fy), dtype=bool)
        keep[1:-1] = (fy[1:-1] != fy[:-2]) | (fy[1:-1] != fy[2:])
        self.x_thresholds, self.y_thresholds = ux[keep], fy[keep]
        return self

    def predict(self, t) -> np.ndarray:
        xs, ys = self.x_thresholds, self.y_thresholds
        t = np.clip(np.asarray(t, xs.dtype).reshape(-1), self.x_min, self.x_max)
        if len(ys) == 1:
            return np.repeat(ys, t.shape)
        hi = np.clip(np.searchsorted(xs, t), 1, len(xs) - 1)
        lo = hi - 1
        slope = (ys[hi] - ys[lo]) / (xs[hi] - xs[lo])
        return (slope * (t - xs[lo]) + ys[lo]).astype(t.dtype)


class IsotonicRegressionCalibration:
    """One-vs-rest isotonic regression, one fit a class, y in [0, 1]."""

    def __init__(self):
        self._models = []

    def fit(self, probs, labels) -> "IsotonicRegressionCalibration":
        probs, labels = to_host(probs), to_host(labels)
        self._models = [IsotonicFit(0.0, 1.0).fit(probs[:, k], (labels == k).astype(np.float64))
                        for k in range(probs.shape[-1])]
        return self

    def calibrate(self, probs) -> np.ndarray:
        probs = to_host(probs)
        out = np.stack([m.predict(probs[:, k]) for k, m in enumerate(self._models)], axis=1)
        return out / np.maximum(out.sum(axis=1, keepdims=True), 1e-12)


class AccuracyPreservingIsotonicRegression:
    """Isotonic regression of the top probability on correctness (y in
    [1e-6, 1]), the argmax preserved (post_hoc_aaryaa.py:218-274)."""

    def __init__(self):
        self._model = None

    def fit(self, probs, labels) -> "AccuracyPreservingIsotonicRegression":
        probs = to_host(probs)
        correct = (probs.argmax(axis=1) == to_host(labels)).astype(np.float64)
        self._model = IsotonicFit(1e-6, 1.0).fit(probs.max(axis=1), correct)
        return self

    def calibrate(self, probs) -> np.ndarray:
        probs = to_host(probs)
        conf = probs.max(axis=1, keepdims=True)
        new_conf = self._model.predict(conf[:, 0])[:, None]
        # argmax preservation: the rescaled runner-up p2*(1-nc)/(1-conf) must
        # stay below nc, i.e. nc >= p2 / (1 - conf + p2)
        is_max = probs == conf
        p2 = np.where(is_max, -np.inf, probs).max(axis=1, keepdims=True)
        floor = p2 / np.maximum(1.0 - conf + p2, 1e-12)
        new_conf = np.clip(np.maximum(new_conf, floor * (1.0 + 1e-6) + 1e-9), 1e-9, 1.0)
        rest = probs * (1.0 - new_conf) / np.maximum(1.0 - conf, 1e-12)
        out = np.where(is_max, new_conf, rest)
        return out / np.maximum(out.sum(axis=1, keepdims=True), 1e-12)


class TTABoostedCalibration:
    """Calibrated probabilities averaged over augmented views
    (post_hoc_aaryaa.py:276-350)."""

    def __init__(self, base_calibrator, augment_fns):
        self.base = base_calibrator
        self.augment_fns = augment_fns  # batched image -> image functions

    def fit(self, logits, labels) -> "TTABoostedCalibration":
        self.base.fit(logits, labels)
        return self

    def calibrate_with_model(self, model_fn, images: torch.Tensor) -> torch.Tensor:
        """The mean over the input and its ``augment_fns`` views of the base
        calibrator's probabilities of ``model_fn``'s logits, on the images'
        device."""
        views = [images] + [f(images) for f in self.augment_fns]
        with torch.no_grad(), full_f32():
            probs = [torch.as_tensor(self.base.calibrate(model_fn(v))).to(images.device)
                     for v in views]
        return torch.mean(torch.stack(probs), dim=0)
