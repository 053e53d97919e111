"""The port's test-time augmentation (``adapt.tta``) against the JAX
package's (CPU).

u8 batches of 32x32 (and 20x28 for the crops and resizes) from numpy
seeds; JAX's crop offsets (``jax.random.randint`` under its key splits)
passed to the port; a linear model on the flattened pixels. Budgets: every
view 0 LSB (reflect crops, flips, PIL bilinear resizes, brightness and
contrast are exact on both sides); probabilities within 1e-6 absolute
(f32 softmax and averages in another order); ``fit_adaptive_weights``:
the weights within 1e-6 of JAX's, or, where SLSQP's path parts, JAX's
objective at the port's weights no worse than at the uniform start and
within 0.25 of its value at JAX's weights. SLSQP differentiates a
piecewise-constant ECE by finite differences of 1.5e-8, so one ulp of the
ECE (the two packages sum a bin's confidences in another order) is a
slope of ~2 and picks the path. Measured on these 3 seeds x 2 penalties
with JAX's view probabilities: 4 cases equal, seed 6 at penalty 10 9.4e-6
apart in the weights (the port's objective 2.7e-7 lower), seed 6 at
penalty 0 apart (JAX's path reaches one view at ECE 0.1350, the port's
stays uniform at 0.3368: a gap of 0.2018).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagetransformations_tpu.adapt import tta as jtta
from imagetransformations_tpu.uq.calibration import ece as j_ece
from imagetransformations_tpu_torch.adapt import tta as ptta

from test_torch_models import _torch_threads  # noqa: F401

WEIGHT_TOL, OBJECTIVE_TOL, PROB_TOL = 1e-6, 0.25, 1e-6


def imgs(seed, n=8, h=32, w=32):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def crop_offsets(key):
    """(top, left) that JAX's ``_pad_crop(x, 2, key)`` draws."""
    ky, kx = jax.random.split(key)
    return (int(jax.random.randint(ky, (), 0, 5)), int(jax.random.randint(kx, (), 0, 5)))


def linear(seed, d=3072, c=10):
    """A linear model on the pixels / 255 (logits ~N(0, 1.6))."""
    w = np.random.default_rng(seed).normal(0, 0.05, (d, c)).astype(np.float32)
    wt, wj = torch.from_numpy(w), jnp.asarray(w)
    return (lambda x: (x.reshape(x.shape[0], -1).to(torch.float32) / 255.0) @ wt,
            lambda x: (x.reshape(x.shape[0], -1).astype(jnp.float32) / 255.0) @ wj)


@pytest.mark.parametrize("shape", [(32, 32), (20, 28)])
@pytest.mark.parametrize("seed", range(3))
def test_pad_crop(shape, seed):
    x = imgs(seed, 3, *shape)
    key = jax.random.key(seed)
    want = np.asarray(jtta._pad_crop(jnp.asarray(x), 2, key))
    top, left = crop_offsets(key)
    np.testing.assert_array_equal(ptta.pad_crop(torch.from_numpy(x), 2, top, left).numpy(), want)


@pytest.mark.parametrize("name", ["gentle_stack", "multiscale_stack", "color_stack"])
@pytest.mark.parametrize("shape", [(32, 32), (20, 28)])
def test_stacks_match_jax(name, shape):
    x = imgs(1, 4, *shape)
    key = jax.random.key(7)
    want = getattr(jtta, name)(jnp.asarray(x), key)
    offsets = [crop_offsets(k) for k in jax.random.split(key)]
    got = getattr(ptta, name)(torch.from_numpy(x), offsets=offsets)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_gentle_stack_draws_from_a_generator():
    x = torch.from_numpy(imgs(2, 2))
    a = ptta.gentle_stack(x, torch.Generator().manual_seed(5))
    b = ptta.gentle_stack(x, torch.Generator().manual_seed(5))
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    with pytest.raises(ValueError, match="offsets"):
        ptta.gentle_stack(x)


def test_strategy_table():
    assert {k: v.__name__ for k, v in ptta.CORRUPTION_TO_STRATEGY.items()} == {
        k: v.__name__ for k, v in jtta.CORRUPTION_TO_STRATEGY.items()}


@pytest.mark.parametrize("name", ["gentle_stack", "multiscale_stack", "color_stack"])
def test_predict_with_tta(name):
    x = imgs(3)
    pfn, jfn = linear(3)
    key = jax.random.key(11)
    want = jtta.predict_with_tta(jfn, jnp.asarray(x), key, stack=getattr(jtta, name))
    offsets = [crop_offsets(k) for k in jax.random.split(key)]
    got = ptta.predict_with_tta(pfn, x, stack=getattr(ptta, name), offsets=offsets,
                                device="cpu")
    assert got.shape == (8, 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=PROB_TOL)


@pytest.fixture(scope="module", params=[4, 5, 6])
def adaptive(request):
    """64 images, JAX's and the port's view probabilities and labels."""
    x = imgs(request.param, 64)
    pfn, jfn = linear(request.param)
    key = jax.random.key(12)
    jvp = jtta.adaptive_view_probs(jfn, jnp.asarray(x), key)
    offsets = [crop_offsets(jax.random.split(key)[0])]
    pvp = ptta.adaptive_view_probs(pfn, x, offsets=offsets, device="cpu")
    labels = np.asarray(jax.random.categorical(jax.random.key(13), jfn(jnp.asarray(x)) * 3))
    return x, pfn, jfn, key, offsets, np.asarray(jvp), pvp, labels


def test_adaptive_view_probs(adaptive):
    _, _, _, _, _, jvp, pvp, _ = adaptive
    assert pvp.shape == jvp.shape == (5, 64, 10)
    np.testing.assert_allclose(pvp.numpy(), jvp, rtol=0, atol=PROB_TOL)


def _objective(view_probs, labels, w, acc_penalty=10.0):
    """JAX's SLSQP objective (tta.py:117-127) at the weights ``w``."""
    mixed = np.einsum("v,vbc->bc", w, view_probs)
    base = float((view_probs[0].argmax(-1) == labels).mean())
    acc = float((mixed.argmax(-1) == labels).mean())
    ece = float(j_ece(jnp.asarray(mixed), jnp.asarray(labels)))
    return ece + acc_penalty * max(0.0, base - acc)


@pytest.mark.parametrize("penalty", [10.0, 0.0])
def test_fit_adaptive_weights(adaptive, penalty):
    _, _, _, _, _, jvp, pvp, labels = adaptive
    want = jtta.fit_adaptive_weights(jvp, labels, acc_penalty=penalty)
    uniform = _objective(jvp, labels, np.full(5, 0.2), penalty)
    best = _objective(jvp, labels, want, penalty)
    for probs in (jvp, pvp):  # JAX's view probabilities, then the port's own
        got = ptta.fit_adaptive_weights(probs, torch.from_numpy(labels.copy()),
                                        acc_penalty=penalty)
        assert got.shape == (5,) and abs(got.sum() - 1.0) < 1e-9 and (got >= 0).all()
        if np.abs(got - want).max() > WEIGHT_TOL:  # SLSQP's paths parted: the objective holds
            value = _objective(jvp, labels, got, penalty)
            assert value <= best + OBJECTIVE_TOL and value <= uniform


def test_predict_adaptive(adaptive):
    x, pfn, jfn, key, offsets, jvp, _, labels = adaptive
    w = jtta.fit_adaptive_weights(jvp, labels)
    want = jtta.predict_adaptive(jfn, jnp.asarray(x), key, w)
    got = ptta.predict_adaptive(pfn, x, w, offsets=offsets, device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=PROB_TOL)
