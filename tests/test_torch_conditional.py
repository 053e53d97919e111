"""The port's entropy-conditioned transforms (``adapt.conditional``) against
the JAX package's (CPU).

Batches of 32x32 and 24x40 images, some flat (entropy <= 1.6 bits), some
noise (~7.6 bits), some a few gray levels (1-3 bits), the main-path chain
blur 1.5 -> rotation 15 -> grayscale (the fused kernels' plain versions;
JAX's in interpret mode) and a photometric chain. Budgets: the flagged
masks and gate fractions equal (every image's entropy at least 1e-4 from
the threshold on both sides: checked); the mixed batch within 1 LSB on
<= 0.1% of values (the chain tests' budget: XLA-CPU contracts FMAs) and
the unflagged images untouched; ``conditional_transform_eval``'s counts
and accuracies equal. ``test_entropy_gap`` measures how far the two
packages' entropies lie apart (the port sums in f64, JAX f32 terms), the
margin a gate needs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagetransformations_tpu.adapt import conditional as jc
from imagetransformations_tpu.ops.histogram import image_entropy as j_entropy
from imagetransformations_tpu.pipeline import chain as jchain
from imagetransformations_tpu_torch.adapt import conditional as pc
from imagetransformations_tpu_torch.ops.histogram import image_entropy
from imagetransformations_tpu_torch.pipeline import chain as pchain

from test_torch_models import _torch_threads  # noqa: F401

MAIN = [("blur", {"radius": 1.5}), ("rotation", {"angle": 15.0}), ("grayscale", {})]
PHOTO = [("enhance_contrast", {"factor": 1.4}), ("brightness", {"factor": 0.05})]
MARGIN = 1e-4


def batch(seed, n=12, h=32, w=32):
    """n images: a third noise, a third flat, a third of 2-8 gray levels."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)
    k = n // 3
    x[k: 2 * k] = rng.integers(0, 256, (k, 1, 1, 3), dtype=np.uint8)
    for i in range(2 * k, n):
        levels = rng.integers(0, 256, int(rng.integers(2, 9)), dtype=np.uint8)
        x[i] = levels[rng.integers(0, len(levels), (h, w, 1))]
    return x


def specs(module, ops):
    return [module.OpSpec(name, dict(p)) for name, p in ops]


def assert_margin(x, thr):
    for e in (image_entropy(torch.from_numpy(x)).numpy(), np.asarray(j_entropy(jnp.asarray(x)))):
        assert np.all(np.abs(e - thr) >= MARGIN)


def assert_close_u8(got, want):
    err = np.abs(got.astype(int) - want.astype(int))
    assert err.max() <= 1 and (err > 0).mean() <= 0.001, (err.max(), (err > 0).mean())


@pytest.mark.parametrize("ops,shape,thr", [(MAIN, (32, 32), 1.16), (MAIN, (24, 40), 2.5),
                                            (PHOTO, (32, 32), 2.5)],
                         ids=["main-32", "main-24x40", "photometric"])
@pytest.mark.parametrize("above", [True, False])
def test_apply_if_entropy_matches_jax(ops, shape, above, thr):
    x = batch(1, 12, *shape)
    assert_margin(x, thr)
    mixed, flagged = pc.apply_if_entropy(x, specs(pchain, ops), thr, above, device="cpu")
    jmixed, jflagged = jc.apply_if_entropy(jnp.asarray(x), specs(jchain, ops), thr, above)
    np.testing.assert_array_equal(flagged.numpy(), np.asarray(jflagged))
    assert 0 < int(flagged.sum()) < len(x)
    assert mixed.shape == x.shape and mixed.dtype == torch.uint8
    np.testing.assert_array_equal(mixed.numpy()[~flagged.numpy()], x[~flagged.numpy()])
    assert_close_u8(mixed.numpy(), np.asarray(jmixed))


def test_noise_chain_takes_a_generator():
    x = batch(2)
    ops = specs(pchain, [("gaussian_noise", {"std": 0.05})])
    a, fa = pc.apply_if_entropy(x, ops, generator=torch.Generator().manual_seed(3), device="cpu")
    b, fb = pc.apply_if_entropy(x, ops, generator=torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(a, b) and torch.equal(fa, fb)
    with pytest.raises(ValueError, match="Generator"):
        pc.apply_if_entropy(x, ops, device="cpu")


@pytest.mark.parametrize("thr", [1.16, 2.5, 7.0])
def test_batch_gate_fraction(thr):
    x = batch(4, 15)
    assert_margin(x, thr)
    got = pc.batch_gate_fraction(torch.from_numpy(x), thr)
    assert got.dtype == torch.float32
    assert float(got) == float(jc.batch_gate_fraction(jnp.asarray(x), thr))


def test_conditional_transform_eval_matches_jax():
    rng = np.random.default_rng(5)
    w = rng.normal(0, 0.02, (3072, 10)).astype(np.float32)
    x = batch(6, 24)
    y = rng.integers(0, 10, 24).astype(np.int32)
    wt, wj = torch.from_numpy(w), jnp.asarray(w)
    got = pc.conditional_transform_eval(
        lambda m: m.reshape(m.shape[0], -1) @ wt, lambda u8: u8.to(torch.float32) / 255.0, x, y,
        specs(pchain, MAIN), 1.16, device="cpu")
    want = jc.conditional_transform_eval(
        lambda m: m.reshape(m.shape[0], -1) @ wj, lambda u8: u8.astype(jnp.float32) / 255.0,
        jnp.asarray(x), jnp.asarray(y), specs(jchain, MAIN), 1.16)
    assert got == want and 0 < got["n_flagged"] < 24


def test_entropy_gap():
    """The two packages' entropies over noise, flat, few-level and smooth
    images lie within 1e-5 bits of each other (measured 1.4e-6), far
    inside the gate margin of 1e-4."""
    rng = np.random.default_rng(7)
    xs = [batch(8, 30, 37, 53), rng.integers(100, 110, (10, 64, 64, 3), dtype=np.uint8)]
    smooth = np.cumsum(rng.integers(0, 3, (10, 48, 48, 3)), axis=2) % 256
    xs.append(smooth.astype(np.uint8))
    gap = max(float(np.abs(image_entropy(torch.from_numpy(x)).numpy()
                           - np.asarray(j_entropy(jnp.asarray(x)))).max()) for x in xs)
    assert gap <= 1e-5, gap
