"""The port's angelic patches against the JAX package's (CPU), on JAX's own
draws (made from ``jax.random`` keys as JAX makes them, turned into numpy
and passed to the port explicitly).

Budgets:
- ``apply_patch``: equal, center and random position;
- ``apply_transformed_patch`` and ``adet_operator``: within 1e-5 where both
  place the patch alike, and the patch mask (alpha >= 0.5) equal on >=
  99.5% of pixels (f32 trig and warp rounding at the 0.5 threshold);
- ``train_universal_patch`` (5 sign-SGD steps, a linear model, a noise
  corruption from JAX's keys): equal wherever JAX's gradient exceeds 1e-6
  at every step;
- ``restorative_patches_per_image`` (8 Adam steps, 4x32x32x3): rtol 1e-5
  with atol 1e-5 (Adam divides by sqrt(v) + 1e-8: where a gradient is ~1e-6
  its summation order moves the step by ~1e-6 a step);
- JAX's three ``TestAdetOperator`` properties, on the port.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from imagetransformations_tpu.adapt import patches as jp
from imagetransformations_tpu_torch.adapt import patches as pp

VALUE_ATOL = 1e-5
MASK_SHARE = 0.995


def _t(a):
    return torch.from_numpy(np.array(a))


def _adet_draws(key, n, shape, scale_range=(0.8, 1.2), rotate_deg=15.0, shear_max=0.15,
                brightness_jitter=0.2):
    """adet_operator's draws from ``key``, as JAX's patches.py:91-121 makes them."""
    ks, kr, ksh, kb, ky, kx, kc, kn = jax.random.split(key, 8)
    u = jax.random.uniform
    return dict(
        corruption_idx=np.asarray(jax.random.randint(kc, (n, 1, 1, 1), 0, 2)).reshape(n),
        scale=np.asarray(u(ks, (n,), minval=scale_range[0], maxval=scale_range[1])),
        angle=np.asarray(u(kr, (n,), minval=-rotate_deg, maxval=rotate_deg)),
        shear=np.asarray(u(ksh, (n,), minval=-shear_max, maxval=shear_max)),
        brightness=np.asarray(u(kb, (n,), minval=1.0 - brightness_jitter,
                                maxval=1.0 + brightness_jitter)),
        y_u=np.asarray(u(ky, (n,))), x_u=np.asarray(u(kx, (n,))),
        noise=np.asarray(jax.random.normal(kn, shape)))


def _position(key, h, w, ph, pw):
    ky, kx = jax.random.split(key)
    return (int(jax.random.randint(ky, (), 0, h - ph + 1)),
            int(jax.random.randint(kx, (), 0, w - pw + 1)))


def test_apply_patch_equals_jax(rng):
    x = rng.random((3, 20, 27, 3)).astype(np.float32)
    patch = rng.random((5, 6, 3)).astype(np.float32)
    got = pp.apply_patch(_t(x), _t(patch)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jp.apply_patch(jnp.asarray(x),
                                                                 jnp.asarray(patch))))
    for seed in range(4):
        key = jax.random.key(seed)
        y0, x0 = _position(key, 20, 27, 5, 6)
        got = pp.apply_patch(_t(x), _t(patch), "random", y0=y0, x0=x0).numpy()
        want = np.asarray(jp.apply_patch(jnp.asarray(x), jnp.asarray(patch), "random", key))
        np.testing.assert_array_equal(got, want)
    # drawn from a generator: inside the image; an explicit position clamped
    g = torch.Generator().manual_seed(0)
    out = pp.apply_patch(_t(x), torch.full((5, 6, 3), 9.0), "random", g)
    assert int((out == 9.0).sum()) == 3 * 5 * 6 * 3
    out = pp.apply_patch(_t(x), torch.full((5, 6, 3), 9.0), "random", y0=99, x0=-3)
    assert (out[:, 15:, :6] == 9.0).all()
    with pytest.raises(ValueError, match="Generator"):
        pp.apply_patch(_t(x), _t(patch), "random")


def test_apply_transformed_patch_matches_jax(rng):
    worst = 0.0
    for seed in range(6):
        x = rng.random((4, 32, 32, 3)).astype(np.float32)
        patch = rng.random((8, 8, 3)).astype(np.float32)
        key = jax.random.key(seed)
        ks, kr, kp = jax.random.split(key, 3)
        scale = float(jax.random.uniform(ks, (), minval=0.8, maxval=1.2))
        angle = float(jax.random.uniform(kr, (), minval=-15.0, maxval=15.0))
        y0, x0 = _position(kp, 32, 32, 8, 8)
        want = np.asarray(jp.apply_transformed_patch(jnp.asarray(x), jnp.asarray(patch), key))
        got = pp.apply_transformed_patch(_t(x), _t(patch), scale=scale, angle=angle, y0=y0,
                                         x0=x0).numpy()
        # the warp's validity edge: both zero-filled alike where the patch
        # canvas is empty (a ones patch maps to the mask)
        ones = np.ones_like(patch)
        mj = np.asarray(jp.apply_transformed_patch(jnp.zeros_like(x), jnp.asarray(ones), key)) > 0
        mp = pp.apply_transformed_patch(torch.zeros(x.shape), _t(ones), scale=scale,
                                        angle=angle, y0=y0, x0=x0).numpy() > 0
        assert (mj == mp).mean() >= MASK_SHARE
        same = mj == mp
        worst = max(worst, float(np.abs(got - want)[same].max()))
    assert worst <= VALUE_ATOL, worst
    g = torch.Generator().manual_seed(1)
    assert pp.apply_transformed_patch(_t(x), _t(patch), g).shape == x.shape


def _masks(patch, key, draws, n, h, w, **kwargs):
    """Where each package pastes the patch: on images of -1 (below any
    patch value), with the same draws and no corruption."""
    neg = -np.ones((n, h, w, patch.shape[-1]), np.float32)
    mj = np.asarray(jp.adet_operator(jnp.asarray(neg), jnp.asarray(patch), key,
                                     corruption_fns=None, **kwargs)) >= 0
    d = {k: v for k, v in draws.items() if k not in ("noise", "corruption_idx")}
    mp = pp.adet_operator(_t(neg), _t(patch), corruption_fns=None, **d, **kwargs).numpy() >= 0
    return mj, mp


@pytest.mark.parametrize("kwargs", [{}, {"rotate_deg": 30.0, "shear_max": 0.3},
                                    {"rotate_deg": 0.0, "shear_max": 0.0,
                                     "brightness_jitter": 0.0}])
def test_adet_operator_matches_jax(rng, kwargs):
    n, h, w = 6, 32, 40
    for seed in range(3):
        x = rng.random((n, h, w, 3)).astype(np.float32)
        patch = rng.random((9, 7, 3)).astype(np.float32)
        key = jax.random.key(10 * seed + len(kwargs))
        draws = _adet_draws(key, n, x.shape, **kwargs)
        mj, mp = _masks(patch, key, draws, n, h, w, **kwargs)
        assert (mj == mp).mean() >= MASK_SHARE, (mj != mp).mean()
        want = np.asarray(jp.adet_operator(jnp.asarray(x), jnp.asarray(patch), key, **kwargs))
        got = pp.adet_operator(_t(x), _t(patch), **draws, **kwargs).numpy()
        same = mj == mp
        assert float(np.abs(got - want)[same].max()) <= VALUE_ATOL
        # no corruption: the images outside the patch are untouched
        got = pp.adet_operator(_t(x), _t(patch), corruption_fns=(), **draws, **kwargs).numpy()
        np.testing.assert_array_equal(got[~mp], x[~mp])


def _linear(rng, scale, d=192):
    w = (rng.standard_normal((d, 10)) * scale).astype(np.float32)
    wj, wt = jnp.asarray(w), torch.from_numpy(w)
    return (lambda xb: xb.reshape(xb.shape[0], -1) @ wj,
            lambda xb: xb.reshape(xb.shape[0], -1) @ wt)


def test_train_universal_patch_matches_jax(rng):
    jfn, pfn = _linear(rng, 1.0)
    batches = [rng.random((16, 8, 8, 3)).astype(np.float32) for _ in range(5)]
    labels = [rng.integers(0, 10, 16).astype(np.int32) for _ in range(5)]
    # the corruption's noise, from the keys JAX's loop splits (patches.py:178-180)
    key, noises = jax.random.key(0), []
    for x in batches:
        key, k = jax.random.split(key)
        noises.append(np.asarray(jax.random.normal(k, x.shape)))

    def jcorrupt(x, k):
        return jnp.clip(x + 0.1 * jax.random.normal(k, x.shape), 0.0, 1.0)

    queue = list(noises)

    def pcorrupt(x, generator):
        return torch.clamp(x + 0.1 * _t(queue.pop(0)), 0.0, 1.0)

    kw = dict(patch_hw=(3, 3), lr=0.05)
    want = np.asarray(jp.train_universal_patch(jfn, [jnp.asarray(b) for b in batches],
                                               [jnp.asarray(y) for y in labels],
                                               corruption_fn=jcorrupt, **kw))
    got = pp.train_universal_patch(pfn, batches, labels, corruption_fn=pcorrupt,
                                   device="cpu", **kw).numpy()
    # JAX's gradients along its own trajectory: where any is below 1e-6 a
    # rounding may flip the sign step
    p, steady = jnp.zeros((3, 3, 3)) + 0.5, np.ones((3, 3, 3), bool)
    for x, y, z in zip(batches, labels, noises):
        xc = jnp.clip(jnp.asarray(x) + 0.1 * jnp.asarray(z), 0.0, 1.0)

        def loss(pt):
            logits = jfn(jp.apply_patch(xc, pt))
            return optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()

        g = jax.grad(loss)(p)
        steady &= np.abs(np.asarray(g)) > 1e-6
        p = jnp.clip(p - 0.05 * jnp.sign(g), 0.0, 1.0)
    np.testing.assert_array_equal(np.asarray(p), want)  # the replay is JAX's
    assert steady.mean() > 0.9
    np.testing.assert_array_equal(got[steady], want[steady])


def test_restorative_patches_match_jax(rng):
    jfn, pfn = _linear(rng, 0.05, 3072)
    x = rng.random((4, 32, 32, 3)).astype(np.float32)
    wp, wpat = jp.restorative_patches_per_image(jfn, jnp.asarray(x), iters=8)
    gp, gpat = pp.restorative_patches_per_image(pfn, x, iters=8, device="cpu")
    np.testing.assert_allclose(gpat.numpy(), np.asarray(wpat), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=1e-5, atol=1e-5)
    assert tuple(gpat.shape) == (4, 8, 8, 3)


def test_patches_lower_their_losses(rng):
    """JAX's ``test_universal_patch_reduces_loss`` and
    ``test_restorative_patches_reduce_entropy``, on the port."""
    w = torch.from_numpy(rng.standard_normal((192, 10)).astype(np.float32))

    def model_fn(xb):
        return xb.reshape(xb.shape[0], -1) @ w

    x = torch.from_numpy(rng.random((32, 8, 8, 3)).astype(np.float32))
    y = torch.argmax(model_fn(x), -1)
    patch = pp.train_universal_patch(model_fn, [x] * 20, [y] * 20, patch_hw=(3, 3), lr=0.05,
                                     device="cpu")
    ce = lambda xb: float(torch.nn.functional.cross_entropy(model_fn(xb), y))  # noqa: E731
    assert ce(pp.apply_patch(x, patch)) < ce(pp.apply_patch(x, torch.full((3, 3, 3), 0.5)))
    x8 = x[:8]
    patched, _ = pp.restorative_patches_per_image(model_fn, x8, patch_hw=(3, 3), iters=15,
                                                  device="cpu")
    assert float(pp._mean_entropy(model_fn(patched))) < float(pp._mean_entropy(model_fn(x8)))


class TestAdetOperator:
    """JAX's ``TestAdetOperator`` (tests/test_adapt_attacks.py), on the port
    with generator draws."""

    def test_patch_lands_with_per_image_placement(self):
        imgs = torch.zeros((6, 32, 32, 3))
        out = pp.adet_operator(imgs, torch.ones((8, 8, 3)), torch.Generator().manual_seed(0),
                               corruption_fns=None, brightness_jitter=0.0).numpy()
        covered = (out > 0.5).any(axis=-1).reshape(6, -1).sum(axis=1)
        assert (covered >= 0.5 * 64).all() and (covered <= 2.5 * 64).all(), covered
        masks = (out > 0.5).any(axis=-1)
        assert any(not np.array_equal(masks[0], masks[i]) for i in range(1, 6))

    def test_corruption_pool_applied_outside_patch(self):
        imgs = torch.full((8, 32, 32, 3), 0.5)
        out = pp.adet_operator(imgs, torch.zeros((4, 4, 3)),
                               torch.Generator().manual_seed(1)).numpy()
        assert (np.abs(out - 0.5) > 1e-4).any()

    def test_strict_reference_mode_scale_position_only(self):
        out = pp.adet_operator(torch.zeros((4, 32, 32, 3)), torch.ones((8, 8, 3)),
                               torch.Generator().manual_seed(2), rotate_deg=0.0, shear_max=0.0,
                               brightness_jitter=0.0, corruption_fns=None).numpy()
        m = (out > 0.5).any(axis=-1)
        for i in range(4):
            ys, xs = np.where(m[i])
            assert m[i][ys.min():ys.max() + 1, xs.min():xs.max() + 1].all()


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = np.zeros((2, 8, 8, 3), np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        pp.train_universal_patch(lambda z: z.reshape(2, -1), [x], [np.zeros(2, np.int64)])
    with pytest.raises(RuntimeError, match="CUDA"):
        pp.restorative_patches_per_image(lambda z: z.reshape(2, -1), x)
