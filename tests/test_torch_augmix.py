"""The port's AugMix (``adapt.augmix``) against the JAX package's and
against a numpy composition of the same ops (CPU).

JAX's own draws (its five key splits, as ``augmix`` makes them) are
passed to the port. Budgets:

- against the numpy composition (Pillow's NEAREST rotation per image, the
  posterize / solarize / equalize / NEAREST-shear / translation formulas in
  numpy f32, the blend with every f32 operation rounded): <= 1 LSB
  (measured 0 on every draw here);
- against JAX with draws that hold no rotation: <= 1 LSB on <= 1% of
  values (the f32 blend; XLA-CPU may contract an FMA; measured 0);
- against JAX with a rotation: JAX's f32 NEAREST rotation is not Pillow's
  (ROADMAP C.2.9: <= 0.5% of pixels within 45 degrees), and each chain
  carries such a pixel into the blend: values more than 1 LSB apart on
  <= 0.5% (measured 0 at 3x32x32, the one shape JAX compiles here).
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from imagetransformations_tpu.adapt import augmix as jaug
from imagetransformations_tpu_torch.adapt import augmix as paug

from test_torch_models import _torch_threads  # noqa: F401

ROTATION_SHARE, BLEND_SHARE = 0.005, 0.01


def jax_draws(key, width=3, max_depth=3, alpha=1.0):
    """The draws JAX's ``augmix(images, key)`` makes."""
    _, k_depth, k_ops, k_dir, k_beta = jax.random.split(key, 5)
    return {"ws": np.asarray(jax.random.dirichlet(k_dir, jnp.full((width,), alpha))),
            "m": np.asarray(jax.random.beta(k_beta, alpha, alpha)),
            "depth_draw": np.asarray(jax.random.randint(k_depth, (width,), 1, max_depth + 1)),
            "op_draw": np.asarray(jax.random.randint(k_ops, (width, max_depth), 0, 8))}


def applied_ops(d):
    return {int(d["op_draw"][i, k]) for i in range(len(d["depth_draw"]))
            for k in range(int(d["depth_draw"][i]))}


def keys_with(rotation: bool, count: int):
    """The first ``count`` seeds whose draws apply a rotation (or none)."""
    out, seed = [], 0
    while len(out) < count:
        has = bool(applied_ops(jax_draws(jax.random.key(seed))) & {0, 1})
        if has == rotation:
            out.append(seed)
        seed += 1
    return out


# ---------------------------------------------------------------- numpy model


def np_rotate(x, angle):
    return np.stack([np.asarray(Image.fromarray(im).rotate(-angle, resample=Image.NEAREST))
                     for im in x])


def np_equalize(x):
    n, h, w, c = x.shape
    out = np.empty_like(x)
    for i in range(n):
        v = x[i].reshape(h, w * c)
        hist = np.bincount(v.ravel(), minlength=256).astype(np.int64)
        cdf = np.cumsum(hist)
        cdf_min = cdf[hist > 0].min()
        denom = np.float32(max(v.size - cdf_min, 1))
        lut = np.clip(np.rint((cdf - cdf_min).astype(np.float32) * np.float32(255.0) / denom),
                      0, 255)
        out[i] = lut[v].reshape(h, w, c).astype(np.uint8)
    return out


def np_shear(x):
    n, h, w, c = x.shape
    f = np.float32
    m = np.asarray([1.0, 0.2, -0.2 * h / 2, 0.0, 1.0, 0.0], f)
    yo = (np.arange(h, dtype=f) + f(0.5))[:, None]
    xo = (np.arange(w, dtype=f) + f(0.5))[None, :]
    xx = (m[0] * xo + m[1] * yo).astype(f) + m[2]
    yy = (m[3] * xo + m[4] * yo).astype(f) + m[5]
    valid = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
    xi = np.clip(np.floor(xx).astype(int), 0, w - 1)
    yi = np.clip(np.floor(yy).astype(int), 0, h - 1)
    return np.where(valid[None, ..., None], x[:, yi, xi], 0).astype(np.uint8)


def np_translate(x, tx, ty):
    out = np.zeros_like(x)
    h, w = x.shape[1:3]
    out[:, max(ty, 0): h + min(ty, 0), max(tx, 0): w + min(tx, 0)] = \
        x[:, max(-ty, 0): h + min(-ty, 0), max(-tx, 0): w + min(-tx, 0)]
    return out


def np_augmix(x, d):
    n, h, w, c = x.shape
    ops = [lambda v: np_rotate(v, 15.0), lambda v: np_rotate(v, -15.0),
           lambda v: v & 0xF0, lambda v: np.where(v >= 128, 255 - v, v).astype(np.uint8),
           np_equalize, np_shear, lambda v: np_translate(v, int(w * 0.1), 0),
           lambda v: np_translate(v, 0, int(h * 0.1))]
    f = np.float32
    xf = x.astype(f)
    mix = np.zeros_like(xf)
    for i in range(len(d["depth_draw"])):
        chain = x
        for k in range(int(d["depth_draw"][i])):
            chain = ops[int(d["op_draw"][i, k])](chain)
        mix = (mix + (f(d["ws"][i]) * chain.astype(f)).astype(f)).astype(f)
    m = f(d["m"])
    out = ((f(1.0) - m) * xf).astype(f) + (m * mix).astype(f)
    return np.clip(np.rint(out), 0, 255).astype(np.uint8)


def imgs(seed, n=4, h=32, w=32):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3), dtype=np.uint8)


def lsb(a, b):
    return np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))


# ---------------------------------------------------------------- the tests


@pytest.mark.parametrize("seed", keys_with(False, 3))
def test_augmix_without_rotation_matches_jax(seed):
    x = imgs(seed, 3, 32, 32)
    key = jax.random.key(seed)
    d = jax_draws(key)
    got = paug.augmix(x, draws=d, device="cpu").numpy()
    assert lsb(got, np_augmix(x, d)).max() <= 1
    err = lsb(got, jaug.augmix(jnp.asarray(x), key))
    assert err.max() <= 1 and (err > 0).mean() <= BLEND_SHARE, (err.max(), (err > 0).mean())


@pytest.mark.parametrize("seed", keys_with(True, 3))
def test_augmix_with_rotation(seed):
    """JAX at 3x32x32 (one compile of its switch over the 8 ops); the numpy
    composition also at 3x24x40."""
    key = jax.random.key(seed)
    d = jax_draws(key)
    for shape in ((24, 40), (32, 32)):
        x = imgs(seed, 3, *shape)
        got = paug.augmix(x, draws=d, device="cpu").numpy()
        assert got.shape == x.shape and got.dtype == np.uint8
        assert lsb(got, np_augmix(x, d)).max() <= 1
    err = lsb(got, jaug.augmix(jnp.asarray(x), key))
    assert (err > 1).mean() <= ROTATION_SHARE, (err > 1).mean()


@pytest.mark.parametrize("op", range(8))
def test_each_op_against_numpy(op):
    """One chain of one op, weight 1, m 1: the op's output itself."""
    x = imgs(op, 3, 28, 36)
    d = {"ws": np.asarray([1.0], np.float32), "m": np.float32(1.0),
         "depth_draw": np.asarray([1]), "op_draw": np.asarray([[op]])}
    got = paug.augmix(x, draws=d, device="cpu").numpy()
    np.testing.assert_array_equal(got, np_augmix(x, d))
    assert not np.array_equal(got, x)


def test_generator_draws():
    x = imgs(9)
    a = paug.augmix(x, torch.Generator().manual_seed(4), device="cpu")
    b = paug.augmix(x, torch.Generator().manual_seed(4), device="cpu")
    assert torch.equal(a, b) and a.dtype == torch.uint8
    d = paug.augmix_draws(np.random.default_rng(0), 3, 3, 1.0)
    assert d["ws"].shape == (3,) and abs(float(d["ws"].sum()) - 1.0) < 1e-6
    assert d["op_draw"].shape == (3, 3) and set(d["depth_draw"]) <= {1, 2, 3}
    with pytest.raises(ValueError, match="draws"):
        paug.augmix(x, device="cpu")
