"""The port's Monte-Carlo uncertainty (``uq.mc``) against the JAX package's
(CPU).

[T, B, C] logits from numpy seeds, the later ones with ties (a coarse grid,
repeated samples, tied classes, uniform rows); every reduction within rtol
1e-5 / atol 1e-6. MC dropout through ``dropout_fn`` on a CIFAR ResNet of
depth 8 carried from flax: at rate 0 every pass is JAX's forward; at rate
0.5 the passes replay from the generator's seed and differ from one another
(``jax.random`` cannot be replayed in torch, so the masks are not JAX's).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagetransformations_tpu import models as jm
from imagetransformations_tpu.uq import mc as jmc
from imagetransformations_tpu_torch import models as pm
from imagetransformations_tpu_torch.models.convert import _entries
from imagetransformations_tpu_torch.uq import mc as pmc

from test_torch_models import _torch_threads, nchw  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6


def carried(make_port, seed):
    """(flax variables, port module loaded from them by ``from_flax``): the
    flax tree is made from ``make_port()``'s initial weights under
    ``torch.manual_seed(seed)`` through the inverse of ``from_flax``'s name
    map (``convert._entries``), its BatchNorm statistics drawn with numpy
    (mean ~ N(0, 0.3), var ~ U(0.5, 1.5)). Faster than ``flax.init`` on
    the CPU, and the same carried tree on both sides."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        port = make_port()
    rng = np.random.default_rng(seed)
    state = port.state_dict()
    tree = {"params": {}, "batch_stats": {}}
    for key, coll, path, to_flax, _ in _entries(port):
        value = to_flax(state[key].numpy())
        if coll == "batch_stats":
            value = (rng.normal(0, 0.3, value.shape) if path[-1] == "mean"
                     else rng.uniform(0.5, 1.5, value.shape))
        node = tree[coll]
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(value, np.float32)
    return tree, pm.from_flax(make_port(), tree)


def mc_logits(seed, t=7, b=64, c=10):
    rng = np.random.default_rng(seed)
    lg = rng.normal(0, 3, (t, b, c)).astype(np.float32)
    if seed >= 1:
        lg = np.round(lg * 2) / 2  # coarse grid: tied probabilities
    if seed >= 2:
        lg[1::2] = lg[0]  # repeated samples: zero variance across them
    if seed >= 3:
        lg[..., 4] = lg[..., 2]  # tied classes, also in the BMA argmax
    if seed == 4:
        lg[:, :8] = 0.0  # uniform predictions
    return lg


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("name", ["predictive_entropy", "expected_entropy", "bald"])
@pytest.mark.parametrize("base2", [True, False])
def test_entropies(name, base2, seed):
    lg = mc_logits(seed)
    close(getattr(pmc, name)(torch.from_numpy(lg), base2),
          getattr(jmc, name)(jnp.asarray(lg), base2))


@pytest.mark.parametrize("seed", range(5))
def test_variance_jsd_and_layer_uncertainty(seed):
    lg = mc_logits(seed)
    t, j = torch.from_numpy(lg), jnp.asarray(lg)
    close(pmc.mc_variance(t), jmc.mc_variance(j))
    close(pmc.jensen_shannon(t), jmc.jensen_shannon(j))
    feats = np.random.default_rng(seed).normal(size=(5, 16, 32)).astype(np.float32)
    if seed >= 2:
        feats[2:] = feats[0]
    close(pmc.layer_uncertainty(torch.from_numpy(feats)),
          jmc.layer_uncertainty(jnp.asarray(feats)))


def _resnet8(rate, seed=3):
    variables, port = carried(
        lambda: pm.CifarResNet((1, 1, 1), dropout_rate=rate, device="cpu"), seed)
    return jm.CifarResNet((1, 1, 1), dropout_rate=rate), variables, port


def test_mc_dropout_at_rate_zero_is_jax(rng):
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    jmodel, variables, port = _resnet8(0.0)
    with torch.no_grad():
        got = pmc.mc_sample_logits(pmc.dropout_fn(port), nchw(x), torch.Generator(), 3)
    fn = jmc.dropout_fn(lambda v, xb, rngs: jmodel.apply(v, xb, mc=True, rngs=rngs), variables)
    want = jax.jit(lambda xb: jmc.mc_sample_logits(fn, xb, jax.random.key(0), 3))(
        jnp.asarray(x))
    assert tuple(got.shape) == (3, 4, 10)
    close(got.numpy(), want, rtol=1e-3, atol=2e-4)  # the models' forward budget


def test_mc_dropout_replays_from_the_generator(rng):
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    _, _, port = _resnet8(0.5)
    fn = pmc.dropout_fn(port)
    with torch.no_grad():
        a = pmc.mc_sample_logits(fn, nchw(x), torch.Generator().manual_seed(7), 4)
        b = pmc.mc_sample_logits(fn, nchw(x), torch.Generator().manual_seed(7), 4)
    assert torch.equal(a, b)
    assert not torch.equal(a[0], a[1])
    assert float(torch.min(pmc.bald(a))) >= -1e-6


def test_ensemble_logits(rng):
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    jmodel = jm.SimpleCNN(num_classes=5)
    members, ports = zip(*(carried(lambda: pm.SimpleCNN(num_classes=5, device="cpu"), s)
                           for s in (0, 1, 2)))
    with torch.no_grad():
        got = pmc.ensemble_logits(ports, nchw(x))
    want = jax.jit(lambda xb: jmc.ensemble_logits(lambda v, b: jmodel.apply(v, b), members,
                                                  xb))(jnp.asarray(x))
    assert tuple(got.shape) == (3, 4, 5)
    close(got.numpy(), want, rtol=1e-3, atol=2e-4)
    close(pmc.mc_variance(got), jmc.mc_variance(jnp.asarray(got.numpy())))
