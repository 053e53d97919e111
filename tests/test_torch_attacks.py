"""The port's attacks (``attacks.fgsm``, ``attacks.pgd``) against the JAX
package's (CPU).

A CIFAR ResNet of depth 8 and SimpleCNN carried from flax
(``test_torch_uq_mc.carried``), 8 images uniform in [0, 1] from a numpy
seed. Budgets: FGSM, reverse FGSM and PGD (JAX's uniform start passed as
``start=``) equal to JAX's except on <= 0.1% of the values, where the sign
of a gradient near 0 differs between the two (each such value moves by up
to 2 eps, or 2 alpha a PGD step); ``minimal_epsilon`` the same level on all
but 0.1% of the images; ``adversarial_train_step``'s loss rtol 1e-5, its
gradients rtol 1e-3 with atol 2e-3 of each tensor's largest entry (1e-5 at
least) and its BatchNorm statistics atol 1e-5: on inputs in [0, 1] the
training-mode BatchNorm cancels, and against an f64 run of the same step
both sides' conv1 gradients are 1.6-1.9e-3 of the largest entry off, and
JAX's statistics 1.9e-6 (the port's 6e-8); ``denormalize`` /
``renormalize`` rtol 1e-6.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from imagetransformations_tpu import models as jm
from imagetransformations_tpu.attacks import fgsm as jf
from imagetransformations_tpu.attacks import pgd as jp
from imagetransformations_tpu_torch import attacks as pa
from imagetransformations_tpu_torch import models as pm
from imagetransformations_tpu_torch.models.convert import _entries

from test_torch_models import _torch_threads, nchw  # noqa: F401
from test_torch_uq_mc import carried
from test_torch_uq_posterior import _leaf

ARCHS = {"resnet8": (lambda: pm.CifarResNet((1, 1, 1), device="cpu"),
                     lambda: jm.CifarResNet((1, 1, 1))),
         "simple_cnn": (lambda: pm.SimpleCNN(device="cpu"), lambda: jm.SimpleCNN())}
SHARE = 1e-3  # values (or images) allowed to differ by a gradient sign near 0


@pytest.fixture(scope="module", params=list(ARCHS))
def pair(request):
    make_port, make_jax = ARCHS[request.param]
    variables, port = carried(make_port, 21)
    jmodel = make_jax()
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (8, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, 8).astype(np.int32)
    return port, jax.jit(lambda xb: jmodel.apply(variables, xb)), x, y, variables, jmodel


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def assert_mostly_equal(got, want, step):
    """Equal but on <= SHARE of the values, and there within 2 * step."""
    got, want = np.asarray(got), np.asarray(want)
    differ = got != want
    assert differ.mean() <= SHARE, f"{differ.sum()} of {differ.size} values differ"
    assert np.abs(got - want).max() <= 2 * step + 1e-6


@pytest.mark.parametrize("eps", [0.03, 8 / 255])
def test_fgsm_and_reverse_fgsm(pair, eps):
    port, jfn, x, y, _, _ = pair
    adv = pa.fgsm_attack(port, nchw(x), torch.from_numpy(y), eps)
    assert_mostly_equal(nhwc(adv), jf.fgsm_attack(jfn, jnp.asarray(x), jnp.asarray(y), eps), eps)
    with torch.no_grad():
        pseudo = torch.argmax(port(adv), -1)  # never this: the adversarial prediction
        clean = torch.argmax(port(nchw(x)), -1)
    rev = pa.reverse_fgsm(port, adv, clean, eps)
    want = jf.reverse_fgsm(jfn, jnp.asarray(nhwc(adv)), jnp.asarray(clean.numpy()), eps)
    assert_mostly_equal(nhwc(rev), want, eps)
    assert not torch.equal(rev, pa.reverse_fgsm(port, adv, pseudo, eps)) or torch.equal(
        pseudo, clean)


def test_fgsm_clip_range(pair):
    port, jfn, x, y, _, _ = pair
    xs = 2.0 * x - 1.0
    got = pa.fgsm_attack(port, nchw(xs), torch.from_numpy(y), 0.1, -1.0, 1.0)
    want = jf.fgsm_attack(jfn, jnp.asarray(xs), jnp.asarray(y), 0.1, -1.0, 1.0)
    assert_mostly_equal(nhwc(got), want, 0.1)
    assert float(got.min()) >= -1.0 and float(got.max()) <= 1.0


@pytest.mark.parametrize("random_start", [True, False])
def test_pgd(pair, random_start):
    port, jfn, x, y, _, _ = pair
    key = jax.random.key(6)
    eps, alpha = 0.03, 2 / 255
    want = jp.pgd_attack(jfn, jnp.asarray(x), jnp.asarray(y), key, eps, alpha, 5, random_start)
    start = np.asarray(jax.random.uniform(key, x.shape, minval=-eps, maxval=eps))
    got = pa.pgd_attack(port, nchw(x), torch.from_numpy(y), eps=eps, alpha=alpha, steps=5,
                        random_start=random_start, start=nchw(start))
    assert_mostly_equal(nhwc(got), want, alpha * 5)
    assert float((got - nchw(x)).abs().max()) <= eps + 1e-6


def test_pgd_generator_start(pair):
    port, _, x, y, _, _ = pair
    a = pa.pgd_attack(port, nchw(x), torch.from_numpy(y), torch.Generator().manual_seed(2),
                      steps=1)
    b = pa.pgd_attack(port, nchw(x), torch.from_numpy(y), torch.Generator().manual_seed(2),
                      steps=1)
    assert torch.equal(a, b)


@pytest.mark.parametrize("grid", [None, "explicit"])
def test_minimal_epsilon(pair, grid):
    port, jfn, x, y, _, _ = pair
    with torch.no_grad():
        labels = torch.argmax(port(nchw(x)), -1)  # flips are counted from the prediction
    eps_grid = None if grid is None else np.linspace(0.01, 0.5, 12).astype(np.float32)
    got = pa.minimal_epsilon(port, nchw(x), labels,
                             None if grid is None else torch.from_numpy(eps_grid))
    want = np.asarray(jf.minimal_epsilon(jfn, jnp.asarray(x), jnp.asarray(labels.numpy()),
                                         None if grid is None else jnp.asarray(eps_grid)))
    same = np.isclose(got.numpy(), want, rtol=1e-6) | (np.isinf(got.numpy()) & np.isinf(want))
    assert (~same).mean() <= SHARE
    if grid is not None:
        assert np.isfinite(got.numpy()).any()


def test_minimal_epsilon_first_flip():
    """The first level that flips, and inf where none does."""
    def model_fn(xb):  # class 1 once the mean pixel passes 0.6
        m = xb.mean(dim=(1, 2, 3))
        return torch.stack([0.6 - m, m - 0.6], -1) * 100.0

    x = torch.full((2, 3, 4, 4), 0.5)
    x[1] = 0.0  # the gradient pushes it up too, but the grid never reaches 0.6
    got = pa.minimal_epsilon(model_fn, x, torch.zeros(2, dtype=torch.int64),
                             torch.tensor([0.05, 0.2, 0.3, 0.4]))
    assert got[0] == torch.tensor(0.2) and torch.isinf(got[1])


def test_adversarial_train_step(pair):
    port0, _, x, y, variables, jmodel = pair
    _, port = carried(lambda: type(port0)(*(((1, 1, 1),) if isinstance(port0, pm.CifarResNet)
                                             else ()), device="cpu"), 21)
    # JAX: a transformation that returns the gradients as its state
    keep = optax.GradientTransformation(lambda p: None, lambda g, s, p=None: (
        jax.tree_util.tree_map(jnp.zeros_like, g), g))
    _, jstats, grads, jloss = jf.adversarial_train_step(  # eager, as the JAX package's
        jmodel.apply, variables["params"], variables["batch_stats"], None, keep,
        jnp.asarray(x), jnp.asarray(y))
    opt = torch.optim.SGD(port.parameters(), lr=0.0)
    loss = pa.adversarial_train_step(port, opt, nchw(x), torch.from_numpy(y))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    named, state = dict(port.named_parameters()), port.state_dict()
    for key, coll, path, to_flax, _ in _entries(port):
        if coll == "params":
            want = np.asarray(_leaf(grads, path))
            np.testing.assert_allclose(to_flax(named[key].grad.numpy()), want, rtol=1e-3,
                                       atol=max(1e-5, 2e-3 * np.abs(want).max()), err_msg=key)
        else:
            np.testing.assert_allclose(state[key].numpy(), np.asarray(_leaf(jstats, path)),
                                       rtol=1e-5, atol=1e-5, err_msg=key)


def test_denormalize_renormalize(rng):
    from imagetransformations_tpu_torch.models.resnet import CIFAR_MEAN, CIFAR_STD

    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    d = pa.denormalize(nchw(x), CIFAR_MEAN, CIFAR_STD)
    np.testing.assert_allclose(nhwc(d), jf.denormalize(jnp.asarray(x), CIFAR_MEAN, CIFAR_STD),
                               rtol=1e-6)
    r = pa.renormalize(d, CIFAR_MEAN, CIFAR_STD)
    np.testing.assert_allclose(nhwc(r), jf.renormalize(jnp.asarray(nhwc(d)), CIFAR_MEAN,
                                                       CIFAR_STD), rtol=1e-6, atol=1e-7)
