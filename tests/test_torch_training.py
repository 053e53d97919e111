"""One training step of the port against the JAX package's (CPU).

Weights made in flax and carried across with ``from_flax``; the same numpy
batch through ``make_train_step`` (Adam) and through JAX's loss in training
mode. Budgets: gradients rtol 1e-3 / atol 1e-5, the BatchNorm running mean
and variance after the step rtol 1e-5 (flax's biased-variance rule), the
loss rtol 1e-5; ``make_elbo_step``'s CE and KL rtol 1e-5.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from imagetransformations_tpu import models as jm
from imagetransformations_tpu.models import bayesian as jb
from imagetransformations_tpu_torch import models as pm
from imagetransformations_tpu_torch.models import training as pt
from imagetransformations_tpu_torch.models.convert import _entries

from test_torch_models import _torch_threads, flax_variables, nchw  # noqa: F401


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return np.asarray(tree)


@pytest.mark.parametrize("arch", ["resnet8", "simple_cnn"])
def test_train_step_against_jax(arch, rng):
    x = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, 8).astype(np.int32)
    jmodel, port = {"resnet8": (jm.CifarResNet((1, 1, 1)),
                                pm.CifarResNet((1, 1, 1), device="cpu")),
                    "simple_cnn": (jm.SimpleCNN(), pm.SimpleCNN(device="cpu"))}[arch]
    variables = flax_variables(jmodel, x, 6)
    pm.from_flax(port, variables)
    step = pt.make_train_step(port, torch.optim.Adam(port.parameters(), lr=1e-3))
    loss, acc = step(nchw(x), torch.from_numpy(y))

    def loss_fn(p):
        logits, upd = jmodel.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                   jnp.asarray(x), True, mutable=["batch_stats"])
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).mean()
        return ce, (upd["batch_stats"], logits)

    (jloss, (jstats, jlogits)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        variables["params"])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert float(acc) == float(np.mean(np.argmax(np.asarray(jlogits), -1) == y))
    named = dict(port.named_parameters())
    state = port.state_dict()
    for key, coll, path, to_flax_fn, _ in _entries(port):
        if coll == "params":
            got = to_flax_fn(named[key].grad.numpy())
            np.testing.assert_allclose(got, _leaf(grads, path[:-1] + (path[-1],)), rtol=1e-3,
                                       atol=1e-5, err_msg=key)
        else:
            np.testing.assert_allclose(state[key].numpy(), _leaf(jstats, path), rtol=1e-5,
                                       atol=1e-7, err_msg=key)


def test_batchnorm_running_variance_is_biased():
    """flax's rule: the running variance moves toward the biased batch
    variance (torch's own BatchNorm2d uses the unbiased one)."""
    from imagetransformations_tpu_torch.models._layers import BatchNorm

    x = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 2, 3, 3)).astype(np.float32))
    bn = BatchNorm(2, device="cpu")
    bn(x, train=True)
    biased = x.var(dim=(0, 2, 3), unbiased=False)
    np.testing.assert_allclose(bn.running_var.numpy(), (0.9 + 0.1 * biased).numpy(), rtol=1e-6)
    np.testing.assert_allclose(bn.running_mean.numpy(), (0.1 * x.mean(dim=(0, 2, 3))).numpy(),
                               rtol=1e-6, atol=1e-8)
    assert int(bn.num_batches_tracked) == 1


def test_elbo_step_against_jax(rng):
    """rho = -30 in both: each weight is its mean to f32 rounding, so the CE
    does not depend on the draws, and the KL is finite."""
    x = rng.standard_normal((4, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, 4).astype(np.int32)
    jmodel = jm.BayesianCNN()
    variables = flax_variables(jmodel, x, 8)

    def set_rho(tree):
        return {k: set_rho(v) if isinstance(v, dict) else (
            np.full_like(v, -30.0) if k in ("rho", "bias_rho") else v) for k, v in tree.items()}

    variables["params"] = set_rho(variables["params"])
    port = pm.from_flax(pm.BayesianCNN(device="cpu"), variables)
    step = pt.make_elbo_step(port, torch.optim.Adam(port.parameters(), lr=1e-3), 1e-3)
    ce, kl = step(nchw(x), torch.from_numpy(y), torch.Generator().manual_seed(0))
    logits, aux = jmodel.apply(variables, jnp.asarray(x), True, rngs={"sample": jax.random.key(1)},
                               mutable=["losses", "batch_stats"])
    jce = optax.softmax_cross_entropy_with_integer_labels(logits, jnp.asarray(y)).sum()
    np.testing.assert_allclose(float(ce), float(jce), rtol=1e-5)
    np.testing.assert_allclose(float(kl), float(jb.kl_loss(aux)), rtol=1e-5)


def test_fit_and_train_members(rng):
    x = torch.from_numpy(rng.standard_normal((8, 3, 32, 32)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 10, 8))

    def data():
        return [(x[:4], y[:4]), (x[4:], y[4:])]

    members = pt.train_members(lambda: pm.SimpleCNN(device="cpu"), 2, data, epochs=1, seed=3)
    again = pt.train_members(lambda: pm.SimpleCNN(device="cpu"), 2, data, epochs=1, seed=3)
    a, b = members[0].state_dict(), members[1].state_dict()
    assert not torch.equal(a["conv1.weight"], b["conv1.weight"])
    for m, n in zip(members, again):
        for k, v in m.state_dict().items():
            assert torch.equal(v, n.state_dict()[k]), k
    model, state = pt.swag_collect(members[0], data(), max_rank=2)
    assert model is members[0] and state.n_models == 2
