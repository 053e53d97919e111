"""The port's CIFAR classifiers against the JAX package's (CPU).

Weights are made once in flax (``init`` from a seed, BatchNorm statistics
drawn with numpy so their import is exercised) and carried into the port
with ``models.from_flax``; both forwards then see the same numpy inputs.
Budgets: the repo's torch-against-flax measurements
(tests/test_torch_parity.py: atol 2e-4, rtol 1e-3 at 32x32).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from imagetransformations_tpu import models as jm
from imagetransformations_tpu.models import bayesian as jb
from imagetransformations_tpu_torch import models as pm
from imagetransformations_tpu_torch.models import bayesian as pb
from imagetransformations_tpu_torch.models._layers import dropout
from imagetransformations_tpu_torch.models.convert import _entries

ATOL, RTOL = 2e-4, 1e-3


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    """One PyTorch thread a test process: the suite runs several processes on
    the machine's cores, and PyTorch's CPU convolutions, each spreading over
    every core, then slow one another ~30-fold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flax_variables(model, x, seed, **init_kw):
    """``model.init`` from ``seed``, with BatchNorm statistics drawn from
    numpy (mean ~ N(0, 0.3), var ~ U(0.5, 1.5)); numpy leaves."""
    rngs = {"params": jax.random.key(seed), "sample": jax.random.key(seed + 1),
            "dropout": jax.random.key(seed + 2)}
    variables = jax.tree_util.tree_map(np.asarray, model.init(rngs, jnp.asarray(x), **init_kw))
    variables = {k: v for k, v in variables.items() if k != "losses"}
    rng = np.random.default_rng(seed)

    def stats(tree):
        return {k: stats(v) if isinstance(v, dict) else (
            rng.normal(0, 0.3, v.shape) if k == "mean" else rng.uniform(0.5, 1.5, v.shape)
        ).astype(np.float32) for k, v in tree.items()}

    if "batch_stats" in variables:
        variables["batch_stats"] = stats(variables["batch_stats"])
    return variables


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.fixture
def x32(rng):
    return rng.standard_normal((4, 32, 32, 3)).astype(np.float32)


@pytest.mark.parametrize("blocks", [(1, 1, 1), (3, 3, 3)], ids=["depth8", "resnet20"])
def test_cifar_resnet_logits_and_features(blocks, x32):
    jmodel = jm.CifarResNet(blocks)
    variables = flax_variables(jmodel, x32, 0)
    port = pm.from_flax(pm.CifarResNet(blocks, device="cpu"), variables)
    with torch.no_grad():
        feats, logits = port.features_and_logits(nchw(x32))
        alone = port(nchw(x32))
    jf, jl = jmodel.apply(variables, jnp.asarray(x32), method=jmodel.features_and_logits)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jf), atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(alone.numpy(), logits.numpy())
    assert tuple(port.features(nchw(x32)).shape) == (4, 64)


def test_resnet_factories_and_cifar_model_space(rng):
    for make, blocks in ((pm.resnet56, 27), (pm.resnet20, 9)):
        net = make(device="cpu")
        assert sum(isinstance(m, pm.resnet.BasicBlock) for m in net.modules()) == blocks
    u8 = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    got = pm.resnet.cifar_model_space(torch.from_numpy(u8))
    want = np.asarray(jm.resnet.normalize_cifar(jnp.asarray(u8, jnp.float32) / 255.0))
    np.testing.assert_array_equal(got.numpy(), want.transpose(0, 3, 1, 2))
    assert got.is_contiguous(memory_format=torch.channels_last)


def test_models_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for make in (pm.resnet20, pm.SimpleCNN, pm.BayesianCNN, pm.ResNet18):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_mc_dropout(x32):
    jmodel = jm.resnet20()
    variables = flax_variables(jmodel, x32, 3)
    port = pm.from_flax(pm.resnet20(device="cpu"), variables)
    with torch.no_grad():
        plain = port(nchw(x32), mc=False)
        g = torch.Generator().manual_seed(5)
        a = port(nchw(x32), mc=True, generator=g)
        b = port(nchw(x32), mc=True, generator=torch.Generator().manual_seed(5))
        c = port(nchw(x32), mc=True, generator=g)
    np.testing.assert_allclose(plain.numpy(), np.asarray(jmodel.apply(variables, x32, mc=False)),
                               atol=ATOL, rtol=RTOL)
    assert torch.equal(a, b)  # a fixed generator repeats
    assert not torch.equal(a, c) and not torch.equal(a, plain)
    with pytest.raises(ValueError, match="generator"):
        port(nchw(x32), mc=True)
    # flax's rule: keep with probability 0.5, the kept values doubled
    ones = torch.ones(20000)
    out = dropout(ones, 0.5, torch.Generator().manual_seed(0))
    share = float((out == 0).double().mean())
    assert abs(share - 0.5) <= 0.02
    assert set(out.unique().tolist()) == {0.0, 2.0}


def test_simple_cnn(x32):
    jmodel = jm.SimpleCNN()
    variables = flax_variables(jmodel, x32, 1)
    port = pm.from_flax(pm.SimpleCNN(device="cpu"), variables)
    with torch.no_grad():
        got = port(nchw(x32)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel.apply(variables, x32)), atol=ATOL,
                               rtol=RTOL)


def _bayesian_pair(x, rho):
    jmodel = jm.BayesianCNN()
    variables = flax_variables(jmodel, x, 2)

    def set_rho(tree):
        return {k: set_rho(v) if isinstance(v, dict) else (
            np.full_like(v, rho) if k in ("rho", "bias_rho") and rho is not None else v)
            for k, v in tree.items()}

    variables["params"] = set_rho(variables["params"])
    return jmodel, variables, pm.from_flax(pm.BayesianCNN(device="cpu"), variables)


def test_bayesian_cnn_at_its_means(x32):
    """rho = -100 in both: each sampled weight equals its mean."""
    jmodel, variables, port = _bayesian_pair(x32, -100.0)
    with torch.no_grad():
        got = port(nchw(x32), generator=torch.Generator().manual_seed(0)).numpy()
    want, _ = jmodel.apply(variables, x32, rngs={"sample": jax.random.key(9)},
                           mutable=["losses"])
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)


def test_bayesian_kl_and_predictive_samples(x32):
    jmodel, variables, port = _bayesian_pair(x32, None)  # the init rho, -3
    _, aux = jmodel.apply(variables, x32, rngs={"sample": jax.random.key(0)},
                          mutable=["losses"])
    assert float(pb.kl_loss(port)) == 0.0  # no forward yet
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        samples = pb.predictive_samples(port, nchw(x32), g, num_samples=3)
    np.testing.assert_allclose(float(pb.kl_loss(port)), float(jb.kl_loss(aux)), rtol=1e-5)
    assert tuple(samples.shape) == (3, 4, 10) and bool(torch.isfinite(samples).all())
    assert not torch.equal(samples[0], samples[1])
    with torch.no_grad():
        again = pb.predictive_samples(port, nchw(x32), torch.Generator().manual_seed(1), 3)
    assert torch.equal(samples, again)


def _to_flax(model):
    """The port module's parameters as the JAX model's ``{"params",
    "batch_stats"}`` tree of numpy arrays (``from_flax``'s inverse, for the
    architectures the JAX package has no state_dict importer for)."""
    state = model.state_dict()
    out = {"params": {}, "batch_stats": {}}
    for key, coll, path, to_flax_fn, _ in _entries(model):
        node = out[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(to_flax_fn(state[key].detach().cpu().numpy()))
    if not out["batch_stats"]:
        del out["batch_stats"]
    return out


@pytest.mark.parametrize("arch", ["resnet20", "simple_cnn", "bayesian_cnn"])
def test_from_flax_round_trip(arch, x32):
    """from_flax's name map gives the JAX model's own tree (paths and
    shapes), and from_flax of that tree returns the same tensors."""
    jmodel, port = {
        "resnet20": (jm.resnet20(), pm.resnet20(device="cpu")),
        "simple_cnn": (jm.SimpleCNN(), pm.SimpleCNN(device="cpu")),
        "bayesian_cnn": (jm.BayesianCNN(), pm.BayesianCNN(device="cpu")),
    }[arch]
    shapes = jax.tree_util.tree_map(np.shape, flax_variables(jmodel, x32, 4))
    tree = _to_flax(port)
    assert jax.tree_util.tree_map(np.shape, tree) == shapes
    back = pm.from_flax(type(port)(device="cpu") if arch != "resnet20"
                        else pm.resnet20(device="cpu"), tree)
    for (k, a), (k2, b) in zip(port.state_dict().items(), back.state_dict().items()):
        assert k == k2
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(a, b), k


def test_resnet20_state_dict_through_the_jax_importer(x32):
    """A torch state_dict -> the JAX importer -> from_flax returns the same
    tensors, and the port's names load as a chenyaofo checkpoint's."""
    torch.manual_seed(0)
    port = pm.resnet20(device="cpu")
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    back = pm.from_flax(pm.resnet20(device="cpu"), jm.resnet.load_torch_state_dict(state))
    for k, v in port.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, back.state_dict()[k]), k
    other = pm.load_torch_state_dict(pm.resnet20(device="cpu"), state)
    assert all(torch.equal(v, other.state_dict()[k]) for k, v in port.state_dict().items())
    with pytest.raises(ValueError, match="shape"):
        pm.from_flax(pm.resnet20(100, device="cpu"), jm.resnet.load_torch_state_dict(state))
    with pytest.raises(KeyError):
        pm.from_flax(pm.resnet56(device="cpu"), jm.resnet.load_torch_state_dict(state))


def test_init_like_flax():
    """flax's defaults: lecun_normal kernels (variance 1 / fan_in, cut at two
    deviations), zero biases; BatchNorm scale 1, bias 0."""
    torch.manual_seed(0)
    net = pm.SimpleCNN(device="cpu")
    for layer, fan_in in ((net.conv2, 64 * 25), (net.fc1, 3200)):
        w = layer.weight.detach()
        std = (1.0 / fan_in) ** 0.5
        assert abs(float(w.std()) / std - 1.0) < 0.02
        assert float(w.abs().max()) <= 2.0 * std / 0.87962566103423978 + 1e-7
        assert not layer.bias.any()
    assert bool((net.bn1.weight == 1).all()) and not net.bn1.bias.any()
