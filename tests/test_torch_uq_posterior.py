"""The port's posteriors against the JAX package's (CPU): SWAG, SGLD, the
last-layer Laplace approximation and deep k-NN.

Weights are carried from the same flax tree (``test_torch_uq_mc.carried``:
SimpleCNN and a CIFAR ResNet of depth 8) and the JAX functions' random
draws are made in the test exactly as the JAX functions make them, mapped
to the port's parameter names and layouts through ``from_flax``'s own map
(``convert._entries``), and passed to the port explicitly. Budgets: SWAG's
moments, ring and samples, SGLD's parameters, Laplace's variances and
probabilities, kNN's entropies rtol 1e-5 (atol 1e-6, or 1e-7 where the
values are that small); labels and neighbour sets equal; the BMA logits
and the refreshed BatchNorm statistics are model forwards, held to the
models' budget (atol 2e-4, rtol 1e-3; tests/test_torch_models.py).
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
import optax

from imagetransformations_tpu import models as jm
from imagetransformations_tpu.uq import knn as jknn
from imagetransformations_tpu.uq import laplace as jlap
from imagetransformations_tpu.uq import sgld as jsgld
from imagetransformations_tpu.uq import swag as jswag
from imagetransformations_tpu_torch import models as pm
from imagetransformations_tpu_torch.models.convert import _entries
from imagetransformations_tpu_torch.uq import knn as pknn
from imagetransformations_tpu_torch.uq import laplace as plap
from imagetransformations_tpu_torch.uq import sgld as psgld
from imagetransformations_tpu_torch.uq import swag as pswag

from test_torch_models import _torch_threads, nchw  # noqa: F401
from test_torch_uq_mc import carried

ARCHS = {"simple_cnn": (lambda: pm.SimpleCNN(num_classes=4, device="cpu"),
                        lambda: jm.SimpleCNN(num_classes=4)),
         "resnet8": (lambda: pm.CifarResNet((1, 1, 1), num_classes=4, device="cpu"),
                     lambda: jm.CifarResNet((1, 1, 1), num_classes=4))}


def close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=msg)


def _leaf(tree, path):
    for p in path:
        tree = tree[p]
    return tree


def param_map(port):
    """[(port name, flax path, torch -> flax, flax -> torch)] of the
    trainable parameters (flax's ``params``)."""
    return [(k, path, tf, tt) for k, coll, path, tf, tt in _entries(port) if coll == "params"]


def to_port(port, flax_params, lead=0):
    """A flax params tree as a port-named dict of tensors (``lead`` leading
    sample / ring axes kept)."""
    out = {}
    for k, path, _, tt in param_map(port):
        v = np.asarray(_leaf(flax_params, path))
        if lead:
            v = np.stack([tt(u) for u in v.reshape(-1, *v.shape[lead:])]).reshape(
                *v.shape[:lead], *tt(v.reshape(-1, *v.shape[lead:])[0]).shape)
        else:
            v = tt(v)
        out[k] = torch.from_numpy(np.array(v, np.float32))
    return out


def _jax_normals(key, shapes, max_rank):
    k1, k2 = jax.random.split(key)
    keys = jax.random.split(k1, len(shapes))
    return [jax.random.normal(k, s) for k, s in zip(keys, shapes)], jax.random.normal(
        k2, (max_rank,))


_jax_normals_jit = jax.jit(_jax_normals, static_argnums=(1, 2))


def jax_sample_draws(port, flax_params, key, max_rank):
    """swag._sample_impl's normals for ``key`` (k1, k2 = split(key); one key
    a leaf from split(k1, leaves) in tree order; z2 = normal(k2, (K,))) in
    ``pswag.draw``'s form."""
    flat = jax.tree_util.tree_flatten_with_path(flax_params)[0]
    paths = [tuple(p.key for p in path) for path, _ in flat]
    zs, z2 = _jax_normals_jit(key, tuple(tuple(np.shape(v)) for _, v in flat), max_rank)
    z = {path: np.asarray(v) for path, v in zip(paths, zs)}
    z_diag = {k: torch.from_numpy(np.array(tt(z[path]), np.float32))
              for k, path, _, tt in param_map(port)}
    return {"z_low": torch.from_numpy(np.array(z2)), "z_diag": z_diag}


def perturbed(params, rng, scale=0.01):
    return jax.tree_util.tree_map(
        lambda v: (np.asarray(v) + scale * rng.standard_normal(np.shape(v))).astype(np.float32),
        params)


@pytest.fixture(scope="module")
def swag_pair():
    """(port SimpleCNN, flax SimpleCNN, variables, the JAX state and the
    port's after init + 5 updates at max_rank 3: the ring wraps). SimpleCNN:
    its fc1 rows are permuted between the layouts, so the draws' map is
    tested where it is least trivial."""
    make_port, make_jax = ARCHS["simple_cnn"]
    variables, port = carried(make_port, 11)
    rng = np.random.default_rng(0)
    jstate = jswag.init(variables["params"], max_rank=3)
    pstate = pswag.init(port, max_rank=3)
    for _ in range(5):  # eager, as swag.update is (under jit XLA contracts FMAs)
        p = perturbed(variables["params"], rng)
        jstate = jswag.update(jstate, p)
        pswag.update(pstate, to_port(port, p))
    return port, make_jax(), variables, jstate, pstate


def test_swag_init_and_update(swag_pair):
    port, _, variables, jstate, pstate = swag_pair
    assert pstate.n_models == int(jstate.n_models) == 5 and pstate.max_rank == 3
    fresh = pswag.init(port, 3)
    for k, path, _, tt in param_map(port):
        close(fresh.mean[k], tt(np.asarray(_leaf(variables["params"], path))), msg=k)
        assert float(fresh.deviations[k].abs().max()) == 0.0
    for name in ("mean", "sq_mean"):
        want = to_port(port, getattr(jstate, name))
        for k in want:
            close(getattr(pstate, name)[k], want[k], msg=f"{name} {k}")
    want = to_port(port, jstate.deviations, lead=1)
    for k in want:
        close(pstate.deviations[k], want[k], atol=1e-7, msg=f"deviations {k}")


@pytest.mark.parametrize("scales", [(None, 1.0, True), (None, 1.0, False), (0.5, 0.3, True)],
                         ids=["reference", "diagonal", "tempered"])
def test_swag_sample_and_sample_many(swag_pair, scales):
    port, _, _, jstate, pstate = swag_pair
    diag, low, use_low = scales
    key = jax.random.key(4)
    draws = jax_sample_draws(port, jstate.mean, key, 3)
    got = pswag.sample(pstate, diag_scale=diag, lowrank_scale=low, use_lowrank=use_low,
                       draws=draws)
    want = to_port(port, jswag.sample(jstate, key, diag, low, use_low))
    for k in want:
        close(got[k], want[k], msg=k)
    keys = jax.random.split(key, 3)
    many = pswag.sample_many(pstate, 3, diag_scale=diag, lowrank_scale=low,
                             use_lowrank=use_low,
                             draws=[jax_sample_draws(port, jstate.mean, kk, 3) for kk in keys])
    want = to_port(port, jswag.sample_many(jstate, key, 3, diag, low, use_low), lead=1)
    for k in want:
        close(many[k], want[k], msg=k)


def test_swag_unfilled_ring_is_masked():
    """Two updates at max_rank 4: slots 2 and 3 are empty, so their normals
    must not move the sample, and the denominator is sqrt(2 (2 - 1))."""
    params = {"w": torch.tensor([1.0, 2.0])}
    st = pswag.init(params, max_rank=4)
    pswag.update(st, {"w": torch.tensor([1.5, 2.0])})
    pswag.update(st, {"w": torch.tensor([0.5, 2.0])})
    st.deviations["w"][2:] = 1e6  # garbage the mask must hide
    zero = {"w": torch.zeros(2)}
    s = pswag.sample(st, draws={"z_low": torch.tensor([1.0, 1.0, 5.0, 5.0]), "z_diag": zero})
    dev = st.deviations["w"][0] + st.deviations["w"][1]
    close(s["w"], st.mean["w"] + dev / np.sqrt(2.0))


def test_swag_generator_draws_replay(swag_pair):
    _, _, _, _, pstate = swag_pair
    a = pswag.sample_many(pstate, 2, torch.Generator().manual_seed(3))
    b = pswag.sample_many(pstate, 2, torch.Generator().manual_seed(3))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k][0], a[k][1]) for k in a)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_swag_refresh_batch_stats_and_bma(arch, rng):
    """Two weight samples (the carried weights perturbed with numpy): their
    BatchNorm statistics refreshed over three batches, then the BMA
    logits."""
    make_port, make_jax = ARCHS[arch]
    variables, port = carried(make_port, 5)
    jmodel = make_jax()
    x = rng.standard_normal((3, 4, 32, 32, 3)).astype(np.float32)
    samples = [perturbed(variables["params"], rng) for _ in range(2)]
    jst = jax.tree_util.tree_map(lambda *v: np.stack(v), *samples)
    pst = to_port(port, jst, lead=1)
    stats = jswag.refresh_batch_stats(
        jax.jit(lambda v, xb: jmodel.apply(v, xb, True, mutable=["batch_stats"])), samples[0],
        variables["batch_stats"], jnp.asarray(x))
    before = {k: v.clone() for k, v in port.state_dict().items()}
    pstats = pswag.refresh_batch_stats(port, {k: v[0] for k, v in pst.items()},
                                       pswag.batch_stats(port), [nchw(b) for b in x])
    assert all(torch.equal(before[k], v) for k, v in port.state_dict().items())
    for k, coll, path, _, tt in _entries(port):
        if coll == "batch_stats":
            close(pstats[k], tt(np.asarray(_leaf(stats, path))), rtol=1e-3, atol=2e-4, msg=k)
    want = jswag.bma_logits(
        jax.jit(lambda p, xb: jmodel.apply({"params": p, "batch_stats": stats}, xb)),
        jst, jnp.asarray(x[0]))
    got = pswag.bma_logits(port, pst, nchw(x[0]), pstats)
    assert tuple(got.shape) == (2, 4, 4)
    close(got, want, rtol=1e-3, atol=2e-4)
    # the model's own statistics by default
    own = pswag.bma_logits(port, pst, nchw(x[0]))
    with torch.no_grad():
        first = torch.func.functional_call(port, {k: v[0] for k, v in pst.items()},
                                           (nchw(x[0]),))
    assert torch.equal(own[0], first)


class _Linear(nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.w = nn.Parameter(torch.from_numpy(w.copy()))
        self.b = nn.Parameter(torch.from_numpy(b.copy()))

    def forward(self, x):
        return x @ self.w + self.b


def test_sgld_steps_with_explicit_noise(rng):
    x = rng.standard_normal((6, 12)).astype(np.float32)
    y = rng.integers(0, 4, 6).astype(np.int32)
    w0 = (rng.standard_normal((12, 4)) * 0.1).astype(np.float32)
    b0 = np.zeros(4, np.float32)
    lr, temp = 1e-2, 0.5
    tx = jsgld.sgld(lr, temp, seed=3)
    params = {"w": jnp.asarray(w0), "b": jnp.asarray(b0)}
    state = tx.init(params)
    model = _Linear(w0, b0)
    opt = psgld.SGLD(model.parameters(), lr, temp)
    key = jax.random.key(3)
    grad = jax.jit(jax.grad(lambda p: optax.softmax_cross_entropy_with_integer_labels(
        jnp.asarray(x) @ p["w"] + p["b"], jnp.asarray(y)).mean()))
    update = jax.jit(tx.update)
    snaps, jsnaps = [], []
    for _ in range(3):
        key, sub = jax.random.split(key)
        kb, kw = jax.random.split(sub, 2)  # tree order: "b", then "w"
        noise = [torch.from_numpy(np.array(jax.random.normal(kw, (12, 4)))),
                 torch.from_numpy(np.array(jax.random.normal(kb, (4,))))]
        updates, state = update(grad(params), state, params)
        params = optax.apply_updates(params, updates)
        opt.zero_grad()
        torch.nn.functional.cross_entropy(model(torch.from_numpy(x)),
                                          torch.from_numpy(y).long()).backward()
        opt.step(noise=noise)
        close(model.w.detach(), params["w"])
        close(model.b.detach(), params["b"])
        snaps.append({k: v.detach().clone() for k, v in model.named_parameters()})
        jsnaps.append(params)
    stacked = psgld.stack_snapshots(snaps)
    got = psgld.predictive_logits(model, stacked, torch.from_numpy(x))
    want = jsgld.predictive_logits(lambda p, xb: xb @ p["w"] + p["b"],
                                   jsgld.stack_snapshots(jsnaps), jnp.asarray(x))
    assert tuple(got.shape) == (3, 6, 4)
    close(got, want)


def test_sgld_generator_noise():
    p = nn.Parameter(torch.zeros(5))
    p.grad = torch.zeros(5)
    psgld.SGLD([p], lr=0.5, temperature=2.0, generator=torch.Generator().manual_seed(1)).step()
    z = torch.randn(5, generator=torch.Generator().manual_seed(1))
    close(p.detach(), np.sqrt(np.float32(2.0)) * z)  # sqrt(2 lr T) = sqrt(2)


def _head(rng, n=300, d=16, c=5):
    f = rng.standard_normal((n, d)).astype(np.float32)
    w = (rng.standard_normal((d, c)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return f, w, b


@pytest.mark.parametrize("prior", [1.0, 0.1])
def test_laplace(prior, rng):
    f, w, b = _head(rng)
    q = rng.standard_normal((40, 16)).astype(np.float32)
    js = jlap.LaplaceState(*jax.jit(lambda *a: dataclasses.astuple(jlap.fit(*a, prior)))(
        jnp.asarray(f), jnp.asarray(w), jnp.asarray(b)))
    ps = plap.fit(torch.from_numpy(f), torch.from_numpy(w), torch.from_numpy(b), prior)
    close(ps.w_var, js.w_var)
    close(ps.b_var, js.b_var)
    key = jax.random.key(2)
    parts = [jax.random.split(k) for k in jax.random.split(key, 7)]
    zw = np.stack([np.asarray(jax.random.normal(kw, w.shape)) for kw, _ in parts])
    zb = np.stack([np.asarray(jax.random.normal(kb, b.shape)) for _, kb in parts])
    mean_p, var = plap.predictive(ps, torch.from_numpy(q),
                                  draws=(torch.from_numpy(zw), torch.from_numpy(zb)))
    jmean, jvar = jax.jit(lambda st, qq: jlap.predictive(jlap.LaplaceState(*st), qq, key, 7))(
        dataclasses.astuple(js), jnp.asarray(q))
    close(mean_p, jmean)
    close(var, jvar, atol=1e-7)
    close(plap.closed_form_variance(ps, torch.from_numpy(q)),
          jlap.closed_form_variance(js, jnp.asarray(q)))
    g1 = plap.predictive(ps, torch.from_numpy(q), torch.Generator().manual_seed(0), 4)
    g2 = plap.predictive(ps, torch.from_numpy(q), torch.Generator().manual_seed(0), 4)
    assert torch.equal(g1[1], g2[1]) and tuple(g1[0].shape) == (40, 5)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
@pytest.mark.parametrize("base2", [True, False])
@pytest.mark.parametrize("k", [1, 10])
def test_knn_label_entropy(metric, base2, k, rng):
    tr = rng.standard_normal((500, 16)).astype(np.float32)
    lab = rng.integers(0, 10, 500).astype(np.int32)
    q = rng.standard_normal((64, 16)).astype(np.float32)
    ent, maj = pknn.knn_label_entropy(torch.from_numpy(tr), torch.from_numpy(lab),
                                      torch.from_numpy(q), k, 10, metric, base2)
    jent, jmaj = jknn.knn_label_entropy(jnp.asarray(tr), jnp.asarray(lab), jnp.asarray(q),
                                        k, 10, metric, base2)
    assert ent.dtype == torch.float32
    close(ent, jent)
    np.testing.assert_array_equal(maj.numpy(), np.asarray(jmaj))


def test_nearest_feature_distance(rng):
    tr = rng.standard_normal((500, 16)).astype(np.float32)
    lab = rng.integers(0, 10, 500).astype(np.int32)
    q = rng.standard_normal((64, 16)).astype(np.float32)
    q[:4] = tr[[3, 7, 7, 9]]  # distance 0 up to the expansion's rounding
    dist, nl = pknn.nearest_feature_distance(torch.from_numpy(tr), torch.from_numpy(lab),
                                             torch.from_numpy(q))
    jdist, jnl = jknn.nearest_feature_distance(jnp.asarray(tr), jnp.asarray(lab),
                                               jnp.asarray(q))
    close(dist, jdist, atol=1e-5)
    np.testing.assert_array_equal(nl.numpy(), np.asarray(jnl))


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_knn_tie_at_the_kth_place(metric):
    """Two train points equal to the query and four tied at the 3rd place
    (the same unit vector, exact in f32) at indices 7, 3, 9, 5 with labels
    1-4: k = 4 takes the two exact matches and the tied ones of lower index,
    3 and 5, as ``lax.top_k`` does."""
    tr = np.zeros((12, 4), np.float32)
    tr[:, 3] = 1.0  # far: orthogonal to the query
    tr[[0, 10], 0] = 1.0
    tr[[0, 10], 3] = 0.0
    tr[[7, 3, 9, 5]] = 0.5  # cosine 0.5, squared distance 1
    lab = np.zeros(12, np.int32)
    lab[[7, 3, 9, 5]] = [1, 2, 3, 4]
    q = np.array([[1.0, 0.0, 0.0, 0.0]], np.float32)
    idx = pknn.top_k_indices(torch.tensor([[0.0, 2.0, 1.0, 1.0, 1.0, 2.0]]), 3)
    assert sorted(idx[0].tolist()) == [1, 2, 5]
    ent, maj = pknn.knn_label_entropy(torch.from_numpy(tr), torch.from_numpy(lab),
                                      torch.from_numpy(q), 4, 5, metric)
    jent, jmaj = jknn.knn_label_entropy(jnp.asarray(tr), jnp.asarray(lab), jnp.asarray(q), 4,
                                        5, metric)
    # neighbours: 0, 10 (label 0), 3 (label 2), 5 (label 4): counts 2, 1, 1
    close(ent, [1.5])
    close(ent, jent)
    assert int(maj[0]) == int(jmaj[0]) == 0
