"""The port's TENT (``adapt.tent``) and ``workflows.tent_sweep`` against the
JAX package's (CPU).

A tiny conv -> BatchNorm -> ReLU -> pool -> dense net on both sides (the
port's module and a jnp apply with flax's BatchNorm rule, the same
weights), on 32x32 images: the same batches and labels, the same explicit
corruption draws. Budgets:

- optax's ``clip_by_global_norm``: the port's rule within rtol 1e-6 (the
  norm's summation order), and the gradients kept bit for bit below the
  norm; ``adam_update`` within rtol 1e-5 of ``optax.adam`` over 20 steps;
- a TENT step: logits within atol 5e-5 (measured 1.9e-5: flax's one-pass
  BatchNorm variance cancels where the port takes two passes), the
  BatchNorm parameters after 10 steps within atol 1e-6 of JAX's (measured
  1.5e-7 at lr 1e-2);
- ``evaluate_with_tent`` (continuous, reset, conditional, each with a
  ragged tail) and ``tent_sweep``: accuracies equal. The conditional gate
  is held only on images whose entropy lies at least 1e-4 from the
  threshold (the port sums the entropy in f64, JAX in f32): checked;
- the module's parameters and buffers bit-equal before and after.

The BatchNorm set on ResNet-20, ResNet-18 and VGG-19-BN equals JAX's
("bn" in the flax path, tent.py:34-36), mapped through ``from_flax``'s map.
"""

import numpy as np
import optax
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
from jax import lax

from imagetransformations_tpu import workflows as jw
from imagetransformations_tpu.adapt import tent as jt
from imagetransformations_tpu.ops.histogram import image_entropy as j_entropy
from imagetransformations_tpu_torch import models as pm
from imagetransformations_tpu_torch import workflows as pw
from imagetransformations_tpu_torch.adapt import _optim
from imagetransformations_tpu_torch.adapt import tent as pt
from imagetransformations_tpu_torch.evalx.harness import corrupt, numpy_draws
from imagetransformations_tpu_torch.models._layers import BatchNorm
from imagetransformations_tpu_torch.models.convert import _entries
from imagetransformations_tpu_torch.ops.histogram import image_entropy

from test_torch_models import _torch_threads, nchw  # noqa: F401

THR = 1.16
GATE_MARGIN = 1e-4


class Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 6, 3, padding=1, bias=False)
        self.bn = BatchNorm(6, "cpu")
        self.fc = nn.Linear(6, 10)

    def forward(self, x, train: bool = False):
        return self.fc(torch.relu(self.bn(self.conv(x), train)).mean((2, 3)))


def tiny(seed=0):
    """(port module, flax-style params, jnp batch-statistics apply), the
    same weights (numpy draws) on both sides."""
    rng = np.random.default_rng(seed)
    k = rng.normal(0, 0.3, (3, 3, 3, 6)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    bias = rng.normal(0, 0.1, 6).astype(np.float32)
    w = rng.normal(0, 0.5, (6, 10)).astype(np.float32)
    b = rng.normal(0, 0.1, 10).astype(np.float32)
    port = Tiny()
    with torch.no_grad():
        port.conv.weight.copy_(torch.from_numpy(k.transpose(3, 2, 0, 1).copy()))
        port.bn.weight.copy_(torch.from_numpy(scale))
        port.bn.bias.copy_(torch.from_numpy(bias))
        port.fc.weight.copy_(torch.from_numpy(w.T.copy()))
        port.fc.bias.copy_(torch.from_numpy(b))
        port.bn.running_mean.copy_(torch.from_numpy(rng.normal(0, 0.3, 6).astype(np.float32)))
        port.bn.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32)))
    params = {"conv": {"kernel": jnp.asarray(k)}, "bn": {"scale": jnp.asarray(scale),
                                                         "bias": jnp.asarray(bias)},
              "fc": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}}

    def japply(p, x):  # NHWC, flax's BatchNorm in training mode
        y = lax.conv_general_dilated(x, p["conv"]["kernel"], (1, 1), "SAME",
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"))
        mean = jnp.mean(y, (0, 1, 2))
        var = jnp.maximum(0.0, jnp.mean(y * y, (0, 1, 2)) - mean * mean)
        y = (y - mean) * (lax.rsqrt(var + 1e-5) * p["bn"]["scale"]) + p["bn"]["bias"]
        return jnp.mean(jax.nn.relu(y), (1, 2)) @ p["fc"]["kernel"] + p["fc"]["bias"]

    return port, params, japply


def snapshot(model):
    return {k: v.detach().clone() for k, v in [*model.named_parameters(),
                                               *model.named_buffers()]}


def assert_unchanged(model, before):
    now = snapshot(model)
    assert sorted(now) == sorted(before)
    for k, v in before.items():
        assert torch.equal(now[k], v), k


def images(seed, n, flat_share=0.0):
    """u8 NHWC 32x32: noise images (entropy ~7.6 bits), the first
    ``flat_share`` of them flat (one value a channel: entropy <= 1.6)."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    k = int(round(flat_share * n))
    x[:k] = rng.integers(0, 256, (k, 1, 1, 3), dtype=np.uint8)
    return x


def assert_gate_margin(raw_u8, thr=THR):
    """Both packages' entropies at least GATE_MARGIN from the threshold, and
    on the same side of it."""
    pe = image_entropy(torch.from_numpy(raw_u8)).numpy()
    je = np.asarray(j_entropy(jnp.asarray(raw_u8)))
    assert np.all(np.abs(pe - thr) >= GATE_MARGIN) and np.all(np.abs(je - thr) >= GATE_MARGIN)
    np.testing.assert_array_equal(pe > thr, je > thr)


def batches_of(x_u8, y, sizes):
    out, lab, i = [], [], 0
    for s in sizes:
        out.append(x_u8[i: i + s])
        lab.append(y[i: i + s])
        i += s
    return out, lab


# ---------------------------------------------------------------- the BN set


def _flax_tree_paths(model):
    """The flax params tree of ``model`` through ``from_flax``'s map, each
    leaf its torch key."""
    tree = {}
    for key, coll, path, _, _ in _entries(model):
        if coll != "params":
            continue
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = key
    return tree


@pytest.mark.parametrize("make", [
    lambda: pm.resnet20(device="cpu"),
    lambda: pm.ResNet18(num_classes=10, device="meta"),
    lambda: pm.VGG19BN(num_classes=10, input_size=32, device="meta"),
], ids=["resnet20", "resnet18", "vgg19_bn"])
def test_bn_set_equals_jax(make):
    """By name and shape only: the ImageNet nets are built on the meta
    device (no storage)."""
    model = make()
    tree = _flax_tree_paths(model)
    bn, frozen = jt.partition_bn_params(tree)
    want = set(jax.tree_util.tree_leaves(bn))
    got = set(pt.bn_parameter_names(model))
    n_bn = sum(2 for m in model.modules() if isinstance(m, BatchNorm))
    assert got == want and len(got) == n_bn > 0
    pbn, pfrozen = pt.partition_bn_params(model)
    assert set(pbn) == got and set(pfrozen) == set(jax.tree_util.tree_leaves(frozen))


# ---------------------------------------------------------------- optax's rules


@pytest.mark.parametrize("scale", [0.01, 0.3, 5.0])
def test_clip_by_global_norm(scale):
    rng = np.random.default_rng(3)
    g = {"a": rng.normal(0, scale, (6,)).astype(np.float32),
         "b": rng.normal(0, scale, (4, 3)).astype(np.float32)}
    want, _ = optax.clip_by_global_norm(1.0).update({k: jnp.asarray(v) for k, v in g.items()},
                                                   optax.EmptyState())
    got = _optim.clip_by_global_norm({k: torch.from_numpy(v) for k, v in g.items()}, 1.0)
    norm = np.sqrt(sum((v.astype(np.float64) ** 2).sum() for v in g.values()))
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=0)
        if norm < 1.0:  # kept as it is
            np.testing.assert_array_equal(got[k].numpy(), g[k])
    # torch's clip_grad_norm_ scales by 1 / (norm + 1e-6): another rule
    if norm >= 1.0:
        ts = [torch.zeros(v.shape, requires_grad=True) for v in g.values()]
        for t, v in zip(ts, g.values()):
            t.grad = torch.from_numpy(v.copy())
        torch.nn.utils.clip_grad_norm_(ts, 1.0)
        assert any(not torch.equal(t.grad, got[k]) for t, k in zip(ts, g))


def test_adam_matches_optax():
    rng = np.random.default_rng(4)
    p = {"w": rng.normal(size=(5, 3)).astype(np.float32)}
    tx = optax.adam(0.05)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    js = tx.init(jp)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    ts = _optim.adam_init(tp)
    for i in range(20):
        g = {"w": rng.normal(0, 10.0 ** (i % 3 - 1), (5, 3)).astype(np.float32)}
        u, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js)
        jp = optax.apply_updates(jp, u)
        tu, ts = _optim.adam_update({k: torch.from_numpy(v) for k, v in g.items()}, ts, 0.05)
        tp = _optim.apply_updates(tp, tu)
    np.testing.assert_allclose(tp["w"].numpy(), np.asarray(jp["w"]), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- one step


def test_tent_step_matches_jax():
    port, params, japply = tiny(0)
    x = images(1, 16).astype(np.float32) / 255.0
    jstate, jtx = jt.init_tent(params, lr=1e-2)
    jstep = jt.make_tent_step(japply, jtx)
    state, tx = pt.init_tent(port, lr=1e-2)
    step = pt.make_tent_step(port, tx)
    before = snapshot(port)
    for _ in range(10):
        jstate, jlogits = jstep(jstate, jnp.asarray(x))
        state, logits = step(state, nchw(x))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0, atol=5e-5)
    np.testing.assert_allclose(state.bn_params["bn.weight"].numpy(),
                               np.asarray(jstate.bn_params["bn"]["scale"]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(state.bn_params["bn.bias"].numpy(),
                               np.asarray(jstate.bn_params["bn"]["bias"]), rtol=0, atol=1e-6)
    assert set(state.bn_params) == {"bn.weight", "bn.bias"} and state.opt_state.count == 10
    assert not torch.equal(state.bn_params["bn.weight"], before["bn.weight"])  # it adapted
    assert_unchanged(port, before)


def test_entropy_loss():
    lg = np.random.default_rng(5).normal(0, 3, (32, 10)).astype(np.float32)
    np.testing.assert_allclose(float(pt.entropy_loss(torch.from_numpy(lg))),
                               float(jt.entropy_loss(jnp.asarray(lg))), rtol=1e-6)


# ---------------------------------------------------------------- the protocols


@pytest.fixture(scope="module")
def data():
    """4 batches of 16 and a ragged tail of 7: batch 0 all noise, 1 half
    flat (gate 0.5: no step), 2 with 9 of 16 noisy (adapts), 3 all flat,
    the tail noisy."""
    parts = [images(10, 16), images(11, 16, 0.5), images(12, 16, 7 / 16), images(13, 16, 1.0),
             images(14, 7)]
    x = np.concatenate(parts)
    y = np.random.default_rng(15).integers(0, 10, len(x)).astype(np.int32)
    return x, y, [16, 16, 16, 16, 7]


@pytest.mark.parametrize("protocol", ["continuous", "reset", "conditional"])
def test_evaluate_with_tent_matches_jax(data, protocol):
    x, y, sizes = data
    assert_gate_margin(x)
    port, params, japply = tiny(1)
    raws, labels = batches_of(x, y, sizes)
    jb = [(jnp.asarray(r.astype(np.float32) / 255.0), jnp.asarray(r)) for r in raws]
    pb = [(nchw(r.astype(np.float32) / 255.0), torch.from_numpy(r)) for r in raws]
    want = jt.evaluate_with_tent(japply, params, jb, [jnp.asarray(v) for v in labels], lr=1e-2,
                                 protocol=protocol)
    before = snapshot(port)
    got = pt.evaluate_with_tent(port, pb, [torch.from_numpy(v) for v in labels], lr=1e-2,
                                protocol=protocol, device="cpu")
    assert got == want
    assert_unchanged(port, before)


def test_conditional_gate_is_strict(data, monkeypatch):
    """Batch 1 (exactly half above the threshold) runs no step; batch 2 (9
    of 16) does; the flat batch 3 does not."""
    x, y, sizes = data
    raws, labels = batches_of(x, y, sizes)
    fracs = [float(pt.batch_gate_fraction(torch.from_numpy(r), THR)) for r in raws]
    assert fracs == [1.0, 0.5, 9 / 16, 0.0, 1.0]
    calls = []
    make = pt.make_tent_step

    def counting(model, tx):
        step = make(model, tx)

        def wrapped(state, xb):
            calls.append(int(xb.shape[0]))
            return step(state, xb)

        return wrapped

    monkeypatch.setattr(pt, "make_tent_step", counting)
    port, _, _ = tiny(1)
    pb = [(nchw(r.astype(np.float32) / 255.0), torch.from_numpy(r)) for r in raws]
    pt.evaluate_with_tent(port, pb, [torch.from_numpy(v) for v in labels], protocol="conditional",
                          device="cpu")
    assert calls == [16, 16, 7]


def test_evaluate_with_tent_rejects():
    port, _, _ = tiny(0)
    r = images(0, 4)
    xb, yb = nchw(r.astype(np.float32) / 255.0), torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="mix"):
        pt.evaluate_with_tent(port, [(xb, torch.from_numpy(r)), xb], [yb, yb], device="cpu")
    with pytest.raises(ValueError, match="conditional"):
        pt.evaluate_with_tent(port, [xb], [yb], protocol="conditional", device="cpu")
    with pytest.raises(ValueError, match="protocol"):
        pt.evaluate_with_tent(port, [xb], [yb], protocol="episodic", device="cpu")


# ---------------------------------------------------------------- the sweep


def test_tent_sweep_matches_jax(monkeypatch):
    """32 images (batches of 12: a ragged tail of 8), three corruptions at
    two severities, the four protocols at the reference's lrs, with and
    without the eval-mode baseline. Each cell's images are the port's
    ``corrupt`` with numpy draws on both sides (JAX's ``corrupt`` is
    replaced by a lookup of them)."""
    x = images(20, 32, 0.5)
    rng = np.random.default_rng(21)
    x = x[rng.permutation(32)]
    y = rng.integers(0, 10, 32).astype(np.int32)
    names, sevs = ("gaussian_noise", "brightness", "contrast"), (1, 3)
    cells = {}
    for name in names:
        for sev in sevs:
            d = numpy_draws(x, name, sev, np.random.default_rng([22, sev]))
            cells[(name, sev)] = (d, corrupt(torch.from_numpy(x), name, sev, None, **{
                k: torch.from_numpy(v) for k, v in d.items()}).numpy())
            assert_gate_margin(cells[(name, sev)][1])
    order = iter(cells)
    monkeypatch.setattr(jw, "corrupt", lambda imgs, name, sev, key: jnp.asarray(
        cells[next(order)][1]))
    lr = {"continuous": 2.5e-4, "reset": 1e-3, "conditional": 1e-3}
    port, params, japply = tiny(2)
    rm, rv = port.bn.running_mean.numpy().copy(), port.bn.running_var.numpy().copy()

    def japply_eval(xb, p=params):  # flax's BatchNorm with the running statistics
        yv = lax.conv_general_dilated(xb, p["conv"]["kernel"], (1, 1), "SAME",
                                      dimension_numbers=("NHWC", "HWIO", "NHWC"))
        yv = (yv - rm) * (lax.rsqrt(jnp.asarray(rv) + 1e-5) * p["bn"]["scale"]) + p["bn"]["bias"]
        return jnp.mean(jax.nn.relu(yv), (1, 2)) @ p["fc"]["kernel"] + p["fc"]["bias"]

    before = snapshot(port)
    for with_eval in (False, True):
        order = iter(cells)
        want = jw.tent_sweep(japply, params, names, sevs, jnp.asarray(x), jnp.asarray(y),
                             lambda u8: u8.astype(jnp.float32) / 255.0, jax.random.key(0), lr=lr,
                             batch_size=12, model_apply_eval=japply_eval if with_eval else None)
        got = pw.tent_sweep(port, names, sevs, x, y,
                            lambda u8: u8.permute(0, 3, 1, 2).to(torch.float32) / 255.0, lr=lr,
                            batch_size=12, model_apply_eval=port if with_eval else None,
                            cell_draws=lambda name, sev: cells[(name, sev)][0], device="cpu")
        assert got == want
        assert_unchanged(port, before)
