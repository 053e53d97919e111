"""The posteriors, kNN, attacks and refinement on the card: TF32 switched on
by the caller changes nothing.

Each product and backward of these modules runs inside
``core.precision.full_f32``, so with the caller's TF32 flags on (cuBLAS and
cuDNN) each result here is bit-equal to the same call with them off:
``uq.knn.similarities`` (cosine and euclidean, a [256, 4096] product),
``uq.laplace.fit`` and ``predictive``, one ``uq.swag.sample`` and
``bma_logits`` on a ResNet-20 and on a plain module whose forward does not
scope itself, the FGSM input gradient
(``attacks.fgsm._ce_grad``), one ``adapt.refine.refine_batch`` step and one
``attacks.adversarial_train_step`` (gradients, weights and statistics).
cuDNN's deterministic algorithms both times, so only TF32 could tell the
runs apart. The card's kNN and Laplace results are also held to the CPU's
(neighbour labels equal, variances rtol 1e-4).

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips without one (decided inside the fixture). No JAX is imported:

    python -m pytest tests/test_torch_cuda_uq.py -q
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

from imagetransformations_tpu_torch import attacks
from imagetransformations_tpu_torch import models as pm
from imagetransformations_tpu_torch.adapt import refine
from imagetransformations_tpu_torch.attacks.fgsm import _ce_grad
from imagetransformations_tpu_torch.models.resnet import cifar_model_space
from imagetransformations_tpu_torch.uq import knn, laplace, swag

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card path runs only on the card")
    return torch.device("cuda")


@contextlib.contextmanager
def caller_tf32(on: bool):
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = (matmul.allow_tf32, cudnn.allow_tf32, cudnn.deterministic)
    matmul.allow_tf32 = cudnn.allow_tf32 = on
    cudnn.deterministic = True
    try:
        yield
    finally:
        matmul.allow_tf32, cudnn.allow_tf32, cudnn.deterministic = saved


def on_and_off(fn):
    """fn() with the caller's TF32 off, then on; both results."""
    out = {}
    for on in (False, True):
        with caller_tf32(on):
            out[on] = fn()
    return out[False], out[True]


def assert_bit_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), float((a.float() - b.float()).abs().max())
    elif isinstance(a, dict):
        for k in a:
            assert_bit_equal(a[k], b[k])
    else:
        for u, v in zip(a, b):
            assert_bit_equal(u, v)


def _features(seed, n, d=64):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.normal(size=(n, d)) @ rng.normal(size=(d, d)) * 0.1)
                            .astype(np.float32))


def _resnet20(seed=0):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return pm.resnet20(device="cpu")


def _batch(cuda, n=32, seed=1):
    rng = np.random.default_rng(seed)
    x = cifar_model_space(torch.from_numpy(rng.integers(0, 256, (n, 32, 32, 3), np.uint8)))
    return x.contiguous().to(cuda), torch.from_numpy(rng.integers(0, 10, n)).to(cuda)


@pytest.mark.parametrize("metric", ["cosine", "euclidean"])
def test_knn_similarities(cuda, metric):
    tr, q = _features(0, 4096), _features(1, 256)
    labels = torch.from_numpy(np.random.default_rng(2).integers(0, 10, 4096))
    off, on = on_and_off(lambda: knn.similarities(tr.to(cuda), q.to(cuda), metric))
    assert_bit_equal(off, on)
    ent, maj = knn.knn_label_entropy(tr.to(cuda), labels.to(cuda), q.to(cuda), metric=metric)
    cent, cmaj = knn.knn_label_entropy(tr, labels, q, metric=metric)
    assert torch.equal(maj.cpu(), cmaj) and torch.equal(ent.cpu(), cent)
    dist, nl = knn.nearest_feature_distance(tr.to(cuda), labels.to(cuda), q.to(cuda))
    cdist, cnl = knn.nearest_feature_distance(tr, labels, q)
    assert torch.equal(nl.cpu(), cnl)
    np.testing.assert_allclose(dist.cpu().numpy(), cdist.numpy(), rtol=1e-4, atol=1e-4)


def test_laplace(cuda):
    f = _features(3, 4096)
    rng = np.random.default_rng(4)
    w = torch.from_numpy((rng.normal(size=(64, 10)) * 0.3).astype(np.float32))
    b = torch.zeros(10)
    draws = (torch.from_numpy(rng.normal(size=(8, 64, 10)).astype(np.float32)),
             torch.from_numpy(rng.normal(size=(8, 10)).astype(np.float32)))

    def run(dev):
        st = laplace.fit(f.to(dev), w.to(dev), b.to(dev))
        q = f[:256].to(dev)
        return (st.w_var, st.b_var, *laplace.predictive(st, q, draws=tuple(d.to(dev) for d in draws)),
                laplace.closed_form_variance(st, q))

    off, on = on_and_off(lambda: run(cuda))
    assert_bit_equal(off, on)
    for got, want in zip(off, run("cpu")):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("arch", ["resnet20", "plain"])
def test_swag_sample_and_bma(cuda, arch):
    """A ResNet-20 (whose forward scopes itself) and a plain convolution +
    dense module (which does not: ``bma_logits``' own scope must hold)."""
    if arch == "resnet20":
        model = _resnet20().to(cuda)
    else:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = torch.nn.Sequential(
                torch.nn.Conv2d(3, 32, 3), torch.nn.ReLU(), torch.nn.Flatten(),
                torch.nn.Linear(32 * 30 * 30, 10)).to(cuda)
    state = swag.init(model, max_rank=4)
    g = torch.Generator(device=cuda).manual_seed(0)
    for _ in range(5):
        with torch.no_grad():
            for p in model.parameters():
                p.add_(1e-3 * torch.randn(p.shape, generator=g, device=cuda))
        swag.update(state, model)
    draws = swag.draw(state, torch.Generator(device=cuda).manual_seed(1))
    x, _ = _batch(cuda)

    def run():
        stacked = {k: v[None] for k, v in swag.sample(state, draws=draws).items()}
        return stacked, swag.bma_logits(model, stacked, x)

    off, on = on_and_off(run)
    assert_bit_equal(off, on)


def test_fgsm_gradient_and_refine_step(cuda):
    model = _resnet20().to(cuda)
    x, y = _batch(cuda)
    off, on = on_and_off(lambda: _ce_grad(model, x, y))
    assert_bit_equal(off, on)
    flagged = torch.ones(x.shape[0], dtype=torch.bool, device=cuda)
    off, on = on_and_off(lambda: refine.refine_batch(model, x, flagged, max_iters=1)[0])
    assert_bit_equal(off, on)


def test_adversarial_train_step(cuda):
    base = _resnet20().to(cuda)
    x, y = _batch(cuda)
    x = (x - x.min()) / (x.max() - x.min())  # the step clips to [0, 1]

    def run():
        model = copy.deepcopy(base)
        opt = torch.optim.SGD(model.parameters(), lr=0.1, momentum=0.9)
        loss = attacks.adversarial_train_step(model, opt, x, y)
        return loss, {k: p.grad for k, p in model.named_parameters()}, model.state_dict()

    off, on = on_and_off(run)
    assert_bit_equal(off, on)
