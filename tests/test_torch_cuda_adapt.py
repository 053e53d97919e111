"""TENT, MATTA and the ensemble temperature fit on the card: TF32 switched on
by the caller changes nothing.

Each product and backward of these modules runs inside
``core.precision.full_f32``, so with the caller's TF32 flags on (cuBLAS and
cuDNN) each result is bit-equal to the same call with them off: two
``adapt.tent`` steps on a ResNet-20 (logits, BatchNorm parameters, Adam
moments) with the module's parameters and buffers unchanged,
``evaluate_with_tent`` (continuous), ``adapt.matta.fit_matta_weights``
(MATTA and VATTA, 20 steps) and ``EnsembleTemperatureScaling.fit`` (20
steps). cuDNN's deterministic algorithms both times, so only TF32 could
tell the runs apart. The TENT steps are also held to the CPU's: the first
step's logits within 1e-4 of their scale, the BatchNorm parameters after
two steps within 2 lr a step (Adam's bound where a gradient near 0
differs in sign).

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips without one (decided inside the fixture). No JAX is imported:

    python -m pytest tests/test_torch_cuda_adapt.py -q
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

from imagetransformations_tpu_torch import models as pm
from imagetransformations_tpu_torch.adapt import matta, posthoc, tent
from imagetransformations_tpu_torch.models.resnet import cifar_model_space

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
    out = {}
    for on in (False, True):
        with caller_tf32(on):
            out[on] = fn()
    return out[False], out[True]


def assert_bit_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert torch.equal(a, b), float((a.float() - b.float()).abs().max())
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, dict):
        for k in a:
            assert_bit_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        for u, v in zip(a, b):
            assert_bit_equal(u, v)
    else:
        assert a == b


def _model_and_batch(dev, n=64):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        cpu = pm.resnet20(device="cpu")
    x = np.random.default_rng(1).integers(0, 256, (n, 32, 32, 3), dtype=np.uint8)
    return cpu, copy.deepcopy(cpu).to(dev), cifar_model_space(torch.from_numpy(x))


def _tent_steps(model, x, steps=2):
    state, tx = tent.init_tent(model, lr=1e-3)
    step = tent.make_tent_step(model, tx)
    logits = []
    for _ in range(steps):
        state, lg = step(state, x)
        logits.append(lg)
    return logits, state.bn_params, state.opt_state.mu, state.opt_state.nu


def test_tent_step_tf32_on_equals_off(cuda):
    cpu, model, x = _model_and_batch(cuda)
    before = {k: v.clone() for k, v in [*model.named_parameters(), *model.named_buffers()]}
    off, on = on_and_off(lambda: _tent_steps(model, x.to(cuda)))
    assert_bit_equal(off, on)
    for k, v in [*model.named_parameters(), *model.named_buffers()]:
        assert torch.equal(v, before[k]), k
    want = _tent_steps(cpu, x)
    first, last = off[0][0].cpu(), want[0][0]
    assert float((first - last).abs().max()) <= 1e-4 * float(last.abs().max())
    # Adam moves each element ~lr a step whatever its gradient's size: where
    # a gradient near 0 differs in sign between the devices, up to 2 lr a step
    for k, w in want[1].items():
        assert float((off[1][k].cpu() - w).abs().max()) <= 2 * 1e-3 * 2


def test_evaluate_with_tent_tf32_on_equals_off(cuda):
    _, model, x = _model_and_batch(cuda)
    y = torch.randint(0, 10, (64,), generator=torch.Generator().manual_seed(2))
    batches, labels = [x[:32].to(cuda), x[32:].to(cuda)], [y[:32], y[32:]]
    off, on = on_and_off(lambda: tent.evaluate_with_tent(model, batches, labels, device=cuda))
    assert off == on


def _view_probs(dev):
    rng = np.random.default_rng(3)
    lg = torch.from_numpy(rng.normal(0, 2, (4, 512, 10)).astype(np.float32)).to(dev)
    return torch.softmax(lg, -1), torch.from_numpy(rng.integers(0, 10, 512)).to(dev)


@pytest.mark.parametrize("per_class", [True, False])
def test_fit_matta_weights_tf32_on_equals_off(cuda, per_class):
    vp, y = _view_probs(cuda)
    assert_bit_equal(*on_and_off(lambda: matta.fit_matta_weights(vp, y, steps=20,
                                                                 per_class=per_class)))


def test_ensemble_temperature_fit_tf32_on_equals_off(cuda):
    vp, y = _view_probs(cuda)
    logits = torch.log(vp[0]) * 3.0
    assert_bit_equal(*on_and_off(
        lambda: posthoc.EnsembleTemperatureScaling().fit(logits, y, steps=20).weights))
