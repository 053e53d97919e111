"""The classifiers, the Mahalanobis score and the sweep on the card.

For each architecture of ``models`` (random weights from a seed, BatchNorm
statistics drawn so that their import is exercised) at a small batch: the
card's logits against the CPU's, max |difference| <= 1e-3 * max(1, max
|logit|) and the same argmax except where the CPU's top two logits are
within that budget; and the card's forward with TF32 switched on by the
caller bit-equal to the forward with it off (``core.precision.full_f32``
holds inside every forward). The Mahalanobis score and ODIN the same way,
and ``corruption_sweep`` with ``uq_extras`` on 64 images on the card
within 1/64 in accuracy and 0.01 in AUROC of the CPU's (ODIN's gradient
signs differ between the devices where the gradient is near 0, so its
ranks can swap: one swap moves the AUROC by 1/(errors x correct), 0.016 at
24 images), ``rotation`` on the NEAREST rotation kernel. The backward
passes too: ODIN's input gradient, ``gradient_uncertainty``, one Adam step
of ``make_train_step`` and one of ``make_elbo_step``, each with TF32
switched on by the caller bit-equal to TF32 off (cuDNN reads the flag when
the backward runs, so ``full_f32`` must hold around it as well; cuDNN's
deterministic algorithms both times, so only TF32 could tell them apart).

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips without one (decided inside the fixture). No JAX is imported:

    python -m pytest tests/test_torch_cuda_models.py -q
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

from imagetransformations_tpu_torch import models as pm
from imagetransformations_tpu_torch.evalx import harness as hs
from imagetransformations_tpu_torch.models import bayesian as pb
from imagetransformations_tpu_torch.models import training as pt
from imagetransformations_tpu_torch.models.resnet import cifar_model_space
from imagetransformations_tpu_torch.ops.hopper import _lib
from imagetransformations_tpu_torch.uq import mahalanobis as pmh
from imagetransformations_tpu_torch.uq.metrics import gradient_uncertainty
from imagetransformations_tpu_torch.uq.odin import _input_gradient, odin_uncertainty

pytestmark = pytest.mark.cuda

#: architecture -> (factory on a device, input side, batch)
ARCHS = {
    "resnet20": (lambda d: pm.resnet20(device=d), 32, 16),
    "resnet56": (lambda d: pm.resnet56(device=d), 32, 16),
    "simple_cnn": (lambda d: pm.SimpleCNN(device=d), 32, 16),
    "bayesian_cnn": (lambda d: pm.BayesianCNN(device=d), 32, 16),
    "resnet18": (lambda d: pm.ResNet18(device=d), 224, 2),
    "resnet50": (lambda d: pm.ResNet50(device=d), 224, 2),
    "vgg19_bn": (lambda d: pm.VGG19BN(device=d), 224, 1),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card path runs only on the card")
    return torch.device("cuda")


def _model(arch, seed=0):
    """The CPU model (random weights from ``seed``, drawn BN statistics)."""
    make = ARCHS[arch][0]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = make("cpu")
        with torch.no_grad():
            for m in model.modules():
                if isinstance(m, torch.nn.BatchNorm2d):
                    m.running_mean.normal_(0, 0.3)
                    m.running_var.uniform_(0.5, 1.5)
    return model


def _forward(model, x, arch, device):
    with torch.no_grad():
        if arch == "bayesian_cnn":  # its rho is -100: the draws do not change the weights
            return model(x, generator=torch.Generator(device=device).manual_seed(0))
        return model(x)


def _within_budget(card, cpu):
    budget = 1e-3 * max(1.0, float(cpu.abs().max()))
    assert float((card - cpu).abs().max()) <= budget
    top2 = torch.topk(cpu, 2, dim=-1).values
    close = (top2[:, 0] - top2[:, 1]) <= budget
    agree = torch.argmax(card, -1) == torch.argmax(cpu, -1)
    assert bool((agree | close).all())


@pytest.mark.parametrize("arch", list(ARCHS))
def test_card_against_cpu_and_tf32(cuda, arch):
    cpu_model = _model(arch)
    if arch == "bayesian_cnn":  # each weight its mean: the draws do not matter across devices
        with torch.no_grad():
            for m in cpu_model.modules():
                if isinstance(m, pb._Bayesian):
                    m.rho.fill_(-100.0)
                    m.bias_rho.fill_(-100.0)
    card_model = copy.deepcopy(cpu_model).to(cuda)
    _, side, n = ARCHS[arch]
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((n, 3, side, side)).astype(np.float32))
    cpu = _forward(cpu_model, x, arch, "cpu")
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    outs = {}
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
            outs[tf32] = _forward(card_model, x.to(cuda), arch, cuda).cpu()
            # full_f32 restores the caller's flags
            assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (
                tf32, tf32)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    assert torch.equal(outs[True], outs[False]), "TF32 changed the logits"
    _within_budget(outs[False], cpu)


def test_mahalanobis_and_odin_on_the_card(cuda):
    rng = np.random.default_rng(2)
    feats = torch.from_numpy((rng.normal(size=(512, 64)) @ rng.normal(size=(64, 64)) * 0.1)
                             .astype(np.float32))
    test = torch.from_numpy(rng.normal(size=(256, 64)).astype(np.float32))
    st = pmh.fit(feats)
    card_st = pmh.MahalanobisState(st.mean.to(cuda), st.precision.to(cuda))
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        card = pmh.score(card_st, test.to(cuda)).cpu()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    np.testing.assert_allclose(card.numpy(), pmh.score(st, test).numpy(), rtol=1e-5)
    model = _model("resnet20")
    x = cifar_model_space(torch.from_numpy(rng.integers(0, 256, (16, 32, 32, 3),
                                                        dtype=np.uint8)))
    cpu = odin_uncertainty(model, x)
    got = odin_uncertainty(copy.deepcopy(model).to(cuda), x.to(cuda)).cpu()
    np.testing.assert_allclose(got.numpy(), cpu.numpy(), atol=1e-5)


def test_sweep_on_the_card(cuda):
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (64, 32, 32, 3), dtype=np.uint8)
    labels = rng.integers(0, 10, 64).astype(np.int32)
    model = _model("resnet20")
    with torch.no_grad():
        st = pmh.fit(model.features(cifar_model_space(torch.from_numpy(imgs))))
    names = ("gaussian_noise", "rotation", "fog")

    def draws(name, sev):
        return hs.numpy_draws(imgs, name, sev, np.random.default_rng([4, len(name), sev]))

    def run(m, dev):
        return hs.corruption_sweep(m, cifar_model_space, imgs, labels, corruption_names=names,
                                   severities=(1, 5), batch_size=24, cell_draws=draws,
                                   uq_extras={"feats_logits_fn": m.features_and_logits,
                                              "maha_mean": st.mean,
                                              "maha_precision": st.precision}, device=dev)

    cpu = run(model, "cpu")
    _lib.LAUNCHES["pil_rotate_nearest"] = 0
    card = run(copy.deepcopy(model).to(cuda), cuda)
    assert _lib.LAUNCHES["pil_rotate_nearest"] == 2
    for name in names:
        for sev in (1, 5):
            g, w = card[name][sev], cpu[name][sev]
            assert abs(g["accuracy"] - w["accuracy"]) <= 1 / 64
            for m in w["auroc"]:
                assert abs(g["auroc"][m] - w["auroc"][m]) <= 0.01, (name, sev, m)


@contextlib.contextmanager
def _caller_flags(tf32):
    """The caller's TF32 flags for cuBLAS and cuDNN set to ``tf32``, and
    cuDNN held to its deterministic algorithms; all restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic) = saved


def test_input_gradients_tf32(cuda):
    """ODIN's input gradient and gradient_uncertainty: TF32 on by the caller
    bit-equal to TF32 off."""
    model = copy.deepcopy(_model("resnet20")).to(cuda)
    rng = np.random.default_rng(5)
    x = cifar_model_space(torch.from_numpy(rng.integers(0, 256, (32, 32, 32, 3),
                                                        dtype=np.uint8))).to(cuda)
    out = {}
    for tf32 in (False, True):
        with _caller_flags(tf32):
            out[tf32] = (_input_gradient(model, x),
                         gradient_uncertainty(model, x,
                                              torch.Generator(device=cuda).manual_seed(0)))
    assert torch.equal(out[True][0], out[False][0]), "TF32 changed ODIN's input gradient"
    assert torch.equal(out[True][1], out[False][1]), "TF32 changed gradient_uncertainty"


@pytest.mark.parametrize("arch", ["resnet20", "bayesian_cnn"])
def test_train_step_tf32(cuda, arch):
    """One Adam step (``make_train_step``; ``make_elbo_step`` for the BNN)
    from the same weights on the same batch: every gradient, every updated
    parameter and BatchNorm statistic with TF32 on by the caller bit-equal
    to TF32 off."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((32, 3, 32, 32)).astype(np.float32)).to(cuda)
    y = torch.from_numpy(rng.integers(0, 10, 32)).to(cuda)
    runs = {}
    for tf32 in (False, True):
        model = copy.deepcopy(_model(arch)).to(cuda)
        opt = torch.optim.Adam(model.parameters(), lr=1e-3)
        with _caller_flags(tf32):
            if arch == "bayesian_cnn":
                pt.make_elbo_step(model, opt, 1e-3)(
                    x, y, torch.Generator(device=cuda).manual_seed(0))
            else:
                pt.make_train_step(model, opt)(x, y)
        grads = {k: p.grad.clone() for k, p in model.named_parameters()}
        runs[tf32] = (grads, {k: v.clone() for k, v in model.state_dict().items()})
    for k, g in runs[False][0].items():
        assert torch.equal(runs[True][0][k], g), f"TF32 changed the gradient of {k}"
    for k, v in runs[False][1].items():
        assert torch.equal(runs[True][1][k], v), f"TF32 changed {k} after the step"
