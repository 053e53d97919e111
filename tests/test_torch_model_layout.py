"""The ResNets' layout on the card (``models._layers.body_layout``) and the
BatchNorm arithmetic that keeps their logits bit-equal through it.

On a CUDA device the ResNets turn their activations NCHW-contiguous once,
after the stem, so that cuDNN's true-f32 convolutions run without
transposing every input and output; BatchNorm computes what cuDNN's
channels-last inference kernel computes, and the global pool sums in the
channels-last order. The model spaces' channels-last strides are left as
they are.

- CPU: the input reaches ``conv1`` as it was given (same storage, same
  strides), and the logits on a channels-last-strided input are bit-equal
  to the channels-last forward (the layers called in order, BatchNorm by
  ``F.batch_norm``); BatchNorm's inference coefficients agree with
  ``F.batch_norm``, are kept until a parameter or statistic changes and
  pass BatchNorm's gradients to the input, the weight and the bias.
- Card (``cuda`` marker, skipped without a GPU): BatchNorm in evaluation
  mode equals cuDNN's channels-last kernel bit for bit, on NCHW and on
  channels-last input; a batch-8 ResNet-56 forward plus ODIN's input
  gradient and a batch-2 ResNet-50 forward at 224x224 under torch.profiler
  run no ``nhwcToNchw`` / ``nchwToNhwc`` kernel beyond those of the stem's
  convolution alone, their logits are the channels-last forward's within
  1e-5 x max(1, max |logit|) (cuDNN may pick other convolution kernels at
  these small batches: ResNet-56 at batch 8 read 3e-5 of 74), and ODIN's
  gradient is within 1e-3 x max |gradient| of it (cuDNN takes the input
  gradient of ResNet-56's first stage by FFT in NCHW, by an implicit GEMM
  on channels-last strides: 1.3e-4 x max read at batch 8 on an H100).

No JAX is imported:

    python -m pytest tests/test_torch_model_layout.py -q
"""

from unittest import mock

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from imagetransformations_tpu_torch import models as pm
from imagetransformations_tpu_torch.core.precision import full_f32
from imagetransformations_tpu_torch.models._layers import BatchNorm
from imagetransformations_tpu_torch.models.imagenet import imagenet_model_space
from imagetransformations_tpu_torch.models.resnet import cifar_model_space
from imagetransformations_tpu_torch.uq.odin import _input_gradient

TRANSPOSES = ("nhwcToNchw", "nchwToNhwc")

#: architecture -> (factory on a device, model space, input side)
ARCHS = {
    "resnet56": (lambda d: pm.resnet56(device=d), cifar_model_space, 32),
    "resnet50": (lambda d: pm.ResNet50(device=d), imagenet_model_space, 64),
    "vgg19_bn": (lambda d: pm.VGG19BN(input_size=32, device=d), imagenet_model_space, 32),
}


def _batch_norm_by_library(bn, x, train=False):
    assert not train
    return F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.0,
                        bn.eps)


def channels_last_forward(model, x):
    """The network's logits with its layers called in order on ``x`` as it is
    given and BatchNorm by ``F.batch_norm``: the forward before the layout
    rule (on the card, cuDNN's kernels on the model space's strides)."""
    with mock.patch.object(BatchNorm, "forward", _batch_norm_by_library), full_f32():
        if isinstance(model, pm.VGG19BN):
            for layer in model.features:
                x = layer(x, False) if isinstance(layer, BatchNorm) else layer(x)
            fc1, _, _, fc2, _, _, fc3 = model.classifier
            return fc3(torch.relu(fc2(torch.relu(fc1(x.flatten(1))))))
        x = torch.relu(model.bn1(model.conv1(x)))
        if isinstance(model, pm.CifarResNet):
            blocks = model._blocks()
        else:
            x = F.max_pool2d(x, 3, 2, 1)
            blocks = [b for s in (model.layer1, model.layer2, model.layer3, model.layer4)
                      for b in s]
        for block in blocks:
            x = block(x)
        return model.fc(x.mean(dim=(2, 3)))


def _model(arch, device):
    """The network with random weights and drawn BatchNorm statistics."""
    torch.manual_seed(0)
    model = ARCHS[arch][0](device).eval()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.normal_(0, 0.3)
                m.running_var.uniform_(0.5, 1.5)
                m.weight.normal_(1, 0.1)
                m.bias.normal_(0, 0.1)
    return model


def _u8(n, side, device, seed=1):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, 256, (n, side, side, 3), dtype=np.uint8)).to(device)


def _first_conv(model):
    return model.features[0] if isinstance(model, pm.VGG19BN) else model.conv1


@pytest.mark.parametrize("arch", list(ARCHS))
def test_cpu_input_reaches_conv1_unchanged_and_logits_bit_equal(arch):
    _, space, side = ARCHS[arch]
    model = _model(arch, "cpu")
    x = space(_u8(2, side, "cpu"))
    assert x.is_contiguous(memory_format=torch.channels_last) and not x.is_contiguous()
    seen = []
    hook = _first_conv(model).register_forward_pre_hook(lambda m, args: seen.append(args[0]))
    try:
        with torch.no_grad():
            got = model(x)
    finally:
        hook.remove()
    (first,) = seen
    assert first.data_ptr() == x.data_ptr() and first.stride() == x.stride()
    with torch.no_grad():
        assert torch.equal(got, channels_last_forward(model, x))


def _drawn_batch_norm(c, seed=3):
    torch.manual_seed(seed)
    bn = BatchNorm(c, device="cpu")
    with torch.no_grad():
        bn.running_mean.normal_(0, 0.3)
        bn.running_var.uniform_(0.5, 1.5)
        bn.weight.normal_(1, 0.1)
        bn.bias.normal_(0, 0.1)
    return bn


def test_inference_coefficients_agree_with_batch_norm():
    bn = _drawn_batch_norm(16)
    x = torch.randn(4, 16, 5, 5) * 3 + 0.5
    with torch.no_grad():
        scale, shift = bn._inference_coefficients()
        got = scale.double() * x.double() + shift.double()
        want = _batch_norm_by_library(bn, x).double()
    torch.testing.assert_close(got, want, rtol=0, atol=4e-6)


def test_inference_coefficients_kept_until_a_parameter_changes():
    bn = _drawn_batch_norm(8)
    with torch.no_grad():
        first = bn._inference_coefficients()
        assert all(a is b for a, b in zip(bn._inference_coefficients(), first))
        bn.weight.mul_(2.0)  # in place: the version counter moves
        second = bn._inference_coefficients()
        torch.testing.assert_close(second[0], 2.0 * first[0])  # the scale
        bn.load_state_dict(_drawn_batch_norm(8, seed=4).state_dict())
        third = bn._inference_coefficients()
        assert not torch.equal(third[1], second[1])
        assert all(a is b for a, b in zip(bn._inference_coefficients(), third))


def test_inference_gradients_are_batch_norms():
    """The kept coefficients pass BatchNorm's evaluation-mode gradients to x,
    the weight and the bias (and nothing is made anew)."""
    bn = _drawn_batch_norm(6).double()
    x = torch.randn(3, 6, 4, 4, dtype=torch.float64, requires_grad=True)
    r = torch.randn(3, 6, 4, 4, dtype=torch.float64)
    scale, shift = bn._inference_coefficients()
    got = torch.autograd.grad((torch.addcmul(shift, x, scale) * r).sum(),
                              (x, bn.weight, bn.bias))
    want = torch.autograd.grad((_batch_norm_by_library(bn, x) * r).sum(),
                               (x, bn.weight, bn.bias))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-12, atol=1e-12)
    with torch.no_grad():
        kept = bn._inference_coefficients()
    assert torch.equal(scale, kept[0]) and torch.equal(shift, kept[1])


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the layout rule acts only on the card")
    return torch.device("cuda")


def _kernels(fn):
    """(fn's result, the names of the device kernels it ran)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA]
    return out, names


def _transposes(names):
    return [n for n in names if any(t in n for t in TRANSPOSES)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(8, 16, 32, 32), (4, 64, 56, 56), (2, 2048, 7, 7)])
def test_card_batch_norm_is_cudnns_channels_last_kernel(cuda, shape):
    bn = _drawn_batch_norm(shape[1]).to(cuda)
    x = torch.randn(shape, device=cuda) * 3 + 0.5
    x_cl = x.contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        want = _batch_norm_by_library(bn, x_cl)
        assert torch.equal(bn(x), want)
        assert torch.equal(bn(x_cl), want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch, batch, side, odin", [("resnet56", 8, 32, True),
                                                     ("resnet50", 2, 224, False)])
def test_card_runs_no_layout_transpose(cuda, arch, batch, side, odin):
    model = _model(arch, cuda)
    x = ARCHS[arch][1](_u8(batch, side, cuda))
    assert x.is_contiguous(memory_format=torch.channels_last)

    def run():
        with torch.no_grad():
            logits = model(x)
        return logits, (_input_gradient(model, x) if odin else None)

    def stem():  # the stem's convolution alone, in the input's layout
        leaf = x.detach().requires_grad_(True)
        with full_f32(), torch.enable_grad():
            y = model.conv1(leaf)
            if odin:
                torch.autograd.grad(y, leaf, torch.ones_like(y).contiguous())

    run()  # cuDNN's choices and lazy loads outside the profile
    (logits, grad), names = _kernels(run)
    _, stem_names = _kernels(stem)
    assert any("conv" in n.lower() or "xmma" in n for n in names), names
    assert len(_transposes(names)) <= len(_transposes(stem_names)), _transposes(names)
    with torch.no_grad():
        want = channels_last_forward(model, x)
    assert float((logits - want).abs().max()) <= 1e-5 * max(1.0, float(want.abs().max()))
    if odin:
        want_grad = _input_gradient(lambda xb: channels_last_forward(model, xb), x)
        assert grad.shape == x.shape
        assert float((grad - want_grad).abs().max()) <= 1e-3 * float(want_grad.abs().max())
