"""The port's ImageNet classifiers against the JAX package's (CPU).

ResNet-18 / ResNet-50 at 2x64x64x3 and VGG-19-BN built for 32x32 input
(``input_size=32``: fc1 takes 512 inputs, as the JAX VGG sized by its
input) at 1x32x32x3. Weights are made in flax and carried across with
``from_flax``; each state_dict also goes through the JAX importer and
back. Budgets: tests/test_torch_parity.py's (ResNets atol 5e-4, rtol 1e-3;
VGG atol 5e-3, rtol 1e-3).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagetransformations_tpu import models as jm
from imagetransformations_tpu.models import imagenet as ji
from imagetransformations_tpu_torch import models as pm
from imagetransformations_tpu_torch.models import imagenet as pi

from test_torch_models import _torch_threads, flax_variables, nchw  # noqa: F401


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_imagenet_resnets(arch, rng):
    x = rng.standard_normal((2, 64, 64, 3)).astype(np.float32)
    jmodel, port = {"resnet18": (jm.ResNet18(), pm.ResNet18(device="cpu")),
                    "resnet50": (jm.ResNet50(), pm.ResNet50(device="cpu"))}[arch]
    variables = flax_variables(jmodel, x, 0)
    pm.from_flax(port, variables)
    with torch.no_grad():
        got = port(nchw(x)).numpy()
        feats = port.features(nchw(x))
    np.testing.assert_allclose(got, np.asarray(jmodel.apply(variables, jnp.asarray(x))),
                               atol=5e-4, rtol=1e-3)
    assert tuple(feats.shape) == (2, 2048 if arch == "resnet50" else 512)
    # torch state_dict -> the JAX importer -> from_flax: the same tensors
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    back = pm.from_flax(type(port)(device="cpu"), ji.load_resnet_torch_state_dict(state))
    for k, v in port.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, back.state_dict()[k]), k


def test_vgg19_bn_at_32(rng):
    x = rng.standard_normal((1, 32, 32, 3)).astype(np.float32)
    jmodel = jm.VGG19BN()
    variables = flax_variables(jmodel, x, 1)
    port = pm.from_flax(pm.VGG19BN(input_size=32, device="cpu"), variables)
    assert port.classifier[0].in_features == 512
    assert pm.VGG19BN(device="cpu").classifier[0].in_features == 512 * 7 * 7
    with torch.no_grad():
        got = port(nchw(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jmodel.apply(variables, jnp.asarray(x))),
                               atol=5e-3, rtol=1e-3)
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    back = pm.from_flax(pm.VGG19BN(input_size=32, device="cpu"),
                        ji.load_vgg19_bn_torch_state_dict(state))
    for k, v in port.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, back.state_dict()[k]), k
    # training mode: dropout draws from the generator, a fixed one repeats
    g = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    with torch.no_grad():
        a, b = port(nchw(x), True, g()), port(nchw(x), True, g())
    assert torch.equal(a, b)


def test_imagenet_model_space(rng):
    u8 = rng.integers(0, 256, (2, 8, 8, 3), dtype=np.uint8)
    got = pi.imagenet_model_space(torch.from_numpy(u8))
    want = np.asarray(ji.normalize_imagenet(jnp.asarray(u8, jnp.float32) / 255.0))
    np.testing.assert_array_equal(got.numpy(), want.transpose(0, 3, 1, 2))
