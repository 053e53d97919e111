"""The one-process mesh, the angelic patches and the evolutionary search on
the card.

- ``sharded_chain_fn`` on ``data_mesh(4, device="cuda")`` (four shards on
  one GPU): blur -> rotation -> grayscale with a static angle (#1) and with
  per-image angles whose first shard lies in a lower 5-degree band (#4),
  and their RGB forms (#3, #5): 0 LSB against the one-device chain on the
  card and against the CPU's, each kernel launched once a shard;
- ``sharded_gaussian_blur`` (#6 once a shard): 0 LSB against
  ``gaussian_blur`` on the card and on the CPU;
- ``evaluate_sharded`` and ``corruption_sweep(mesh=)`` on a ResNet-20:
  accuracy equal to the one-device run, logits within 1e-4 of their scale;
- ``adet_operator`` and ``apply_transformed_patch`` with the same draws:
  equal to the CPU's (the same f32 ops on both devices);
- ``fitness_fn`` of the noise-free genes: within 1e-3 relative of the
  CPU's; the blur gene launches #3 once.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips without one (decided inside the fixture). No JAX is imported:

    python -m pytest tests/test_torch_cuda_sharding.py -q
"""

import numpy as np
import pytest
import torch

from imagetransformations_tpu_torch import models as pm
from imagetransformations_tpu_torch.adapt import evolution as ev
from imagetransformations_tpu_torch.adapt import patches as pa
from imagetransformations_tpu_torch.evalx import harness as hs
from imagetransformations_tpu_torch.models.resnet import cifar_model_space
from imagetransformations_tpu_torch.ops.hopper import _lib
from imagetransformations_tpu_torch.ops.sharded_stencil import sharded_gaussian_blur
from imagetransformations_tpu_torch.ops.stencil import gaussian_blur
from imagetransformations_tpu_torch.pipeline import sharding as shd
from imagetransformations_tpu_torch.pipeline.chain import OpSpec, build_chain_fn

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card path runs only on the card")
    return torch.device("cuda")


def _angles(n=16):
    a = np.random.default_rng(3).uniform(-22.5, 22.5, n).astype(np.float32)
    a[: n // 4] = (1.0, -2.0, 3.5, -4.0)[: n // 4]
    return a


@pytest.mark.parametrize("kernel,chain", [
    ("luma_blur_rotate", [OpSpec("blur", {"radius": 1.5}), OpSpec("rotation", {"angle": 12.5}),
                          OpSpec("grayscale")]),
    ("luma_blur_rotate_traced", [OpSpec("blur", {"radius": 1.5}),
                                 OpSpec("rotation", {"angle": _angles()}), OpSpec("grayscale")]),
    ("rgb_blur_rotate", [OpSpec("blur", {"radius": 1.5}), OpSpec("rotation", {"angle": 12.5})]),
    ("rgb_blur_rotate_traced", [OpSpec("blur", {"radius": 1.5}),
                                OpSpec("rotation", {"angle": _angles()})]),
])
@pytest.mark.parametrize("shape", [(16, 160, 200), (16, 32, 32)])
def test_sharded_chain_on_the_card(cuda, kernel, chain, shape):
    if shape[1] < 128 and kernel == "luma_blur_rotate":
        kernel = "luma_blur_rotate_packed"
    mesh = shd.data_mesh(4, device="cuda")
    x = torch.randint(0, 256, (*shape, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(7))
    before = _lib.LAUNCHES[kernel]
    out = shd.sharded_chain_fn(chain, mesh)(x.to(cuda))
    assert _lib.LAUNCHES[kernel] - before == 4
    assert all(s.device == torch.device("cuda", 0) for s in out.shards)
    got = out.gather()
    assert torch.equal(got, build_chain_fn(chain, device="cuda")(x.to(cuda)))
    assert torch.equal(got.cpu(), build_chain_fn(chain, device="cpu")(x))


def test_sharded_blur_on_the_card(cuda):
    mesh = shd.data_mesh(4, device="cuda")
    x = torch.randint(0, 256, (3, 200, 72, 3), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(8))
    for r in (1.5, 5.0):
        before = _lib.LAUNCHES["blur_separable"]
        got = sharded_gaussian_blur(x.to(cuda), r, mesh).gather()
        assert _lib.LAUNCHES["blur_separable"] - before == 4
        assert torch.equal(got, gaussian_blur(x.to(cuda), r))
        assert torch.equal(got.cpu(), gaussian_blur(x, r))


def test_evaluation_over_the_mesh(cuda):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        net = pm.resnet20(device="cpu")
    net = net.to(cuda).eval()
    rng = np.random.default_rng(4)
    x = rng.integers(0, 256, (60, 32, 32, 3), dtype=np.uint8)
    y = rng.integers(0, 10, 60)
    mesh = shd.data_mesh(4, device="cuda")
    got = hs.evaluate_sharded(net, cifar_model_space, x, y, mesh)
    want = hs.evaluate_batched(net, cifar_model_space, x, y, batch_size=60, device="cuda")
    assert got["accuracy"] == want["accuracy"]
    scale = float(want["logits"].abs().max())
    assert float((got["logits"] - want["logits"]).abs().max()) <= 1e-4 * scale
    kw = dict(seed=1, corruption_names=("gaussian_noise", "rotation"), severities=(2,),
              batch_size=60, device="cuda")
    a = hs.corruption_sweep(net, cifar_model_space, x, y, mesh=mesh, **kw)
    b = hs.corruption_sweep(net, cifar_model_space, x, y, **kw)
    for name in a:
        assert a[name][2]["accuracy"] == b[name][2]["accuracy"]


def test_patches_equal_the_cpu(cuda):
    rng = np.random.default_rng(5)
    n = 8
    x = torch.from_numpy(rng.random((n, 32, 32, 3)).astype(np.float32))
    patch = torch.from_numpy(rng.random((6, 5, 3)).astype(np.float32))
    draws = {"corruption_idx": rng.integers(0, 2, n), "scale": rng.uniform(0.8, 1.2, n),
             "angle": rng.uniform(-15, 15, n), "shear": rng.uniform(-0.15, 0.15, n),
             "brightness": rng.uniform(0.8, 1.2, n), "y_u": rng.uniform(0, 1, n),
             "x_u": rng.uniform(0, 1, n),
             "noise": rng.standard_normal((n, 32, 32, 3)).astype(np.float32)}
    got = pa.adet_operator(x.to(cuda), patch.to(cuda), **draws).cpu()
    assert torch.equal(got, pa.adet_operator(x, patch, **draws))
    kw = dict(scale=1.13, angle=7.5, y0=3, x0=20)
    assert torch.equal(pa.apply_transformed_patch(x.to(cuda), patch.to(cuda), **kw).cpu(),
                       pa.apply_transformed_patch(x, patch, **kw))


def test_fitness_equals_the_cpu(cuda):
    w = torch.from_numpy((np.random.default_rng(6).standard_normal((3072, 10)) * 0.1)
                         .astype(np.float32))

    def model(dev):
        wd = w.to(dev)
        return lambda xb: xb.reshape(xb.shape[0], -1) @ wd

    def space(u8):
        return u8.to(torch.float32) / torch.tensor(255.0, device=u8.device)

    x = np.random.default_rng(7).integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    for gene in ev._GENE_COMBOS:
        if "noise" in gene[0]:
            continue
        ind = ev.Individual([gene])
        before = _lib.LAUNCHES["rgb_blur_rotate"]
        fc = ev.fitness_fn(model(cuda), space, x, ind, device="cuda")
        assert _lib.LAUNCHES["rgb_blur_rotate"] - before == (gene[0] == "blur")
        fq = ev.fitness_fn(model("cpu"), space, x, ind, device="cpu")
        assert abs(fc - fq) <= 1e-3 * abs(fq), gene
