"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips without one (the decision is made inside the fixture). The file
imports nothing of JAX, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda_kernels.py -q

Budget: 0 LSB. Both sides round every f32 operation separately.
"""

import numpy as np
import pytest
import torch

from imagetransformations_tpu_torch import OpSpec, build_chain_fn
from imagetransformations_tpu_torch.ops.hopper import megakernel as mk

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _run(imgs, device, radius, angle, gray, stream, fill):
    return mk.fused_blur_rotate_image(
        torch.from_numpy(imgs).to(device), radius, angle, fill=fill,
        grayscale_out=gray, stream=stream,
    ).cpu()


@pytest.mark.parametrize(
    "shape,radius,angle,gray,stream,fill,kernel",
    [
        ((2, 130, 48), 1.5, 15.0, True, True, 0, "luma_blur_rotate"),   # h >= 128
        ((3, 64, 48), 1.5, 15.0, True, True, 0, "luma_blur_rotate"),    # odd batch
        ((64, 32, 32), 1.5, 15.0, True, True, 0, "luma_blur_rotate_packed"),
        ((2, 70, 45), 2.5, -30.0, True, True, 255, "luma_blur_rotate_packed"),
        ((2, 64, 48), 1.5, 15.0, False, True, 0, "rgb_blur_rotate"),
        ((2, 64, 48), 1.5, 15.0, True, False, 0, "rgb_blur_rotate"),
        ((2, 64, 48), 1.0, 0.0, False, True, 0, "rgb_blur_rotate"),
        ((2, 33, 65), 0.0, -22.5, False, False, 128, "rgb_blur_rotate"),
    ],
)
def test_kernel_equals_plain(rng, cuda, shape, radius, angle, gray, stream, fill, kernel):
    imgs = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    before = mk.LAUNCHES[kernel]
    got = _run(imgs, cuda, radius, angle, gray, stream, fill)
    torch.cuda.synchronize()
    assert mk.LAUNCHES[kernel] == before + 1
    want = _run(imgs, "cpu", radius, angle, gray, stream, fill)
    assert torch.equal(got, want)


def test_packed_geometry_byte_equal_to_one_image_a_block(rng, cuda):
    x = torch.from_numpy(rng.integers(0, 256, (64, 32, 32, 3), dtype=np.uint8)).to(cuda)
    taps, p, k1, f1, k2, f2 = mk._params(32, 32, 1.5, 15.0, x.device)
    packed = mk.luma_blur_rotate(x, taps, p, k1, f1, k2, f2, 0,
                                 images_per_block=mk._images_per_block(64, 32))
    single = mk.luma_blur_rotate(x, taps, p, k1, f1, k2, f2, 0, images_per_block=1)
    assert torch.equal(packed, single)


def test_default_chain_runs_on_the_card(rng, cuda):
    imgs = rng.integers(0, 256, (2, 64, 48, 3), dtype=np.uint8)
    chain = [OpSpec("blur", {"radius": 1.5}), OpSpec("rotation", {"angle": 15.0}),
             OpSpec("grayscale")]
    out = build_chain_fn(chain)(imgs)
    assert out.device.type == "cuda"
    assert torch.equal(out.cpu(), build_chain_fn(chain, device="cpu")(imgs))
