"""The corruption generators on the card: the same bytes as the CPU path
with the same draws, and the same bytes with TF32 allowed as without.

PyTorch lets cuDNN run f32 convolutions in TF32 by default
(``torch.backends.cudnn.allow_tf32``), and a user may also allow it for
matrix products. The generators' convolutions and DCTs are written as
ordered f32 multiply-adds, so neither flag may change an output. Every
corruption of ``evalx.harness`` runs at severities 1 and 5 on 8x32x32x3
with numpy draws (``harness.numpy_draws``); ``rotation`` must launch the
NEAREST rotation kernel.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips without one (decided inside the fixture). No JAX is imported:

    python -m pytest tests/test_torch_cuda_corruptions.py -q
"""

import numpy as np
import pytest
import torch

from imagetransformations_tpu_torch.evalx import harness as hs
from imagetransformations_tpu_torch.ops.hopper import _lib

pytestmark = pytest.mark.cuda

NAMES = [*hs.CORRUPTIONS, *hs.EXTRA_CORRUPTIONS]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card path runs only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("sev", [1, 5])
@pytest.mark.parametrize("name", NAMES)
def test_card_equals_cpu_and_ignores_tf32(cuda, name, sev):
    rng = np.random.default_rng([7, NAMES.index(name), sev])
    imgs = rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    draws = hs.numpy_draws(imgs, name, sev, rng)
    cpu = hs.corrupt(torch.from_numpy(imgs), name, sev, None,
                     **{k: torch.from_numpy(v) for k, v in draws.items()})
    x = torch.from_numpy(imgs).to(cuda)
    dd = {k: torch.from_numpy(v).to(cuda) for k, v in draws.items()}
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    outs = {}
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            torch.backends.cudnn.allow_tf32 = tf32
            _lib.LAUNCHES["pil_rotate_nearest"] = 0
            outs[tf32] = hs.corrupt(x, name, sev, None, **dd).cpu()
            if name == "rotation":
                assert _lib.LAUNCHES["pil_rotate_nearest"] == 1
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    assert torch.equal(outs[True], outs[False]), "TF32 changed the output"
    d = (outs[False].to(torch.int16) - cpu.to(torch.int16)).abs()
    assert int(d.max()) <= 1, (name, sev, int(d.max()))
