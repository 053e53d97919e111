"""The port's corruption dispatch (``evalx.harness``) against the JAX
package's, on the CPU: the same names in the same order with the same
severity values; ``corrupt`` draws from a generator deterministically, and
passes explicit draws through to the op."""

import numpy as np
import pytest
import torch

from imagetransformations_tpu.evalx import harness as jh

from imagetransformations_tpu_torch.evalx import harness as th
from imagetransformations_tpu_torch.ops import corruptions as tc

RANDOM = ("gaussian_noise", "shot_noise", "impulse_noise", "glass_blur", "motion_blur", "snow",
          "frost", "fog", "elastic_transform", "speckle_noise", "spatter")


def test_tables_have_jax_names_order_and_severities():
    assert list(th.CORRUPTIONS) == list(jh.CORRUPTIONS)
    assert list(th.EXTRA_CORRUPTIONS) == list(jh.EXTRA_CORRUPTIONS)
    for port, jax_ in ((th.CORRUPTIONS, jh.CORRUPTIONS),
                       (th.EXTRA_CORRUPTIONS, jh.EXTRA_CORRUPTIONS)):
        for name in port:
            assert port[name][1] == jax_[name][1], name


@pytest.mark.parametrize("name", [*th.CORRUPTIONS, *th.EXTRA_CORRUPTIONS])
def test_corrupt_is_deterministic_for_a_seed(rng, name):
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 20, 24, 3), dtype=np.uint8))
    a = th.corrupt(imgs, name, 3, torch.Generator().manual_seed(11))
    b = th.corrupt(imgs, name, 3, torch.Generator().manual_seed(11))
    assert a.shape == imgs.shape and a.dtype == torch.uint8
    assert torch.equal(a, b)
    c = th.corrupt(imgs, name, 3, torch.Generator().manual_seed(12))
    assert torch.equal(a, c) == (name not in RANDOM), name


def test_corrupt_passes_explicit_draws(rng):
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8))
    size = tc.fog_size(16, 16)
    draws = torch.from_numpy(rng.uniform(-1, 1, (2, tc.plasma_levels(size), size, size))
                             .astype(np.float32))
    got = th.corrupt(imgs, "fog", 4, None, draws=draws)
    assert torch.equal(got, tc.fog(imgs, *tc.FOG_SEV[3], draws=draws))
    jit = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 2)).astype(np.float32))
    disp = torch.from_numpy(rng.uniform(-1, 1, (2, 16, 16, 2)).astype(np.float32))
    a, s, aa = tc.elastic_affine_params(16, 16, 2)
    assert torch.equal(th.corrupt(imgs, "elastic_transform", 2, None, jitter=jit, disp=disp),
                       tc.elastic_transform_affine(imgs, a, s, aa, jitter=jit, disp=disp))


@pytest.mark.parametrize("name", [*th.CORRUPTIONS, *th.EXTRA_CORRUPTIONS])
def test_numpy_draws_drive_every_corruption(rng, name):
    """The host draws fit each op's keywords: random corruptions take them
    (and then ignore the generator), deterministic ones need none."""
    imgs = rng.integers(0, 256, (2, 20, 24, 3), dtype=np.uint8)
    draws = th.numpy_draws(imgs, name, 2, rng)
    assert bool(draws) == (name in RANDOM), name
    x = torch.from_numpy(imgs)
    a = th.corrupt(x, name, 2, torch.Generator().manual_seed(1), **draws)
    b = th.corrupt(x, name, 2, torch.Generator().manual_seed(2), **draws)
    assert torch.equal(a, b) and a.shape == x.shape, name


def test_corruption_modules_run_with_jax_blocked():
    """ops (the 31 names), ops.composite, ops.corruptions, evalx.harness and
    the corrupt CLI import and run with jax and the JAX package blocked."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = """
import sys
for name in ("jax", "jaxlib", "imagetransformations_tpu"):
    sys.modules[name] = None
import tempfile
import numpy as np, torch
from imagetransformations_tpu_torch import ops
from imagetransformations_tpu_torch.ops import composite, corruptions
from imagetransformations_tpu_torch.evalx import harness
from imagetransformations_tpu_torch.__main__ import main
x = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (2, 16, 16, 3), dtype=np.uint8))
assert ops.pil_gaussian_blur(x, 1.0).shape == composite.apply_background_change(x, (0, 0, 1)).shape
for name in [*harness.CORRUPTIONS, *harness.EXTRA_CORRUPTIONS]:
    assert harness.corrupt(x, name, 5, torch.Generator().manual_seed(0)).shape == x.shape
with tempfile.TemporaryDirectory() as d:
    try:
        main(["corrupt", d, d, "--device=cpu"])
    except SystemExit as e:
        assert "no images found" in str(e)
print("ok")
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")
