"""The port's apply_all_transformations with its non-default flags.

``pil_parity_scale_shear=False`` draws scale from the bilinear zoom (kernel
#10) and shear from the row-shift shear (kernel #9);
``pil_parity_rotation=True`` draws rotation from the PIL NEAREST rotation
(kernel #12). The sweep runs with a seed on the CPU (the kernels' plain
versions); each of those types is held, on the values the sweep drew,
against the JAX functions the JAX sweep runs for it (``_zoom_fast``,
``_shear_fast_batched``, ``pil_rotate_nearest_batched``) and against exact
numpy references; the other five types equal the default-flag sweep's.
The sweep's shear by drawn index (``_shear_pil``) is held against JAX's
per-grid-value sweep, and the PIL rotation at a grid beyond 45 degrees
against the JAX function and PIL itself (0 LSB).
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from imagetransformations_tpu.oracle import fast_warp as ofw
from imagetransformations_tpu.ops.pallas import rotate_gather as jrg
from imagetransformations_tpu.pipeline import batch as jbatch

import imagetransformations_tpu_torch as port
from imagetransformations_tpu_torch.ops import warp as twp
from imagetransformations_tpu_torch.pipeline import batch as tbatch

FLAGS = {
    "fast": {"pil_parity_scale_shear": False},
    "pil_rotation": {"pil_parity_rotation": True},
    "both": {"pil_parity_scale_shear": False, "pil_parity_rotation": True},
}
SEED = 3


@pytest.fixture(scope="module")
def imgs():
    return np.random.default_rng(7).integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def default_sweep(imgs):
    return port.apply_all_transformations(imgs, SEED, device="cpu")


@pytest.fixture(scope="module")
def sweeps(imgs):
    """The sweep under each flag set, run once a module."""
    return {name: port.apply_all_transformations(imgs, SEED, device="cpu", **flags)
            for name, flags in FLAGS.items()}


def _lsb(a, b):
    err = np.abs(np.asarray(a).astype(int) - np.asarray(b).astype(int))
    return err.max(), (err > 0).mean()


def _changed(flags):
    changed = set()
    if not flags.get("pil_parity_scale_shear", True):
        changed |= {"scale", "shear"}
    if flags.get("pil_parity_rotation", False):
        changed.add("rotation")
    return changed


@pytest.mark.parametrize("name", sorted(FLAGS))
def test_every_flag_combination_returns_all_8_types(sweeps, default_sweep, imgs, name):
    """Same keys, draws, shapes and dtypes as the default sweep; the types
    the flags do not touch give the default sweep's bits (the draws come
    in the same order), the ones they touch differ from it."""
    res = sweeps[name]
    assert set(res) == set(tbatch.TYPES)
    changed = _changed(FLAGS[name])
    for t, (values, out) in res.items():
        assert torch.equal(values, default_sweep[t][0]), t
        assert out.shape == imgs.shape and out.dtype == torch.uint8, t
        assert torch.equal(out, default_sweep[t][1]) == (t not in changed), t


@pytest.mark.parametrize("name", ["fast", "both"])
def test_fast_scale_binds_to_the_jax_zoom(sweeps, imgs, name):
    """Against JAX ``_zoom_fast`` on the drawn factors <= 1 LSB on <= 1% of
    values (XLA-CPU FMA in the coordinates); against random_zoom's
    bilinear warp route in the port 0 LSB."""
    values, out = sweeps[name]["scale"]
    want = np.asarray(jbatch._zoom_fast(jnp.asarray(imgs), jnp.asarray(values.numpy())))
    lsb, frac = _lsb(out.numpy(), want)
    assert lsb <= 1 and frac <= 0.01, (lsb, frac)
    warp = twp.affine_warp(torch.from_numpy(imgs), twp.zoom_matrix(values, 32, 32),
                           method="bilinear")
    assert torch.equal(out, warp)


@pytest.mark.parametrize("name", ["fast", "both"])
def test_fast_shear_binds_to_the_jax_shear(sweeps, imgs, name):
    """0 LSB against the numpy oracle ``fast_warp.shear_rows`` on the
    shifts in unfused f32 (numpy); against JAX ``_shear_fast_batched`` on
    the drawn factors <= 1 LSB on <= 2.5% of values: XLA-CPU fuses
    ``v*y - ceil(v*h)`` and the kernel's lerp into FMAs, which moves
    decimal factors' shifts by an ulp and flips truncations (1.9% of
    values for this draw)."""
    values, out = sweeps[name]["shear"]
    v = values.numpy().reshape(-1, 1)
    y = (np.arange(32, dtype=np.float32) + np.float32(0.5)).reshape(1, 32)
    shifts = v * y - np.where(v > 0, np.ceil(v * np.float32(32)), np.float32(0.0))
    assert np.array_equal(tbatch.fast_shear_shifts(values, 32, torch.device("cpu")).numpy(),
                          shifts)
    ref = np.concatenate([ofw.shear_rows(imgs[i : i + 1], shifts[i], fill=255)
                          for i in range(len(imgs))])
    assert np.array_equal(out.numpy(), ref)
    want = np.asarray(jbatch._shear_fast_batched(jnp.asarray(imgs), jnp.asarray(v[:, 0]), 1.0))
    lsb, frac = _lsb(out.numpy(), want)
    assert lsb <= 1 and frac <= 0.025, (lsb, frac)


@pytest.mark.parametrize("name", ["pil_rotation", "both"])
def test_pil_rotation_binds_to_the_jax_kernel(sweeps, imgs, name):
    """Against JAX ``pil_rotate_nearest_batched`` (the budget the JAX sweep
    gives it, max |grid| + 0.5) on the drawn angles: <= 0.5% of pixels in
    each image."""
    values, out = sweeps[name]["rotation"]
    want = np.asarray(jrg.pil_rotate_nearest_batched(
        jnp.asarray(imgs), jnp.asarray(values.numpy()), max_angle_deg=23.0))
    for i in range(len(imgs)):
        assert (out.numpy()[i] != want[i]).any(-1).mean() <= 0.005, i


def test_value_sweep_shear_matches_jax(rng):
    """The sweep's shear (``_shear_pil``: each image by its drawn index into
    the shear grid) gives each image apply_shear(v)[:, :, :w] of its own
    grid value: <= 1 LSB on <= 2.5% of values against JAX's per-grid-value
    sweep (the BICUBIC shear budget of tests/test_torch_apply_all.py)."""
    imgs = rng.integers(0, 256, (6, 24, 20, 3), dtype=np.uint8)
    vals = np.asarray([0.3, 0.0, 0.7, 0.3, 0.7, 0.0], np.float32)
    grid = (0.0, 0.3, 0.7)
    idx = torch.tensor([3, 0, 7, 3, 7, 0])  # positions in the shear grid 0:0.1:1
    out = tbatch._shear_pil(torch.from_numpy(imgs), idx, torch.from_numpy(vals)).numpy()
    want = np.asarray(jbatch._value_sweep_per_value(jnp.asarray(imgs), jnp.asarray(vals),
                                                    "shear", grid))
    lsb, frac = _lsb(out, want)
    assert lsb <= 1 and frac <= 0.025, (lsb, frac)
    one = port.apply_shear(torch.from_numpy(imgs[2:3]), 0.7)[:, :, :20]
    assert torch.equal(torch.from_numpy(out[2:3]), one)


def test_value_sweep_rotation_beyond_45_matches_jax(rng):
    """A rotation grid with 60 degrees runs the PIL rotation kernel like
    any other: PIL's rotate(-v) of each image's value at 0 LSB; against the
    JAX per-value sweep (its kernel within 45 degrees, its f32 warp beyond)
    <= 0.5% of pixels in each image for |v| <= 45, <= 2.5% beyond (ROADMAP
    C.2.9). The per-value route takes scale and PIL rotation only."""
    imgs = rng.integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    vals = np.asarray([60.0, -22.5, 15.0, 0.0, 60.0, -22.5], np.float32)
    grid = (-22.5, 0.0, 15.0, 60.0)
    idx = torch.tensor([grid.index(float(v)) for v in vals])
    out = tbatch._rotation_pil(torch.from_numpy(imgs), idx, grid).numpy()
    want = np.asarray(jbatch._value_sweep_per_value(jnp.asarray(imgs), jnp.asarray(vals),
                                                    "rotation_pil", grid))
    for i, v in enumerate(vals):
        pil = np.asarray(Image.fromarray(imgs[i]).rotate(-float(v)))
        np.testing.assert_array_equal(out[i], pil, err_msg=str(v))
        assert (out[i] != want[i]).any(-1).mean() <= (0.005 if abs(v) <= 45 else 0.025), i
    for t in ("shear", "blur"):
        with pytest.raises(ValueError):
            tbatch._apply_per_value(torch.from_numpy(imgs), t, torch.from_numpy(vals))


def test_apply_per_value_routes_grids_beyond_the_kernels(rng, monkeypatch):
    """A rotation grid beyond 45 degrees takes the PIL rotation kernel like
    the default grid; the sweep's shear takes its own route
    (``_shear_pil``), which the per-value route refuses."""
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 16, 16, 3), dtype=np.uint8))
    assert torch.equal(tbatch._apply_per_value(imgs, "rotation_pil", torch.zeros(2)), imgs)
    monkeypatch.setattr(tbatch, "_grid", lambda name: (-60.0, 0.0, 60.0))
    out = tbatch._apply_per_value(imgs, "rotation_pil", torch.tensor([60.0, -60.0]))
    assert torch.equal(out, tbatch.rg.pil_rotate_nearest_batched(imgs, [60.0, -60.0]))
    with pytest.raises(ValueError):
        tbatch._apply_per_value(imgs, "shear", torch.zeros(2))
