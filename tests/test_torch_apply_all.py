"""The port's apply_all_transformations and its per-type ops against the JAX package.

The photometric ops (brightness, contrast, noise with an explicit draw),
the per-image blur, the integer translation and the parameter grids are
held against the JAX functions on the same numpy inputs. The sweep itself
is run with a seed on the CPU (the kernels' plain versions) and each
type's returned values are bound to its outputs per image, with the
budgets of tests/test_models_pipeline.py. The JAX sweep is not run here:
its fused CPU compile is slow, and its draws differ from the port's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagetransformations_tpu import ops as jops
from imagetransformations_tpu.core import grids as jgrids
from imagetransformations_tpu.oracle import fast_warp as ofw
from imagetransformations_tpu.oracle import warp as oww
from imagetransformations_tpu.ops import elementwise as jew
from imagetransformations_tpu.ops import noise as jnz
from imagetransformations_tpu.ops import stencil as jst
from imagetransformations_tpu.pipeline.batch import _translate_dynamic as j_translate

import imagetransformations_tpu_torch as port
from imagetransformations_tpu_torch.core import grids as tgrids
from imagetransformations_tpu_torch.core import image as timg
from imagetransformations_tpu_torch.ops import elementwise as tew
from imagetransformations_tpu_torch.ops import noise as tnz
from imagetransformations_tpu_torch.ops import stencil as tst
from imagetransformations_tpu_torch.pipeline import batch as tbatch


def _grid(name):
    return jgrids.PARAM_GRIDS[name].values()


def _draw(rng, name, n):
    return rng.choice(_grid(name), n).astype(np.float32)


# ---------------------------------------------------------------- grids


def test_param_grids_equal_jax():
    assert list(port.PARAM_GRIDS) == list(jgrids.PARAM_GRIDS)
    for name, grid in port.PARAM_GRIDS.items():
        assert grid == tgrids.ParamGrid(**vars(jgrids.PARAM_GRIDS[name]))
        assert np.array_equal(grid.values(), jgrids.PARAM_GRIDS[name].values())


def test_sample_params_draws_grid_values_per_seed():
    for name in port.PARAM_GRIDS:
        v = tgrids.sample_params(torch.Generator().manual_seed(5), name, 64)
        assert v.shape == (64,) and v.dtype == torch.float32
        assert np.isin(v.numpy(), _grid(name)).all()
        again = tgrids.sample_params(torch.Generator().manual_seed(5), name, 64)
        assert torch.equal(v, again)
    assert len(set(tgrids.sample_params(torch.Generator().manual_seed(0), "blur", 256)
                   .tolist())) == len(_grid("blur"))


# ---------------------------------------------------------------- ops


def test_core_float_helpers_match_jax():
    from imagetransformations_tpu.core import image as jimg

    v = np.array([-3.5, 0.5, 1.5, 2.5, 254.5, 255.5, 300.0], np.float32)
    for mode in ("trunc", "rint"):
        got = timg.finalize(torch.from_numpy(v), torch.uint8, mode).numpy()
        assert np.array_equal(got, np.asarray(jimg.finalize(jnp.asarray(v), jnp.uint8, mode)))
    assert torch.equal(timg.finalize(torch.from_numpy(v), torch.float32), torch.from_numpy(v))
    u = torch.arange(4, dtype=torch.uint8)
    assert timg.as_float(u).dtype == torch.float32
    f = torch.zeros(3)
    assert timg.as_float(f) is f


@pytest.mark.parametrize("shape", [(4, 32, 32, 3), (3, 48, 40, 3)])
def test_brightness_and_contrast_match_jax(rng, shape):
    imgs = rng.integers(0, 256, shape, dtype=np.uint8)
    f, a = _draw(rng, "lighten_darken", shape[0]), _draw(rng, "contrast", shape[0])
    got = tew.apply_brightness(torch.from_numpy(imgs), torch.from_numpy(f)).numpy()
    assert np.array_equal(got, np.asarray(jew.apply_brightness(jnp.asarray(imgs), jnp.asarray(f))))
    got = tew.apply_contrast(torch.from_numpy(imgs), torch.from_numpy(a)).numpy()
    assert np.array_equal(got, np.asarray(jew.apply_contrast(jnp.asarray(imgs), jnp.asarray(a))))
    # a python scalar and an HWC image take the same arithmetic
    one = tew.apply_brightness(torch.from_numpy(imgs[0]), 0.03).numpy()
    assert np.array_equal(one, np.asarray(jew.apply_brightness(jnp.asarray(imgs[0]), 0.03)))


@pytest.mark.parametrize("shape", [(4, 32, 32, 3), (2, 40, 56, 3)])
def test_gaussian_noise_with_explicit_draw_matches_jax(rng, shape):
    imgs = rng.integers(0, 256, shape, dtype=np.uint8)
    noise = rng.standard_normal(shape).astype(np.float32)
    std = _draw(rng, "gaussian_noise", shape[0])
    got = tnz.apply_gaussian_noise(torch.from_numpy(imgs), torch.from_numpy(std),
                                   noise=torch.from_numpy(noise)).numpy()
    want = np.asarray(jnz.apply_gaussian_noise(jnp.asarray(imgs), jnp.asarray(std),
                                               noise=jnp.asarray(noise)))
    assert np.array_equal(got, want)


def test_gaussian_noise_from_a_generator_is_deterministic(rng):
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 24, 20, 3), dtype=np.uint8))
    a = tnz.apply_gaussian_noise(imgs, 0.05, generator=torch.Generator().manual_seed(1))
    b = tnz.apply_gaussian_noise(imgs, 0.05, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, imgs)


def test_blur_taps_batched_within_two_ulps_of_jax():
    """The port takes exp in f64 rounded to f32 (the same on every device);
    XLA's f32 exp differs from that by an ulp on a few arguments, which the
    normalisation can carry to 2 ulps of a tap."""
    radii = _grid("blur")
    got = tst.blur_taps_batched(torch.from_numpy(radii)).numpy()
    want = np.asarray(jst.blur_taps_batched(jnp.asarray(radii)))
    assert got.shape == want.shape == (len(radii), tst.MAX_BLUR_KSIZE)
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 2
    assert np.array_equal(got == 0, want == 0)
    assert np.array_equal(got[0], want[0])  # radius 0: the delta row


@pytest.mark.parametrize("shape", [(8, 40, 36, 3), (4, 32, 32, 3), (3, 17, 20, 3)])
def test_blur_batched_matches_jax(rng, shape):
    imgs = rng.integers(0, 256, shape, dtype=np.uint8)
    radii = _draw(rng, "blur", shape[0])
    got = tst.apply_blur(torch.from_numpy(imgs), torch.from_numpy(radii)).numpy()
    want = np.asarray(jst._blur_batched(jnp.asarray(imgs), jnp.asarray(radii)))
    err = np.abs(got.astype(int) - want.astype(int))
    assert err.max() <= 1 and (err > 0).mean() <= 0.001, (err.max(), (err > 0).mean())


@pytest.mark.parametrize("radius", [0.0, 0.5, 1.5, 3.0])
def test_gaussian_blur_static_matches_jax(rng, radius):
    imgs = rng.integers(0, 256, (2, 40, 36, 3), dtype=np.uint8)
    got = tst.apply_blur(torch.from_numpy(imgs), radius).numpy()
    want = np.asarray(jst.apply_blur(jnp.asarray(imgs), radius))
    err = np.abs(got.astype(int) - want.astype(int))
    assert err.max() <= 1 and (err > 0).mean() <= 0.001, (err.max(), (err > 0).mean())


def test_translate_dynamic_matches_jax(rng):
    imgs = rng.integers(0, 256, (5, 32, 36, 3), dtype=np.uint8)
    vals = np.asarray([-35.0, 0.0, 12.7, 50.0, -3.2], np.float32)
    got = tbatch._translate_dynamic(torch.from_numpy(imgs), torch.from_numpy(vals), 50).numpy()
    want = np.asarray(j_translate(jnp.asarray(imgs), jnp.asarray(vals), 50))
    assert np.array_equal(got, want)
    ref = np.concatenate([np.asarray(jops.apply_translation(imgs[i : i + 1], float(v)))
                          for i, v in enumerate(vals)])
    assert np.array_equal(got, ref)


# ---------------------------------------------------------------- the sweep


@pytest.fixture(scope="module")
def sweep():
    imgs = np.random.default_rng(7).integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    return imgs, port.apply_all_transformations(imgs, 3, device="cpu")


def test_apply_all_keys_shapes_dtypes(sweep):
    imgs, res = sweep
    assert set(res) == set(tbatch.TYPES) == {
        "scale", "rotation", "lighten_darken", "gaussian_noise", "translation", "contrast",
        "blur", "shear",
    }
    for t, (vals, out) in res.items():
        assert vals.shape == (4,) and vals.dtype == torch.float32, t
        assert np.isin(vals.numpy(), _grid("lighten_darken" if t == "lighten_darken" else t)).all()
        assert out.shape == imgs.shape and out.dtype == torch.uint8, t
        assert out.device.type == "cpu"


def _per_image(res, t, fn, max_lsb=0, max_flip=0.0):
    vals, out = res[t]
    vals, out = vals.numpy(), out.numpy().astype(int)
    ref = np.concatenate([np.asarray(fn(i, float(vals[i]))) for i in range(len(vals))])
    err = np.abs(out - ref.astype(int))
    assert err.max() <= max_lsb, (t, err.max())
    assert (err > 0).mean() <= max_flip, (t, (err > 0).mean())


@pytest.mark.parametrize(
    "t",
    ["lighten_darken", "contrast", "blur", "translation", "rotation", "scale"],
)
def test_apply_all_values_bind_to_outputs_exactly(sweep, t):
    """Each type's (values, out) equals that op applied per image with those
    values (the JAX package's ops or oracles): 0 LSB. The blur is the JAX
    per-image blur with the sweep's own (batched, f32-exp) taps."""
    imgs, res = sweep
    x = jnp.asarray(imgs)
    fns = {
        "lighten_darken": lambda i, v: jops.apply_brightness(x[i : i + 1], v),
        "contrast": lambda i, v: jops.apply_contrast(x[i : i + 1], v),
        "blur": lambda i, v: jops.apply_blur(x[i : i + 1], jnp.asarray([v], jnp.float32)),
        "translation": lambda i, v: jops.apply_translation(x[i : i + 1], v),
        # per-op u8 quantization, as the JAX sweep's default rotation
        "rotation": lambda i, v: ofw.rotate_3shear(imgs[i : i + 1], v),
        "scale": lambda i, v: oww.apply_scale(imgs[i], v)[None],
    }
    _per_image(res, t, fns[t])


def test_apply_all_blur_binds_to_the_static_blur(sweep):
    """Against the one-radius blur (host f64 taps cast to f32) the batched
    f32-exp taps may flip a rounding boundary: <= 1 LSB on <= 0.1%. The JAX
    sweep's own blur differs from it the same way (r = 4.0 here)."""
    imgs, res = sweep
    x = jnp.asarray(imgs)
    _per_image(res, "blur", lambda i, v: jops.apply_blur(x[i : i + 1], v),
               max_lsb=1, max_flip=0.001)


def test_apply_all_shear_binds_within_f64_budget(sweep):
    """BICUBIC canvas crop: numpy f64 Horner against device f32 flips
    truncation boundaries by 1 LSB (<= 2.5%)."""
    imgs, res = sweep
    _per_image(res, "shear", lambda i, v: oww.apply_shear(imgs[i], v)[None, :, :32],
               max_lsb=1, max_flip=0.025)


def test_apply_all_noise_is_deterministic_and_changes_the_image(sweep):
    imgs, res = sweep
    again = port.apply_all_transformations(imgs, torch.Generator().manual_seed(3), device="cpu")
    assert torch.equal(res["gaussian_noise"][1], again["gaussian_noise"][1])
    assert torch.equal(res["gaussian_noise"][0], again["gaussian_noise"][0])
    assert not np.array_equal(res["gaussian_noise"][1].numpy(), imgs)
    other = port.apply_all_transformations(imgs, 4, types=("gaussian_noise",), device="cpu")
    assert not torch.equal(res["gaussian_noise"][1], other["gaussian_noise"][1])


def test_apply_all_fused_flag_and_types_subset(sweep):
    imgs, res = sweep
    split = port.apply_all_transformations(torch.from_numpy(imgs), 3, fused=False, device="cpu")
    for t in res:
        assert torch.equal(res[t][0], split[t][0]) and torch.equal(res[t][1], split[t][1]), t
    sub = port.apply_all_transformations(imgs, 3, types=("blur", "contrast"), device="cpu")
    assert set(sub) == {"blur", "contrast"}
    with pytest.raises(KeyError):  # no grid to draw from, as in the JAX package
        port.apply_all_transformations(imgs, 3, types=("unknown",), device="cpu")


@pytest.mark.parametrize(
    "kwargs,item",
    [({"pil_parity_scale_shear": False}, "B.9"), ({"pil_parity_rotation": True}, "B.12")],
)
def test_apply_all_unported_flags_raise(kwargs, item):
    """The non-default flags (kernels B.9 + B.10, B.12) run: all 8 types, in
    shape, on the CPU; the types they change differ from the default
    sweep's and the others do not (tests/test_torch_apply_all_fast.py holds
    the values against the JAX package)."""
    imgs = np.random.default_rng(5).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    res = port.apply_all_transformations(imgs, 0, device="cpu", **kwargs)
    dflt = port.apply_all_transformations(imgs, 0, device="cpu")
    changed = {"B.9": {"scale", "shear"}, "B.12": {"rotation"}}[item]
    assert set(res) == set(tbatch.TYPES)
    for t, (vals, out) in res.items():
        assert out.shape == imgs.shape and out.dtype == torch.uint8
        assert torch.equal(vals, dflt[t][0])
        assert torch.equal(out, dflt[t][1]) == (t not in changed), t


def test_apply_all_unported_branches_raise():
    """The fast shear branch and the per-grid-value sweep run: the fast
    shear of factor 0 is the identity (shift 0 in every row), and the
    sweep over (0.0,) is apply_shear(0)[:, :, :w], also the identity."""
    x = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (2, 32, 32, 3),
                                                            dtype=np.uint8))
    v = torch.zeros(2)
    assert torch.equal(tbatch._BATCHED_OPS["shear"](x, v, None), x)
    assert torch.equal(tbatch._value_sweep_per_value(x, v, "shear", (0.0,)), x)
    assert torch.equal(tbatch._BATCHED_OPS["scale"](x, torch.ones(2), None), x)


def test_apply_all_default_device_is_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    imgs = np.zeros((2, 32, 32, 3), np.uint8)
    with pytest.raises(RuntimeError, match="CUDA"):
        port.apply_all_transformations(imgs, 0)
    with pytest.raises(ValueError):
        port.apply_all_transformations(imgs[0], 0, device="cpu")  # HWC
