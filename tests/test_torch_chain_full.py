"""The port's whole ``build_chain_fn`` against the JAX ``build_chain_fn``.

Both take the same numpy batch and the same chain; the port runs on the CPU
(device="cpu": the kernels' plain versions), the JAX package on its CPU
backend (Pallas in interpret mode). Covered: strict parity (a port of the
JAX package's strict-parity fuzz and sequential-ops tests), every op name
of ``_apply_simple``, single affine ops and affine runs in each warp method,
rotations beyond 45 degrees, HWC and float32 input, tiny images, and the
noise ops' generator. Each chain is also held equal to the plain
composition of the port's own ops.

Budgets against JAX: 0 LSB where both sides round alike; <= 1 LSB on <= 1%
of values where XLA-CPU contracts an FMA the port rounds as two operations
(``enhance_*``, ``sharpness``, the zoom's coordinates) or where the rotation
matrix's f32 cos / sin differ by an ulp between XLA and PyTorch, and on
<= 0.1% for the fused stream kernels (tests/test_torch_chain.py). Float32
chains: 2e-3 on the [0, 255] scale. Noise: the two packages draw different
numbers, so the noise ops are held to their own ops with the same
generator.
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from imagetransformations_tpu.pipeline import chain as jchain

from imagetransformations_tpu_torch.ops import elementwise as ew
from imagetransformations_tpu_torch.ops import histogram as hg
from imagetransformations_tpu_torch.ops import noise as nz
from imagetransformations_tpu_torch.ops import stencil as st
from imagetransformations_tpu_torch.ops import warp as wp
from imagetransformations_tpu_torch.ops.hopper import blur as tblur
from imagetransformations_tpu_torch.ops.hopper import megakernel as mk
from imagetransformations_tpu_torch.pipeline import chain as tchain

#: the 20 op names of the JAX _apply_simple (chain.py:65-109) with a value
SIMPLE = {
    "brightness": {"factor": 0.05},
    "lighten_darken": {"factor": -0.05},
    "contrast": {"alpha": 1.2},
    "grayscale": {},
    "invert": {},
    "enhance_contrast": {"factor": 1.3},
    "enhance_color": {"factor": 0.6},
    "sharpness": {"factor": 1.5},
    "blur": {"radius": 1.5},
    "motion_blur": {"ksize": 5},
    "gaussian_noise": {"std": 0.05},
    "impulse_noise": {"amount": 0.1},
    "shot_noise": {"lam": 10.0},
    "histogram_equalization": {},
    "scale": {"factor": 1.1},
    "shear": {"factor": 0.2},
    "rotation": {"angle": 60.0},
    "translation": {"tx": 2.7, "ty": -3},
    "zoom": {"factor": 1.3},
    "flip_vertical": {},
}
NOISE = {"gaussian_noise", "impulse_noise", "shot_noise"}
#: ops whose JAX form XLA-CPU contracts, or whose f32 matrix differs by an ulp
LOOSE = {"enhance_contrast", "enhance_color", "sharpness", "zoom", "rotation", "blur"}

#: the port's own op for each name, as the strict chain applies it
PORT_OP = {
    "brightness": lambda x, p: ew.apply_brightness(x, p["factor"]),
    "lighten_darken": lambda x, p: ew.apply_brightness(x, p["factor"]),
    "contrast": lambda x, p: ew.apply_contrast(x, p["alpha"]),
    "grayscale": lambda x, p: ew.grayscale(x),
    "invert": lambda x, p: ew.invert(x),
    "enhance_contrast": lambda x, p: ew.enhance_contrast(x, p["factor"]),
    "enhance_color": lambda x, p: ew.enhance_color(x, p["factor"]),
    "sharpness": lambda x, p: st.sharpen(x, p["factor"]),
    "blur": lambda x, p: st.apply_blur(x, p["radius"]),
    "motion_blur": lambda x, p: st.motion_blur(x, p["ksize"]),
    "histogram_equalization": lambda x, p: hg.histogram_equalization(x),
    "scale": lambda x, p: wp.apply_scale(x, p["factor"]),
    "shear": lambda x, p: wp.apply_shear(x, p["factor"]),
    "rotation": lambda x, p: wp.apply_rotation(x, p["angle"]),
    "translation": lambda x, p: wp.apply_translation(x, p["tx"], p.get("ty", p["tx"])),
    "zoom": lambda x, p: wp.random_zoom(x, p["factor"]),
    "flip_vertical": lambda x, p: wp.flip_vertical(x),
}


def _port(ops, x, **kw):
    gen = kw.pop("generator", None)
    fn = tchain.build_chain_fn([tchain.OpSpec(n, dict(p)) for n, p in ops], device="cpu", **kw)
    return fn(x, gen) if gen is not None else fn(x)


def _jax(ops, x, **kw):
    fn = jchain.build_chain_fn([jchain.OpSpec(n, dict(p)) for n, p in ops], **kw)
    return np.asarray(fn(jnp.asarray(x)))


def _err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, a.dtype, b.shape, b.dtype)
    e = np.abs(a.astype(np.float64) - b.astype(np.float64))
    return float(e.max()), float((e > 0).mean())


def _close(out, want, loose, frac=0.01):
    lsb, share = _err(out, want)
    if loose:
        assert lsb <= 1 and share <= frac, (lsb, share)
    else:
        assert lsb == 0, (lsb, share)


@pytest.fixture
def imgs(rng):
    return rng.integers(0, 256, (2, 24, 20, 3), dtype=np.uint8)


# ---------------------------------------------------------------- every op name


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("name", sorted(set(SIMPLE) - NOISE))
def test_every_op_matches_jax_and_its_own_op(imgs, name, strict):
    ops = [(name, SIMPLE[name])]
    out = _port(ops, imgs, strict_parity=strict).numpy()
    _close(out, _jax(ops, imgs, strict_parity=strict), name in LOOSE)
    if strict:
        own = PORT_OP[name](torch.from_numpy(imgs), SIMPLE[name]).numpy()
        np.testing.assert_array_equal(out, own)


@pytest.mark.parametrize("name", sorted(set(SIMPLE) - NOISE))
def test_every_op_on_hwc_input(imgs, name):
    """HWC goes op by op. Where the JAX chain crashes (a static blur of a
    u8 HWC image: blur_separable unpacks four dims) the port blurs it as a
    batch of one."""
    ops = [(name, SIMPLE[name])]
    out = _port(ops, imgs[0]).numpy()
    if name == "blur":
        with pytest.raises(ValueError):
            _jax(ops, imgs[0])
        np.testing.assert_array_equal(out, tblur.blur_separable(torch.from_numpy(imgs[:1]),
                                                                1.5).numpy()[0])
        return
    _close(out, _jax(ops, imgs[0]), name in LOOSE)


@pytest.mark.parametrize("name", sorted(set(SIMPLE) - NOISE))
def test_every_op_on_float_input(rng, name):
    x = (rng.random((2, 24, 20, 3)) * 255).astype(np.float32)
    ops = [(name, SIMPLE[name])]
    out = _port(ops, x).numpy()
    want = _jax(ops, x)
    assert out.dtype == want.dtype == np.float32
    assert _err(out, want)[0] <= 2e-3


@pytest.mark.parametrize("name", sorted(NOISE))
def test_noise_ops_draw_from_the_generator(imgs, name):
    ops = [(name, SIMPLE[name])]
    x = torch.from_numpy(imgs)
    a = _port(ops, imgs, generator=torch.Generator().manual_seed(4))
    b = _port(ops, imgs, generator=torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and a.shape == x.shape and not torch.equal(a, x)
    p, g = SIMPLE[name], torch.Generator().manual_seed(4)
    own = {"gaussian_noise": lambda: nz.apply_gaussian_noise(x, p["std"], generator=g),
           "impulse_noise": lambda: nz.impulse_noise(x, p["amount"], generator=g),
           "shot_noise": lambda: nz.shot_noise(x, p["lam"], generator=g)}[name]()
    assert torch.equal(a, own)
    with pytest.raises(ValueError, match="Generator"):
        _port(ops, imgs)
    with pytest.raises(Exception):
        _jax(ops, imgs)  # the JAX chain cannot draw without a key either


def test_noise_draws_follow_chain_order(imgs):
    ops = [("impulse_noise", {"amount": 0.1}), ("gaussian_noise", {"std": 0.05})]
    out = _port(ops, imgs, generator=torch.Generator().manual_seed(9))
    g = torch.Generator().manual_seed(9)
    want = nz.apply_gaussian_noise(nz.impulse_noise(torch.from_numpy(imgs), 0.1, generator=g),
                                   0.05, generator=g)
    assert torch.equal(out, want)


def test_unknown_op_raises_at_call(imgs):
    fn = tchain.build_chain_fn([tchain.OpSpec("sepia")], device="cpu")
    with pytest.raises(ValueError, match="sepia"):
        fn(imgs)


# ---------------------------------------------------------------- strict parity


STRICT_POOL = {
    "brightness": ("factor", [0.05, -0.1]),
    "contrast": ("alpha", [0.8, 1.2]),
    "blur": ("radius", [0.0, 1.0, 2.5]),
    "rotation": ("angle", [0.0, 15.0, -30.0]),
    "grayscale": (None, [None]),
    "invert": (None, [None]),
    "sharpness": ("factor", [1.5]),
    "zoom": ("factor", [1.2]),
    "translation": ("tx", [6.0]),
}


@pytest.mark.parametrize("trial", range(6))
def test_chain_strict_parity_fuzz(rng, trial):
    """tests/test_models_pipeline.py:697 for the port: random strict chains
    equal the port's ops applied one after another (0 LSB) and the JAX
    strict chain: 0 LSB without a loose op; with one, <= 1% of values
    differ, by <= 3 LSB (measured, trial 0: the zoom's 1-LSB FMA flips on
    0.49% of values, grown to 3 LSB by contrast 1.2 then brightness)."""
    imgs = rng.integers(0, 256, (2, 40, 48, 3), dtype=np.uint8)
    names = list(STRICT_POOL)
    k = np.random.default_rng(100 + trial)
    ops = []
    for _ in range(int(k.integers(2, 5))):
        name = names[int(k.integers(len(names)))]
        pk, vals = STRICT_POOL[name]
        v = vals[int(k.integers(len(vals)))]
        ops.append((name, {} if pk is None else ({"tx": v, "ty": v} if pk == "tx" else {pk: v})))
    out = _port(ops, imgs, strict_parity=True).numpy()
    ref = torch.from_numpy(imgs)
    for name, p in ops:
        ref = PORT_OP[name](ref, p)
    np.testing.assert_array_equal(out, ref.numpy(), err_msg=str(ops))
    lsb, share = _err(out, _jax(ops, imgs, strict_parity=True))
    if any(n in LOOSE for n, _ in ops):
        assert lsb <= 3 and share <= 0.01, (ops, lsb, share)
    else:
        assert lsb == 0, (ops, lsb, share)


def test_chain_strict_parity_matches_sequential_ops(rng):
    """tests/test_models_pipeline.py:91 for the port, and against JAX."""
    imgs = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    ops = [("brightness", {"factor": 0.05}), ("contrast", {"alpha": 0.8}),
           ("blur", {"radius": 1.0})]
    out = _port(ops, imgs, strict_parity=True).numpy()
    x = torch.from_numpy(imgs)
    ref = st.apply_blur(ew.apply_contrast(ew.apply_brightness(x, 0.05), 0.8), 1.0)
    np.testing.assert_array_equal(out, ref.numpy())
    np.testing.assert_array_equal(out, _jax(ops, imgs, strict_parity=True))


# ---------------------------------------------------------------- affine runs


def test_chain_single_affine_ops_match_dedicated_paths(imgs):
    """tests/test_megakernel.py:136 for the port: flip, static translation
    and static zoom run their own ops."""
    x = torch.from_numpy(imgs)
    np.testing.assert_array_equal(_port([("flip_vertical", {})], imgs).numpy(), imgs[:, ::-1])
    assert torch.equal(_port([("translation", {"tx": 7})], imgs), wp.apply_translation(x, 7, 7))
    assert torch.equal(_port([("zoom", {"factor": 1.2})], imgs), wp.random_zoom(x, 1.2))


RUNS = {
    "translation>zoom": [("translation", {"tx": 6}), ("zoom", {"factor": 1.3})],
    "rotation>translation": [("rotation", {"angle": 10.0}), ("translation", {"tx": 3, "ty": -2})],
    "zoom>flip>rotation": [("zoom", {"factor": 0.8}), ("flip_vertical", {}),
                           ("rotation", {"angle": -20.0})],
    "rotation(60)": [("rotation", {"angle": 60.0})],
    "rotation(np.float32 60)": [("rotation", {"angle": np.float32(60.0)})],
    "rotation([5, -50])": [("rotation", {"angle": np.asarray([5.0, -50.0], np.float32)})],
    "blur>rotation(-50)": [("blur", {"radius": 1.5}), ("rotation", {"angle": -50.0})],
}


def _composed(ops, w, h):
    m = None
    for name, p in ops:
        m2 = tchain._affine_matrix(tchain.OpSpec(name, p), w, h, torch.device("cpu"))
        m = m2 if m is None else wp.compose_matrices(m2, m)
    return m


@pytest.mark.parametrize("method", ["bilinear", "nearest", "bicubic"])
@pytest.mark.parametrize("run", sorted(RUNS))
def test_affine_runs_match_jax_and_one_composed_warp(rng, run, method):
    imgs = rng.integers(0, 256, (2, 40, 48, 3), dtype=np.uint8)
    ops = RUNS[run]
    out = _port(ops, imgs, warp_method=method).numpy()
    _close(out, _jax(ops, imgs, warp_method=method), True)
    x = torch.from_numpy(imgs)
    first, p = ops[0]
    if first == "blur":  # the fused kernels take the blur alone
        x, ops = mk.fused_blur_rotate_image(x, p["radius"], 0.0, stream=True), ops[1:]
    elif first == "rotation" and isinstance(p["angle"], float) and abs(p["angle"]) <= 45:
        x, ops = mk.fused_blur_rotate_image(x, 0.0, p["angle"], stream=True), ops[1:]
    if len(ops) == 1 and ops[0][0] != "rotation":  # a single op runs its own op
        want = PORT_OP[ops[0][0]](x, ops[0][1])
    else:
        want = wp.affine_warp(x, _composed(ops, 48, 40), method=method, fill=0.0)
    np.testing.assert_array_equal(out, want.numpy())


def test_chain_multi_affine_run_still_fuses(rng):
    """tests/test_megakernel.py:154 for the port: the run is one warp of
    the composed matrix, in chain order, close to two sequential warps."""
    imgs = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    out = _port([("translation", {"tx": 6}), ("zoom", {"factor": 1.3})], imgs).numpy()
    x = torch.from_numpy(imgs)
    step1 = wp.affine_warp(x, wp.translation_matrix(6.0, 6.0), method="bilinear")
    seq = wp.affine_warp(step1, wp.zoom_matrix(1.3, 64, 64), method="bilinear").numpy()
    assert float((np.abs(out.astype(int) - seq.astype(int)) <= 8).mean()) > 0.9


# ---------------------------------------------------------------- mixed chains


MIXED = {
    "photometric": [("brightness", {"factor": 0.05}), ("contrast", {"alpha": 1.2}),
                    ("sharpness", {"factor": 1.5}), ("histogram_equalization", {}),
                    ("invert", {})],
    "blur>rotation>gray>scale": [("blur", {"radius": 1.5}), ("rotation", {"angle": 15.0}),
                                 ("grayscale", {}), ("scale", {"factor": 0.9})],
    "shear>rotation(70)>motion": [("shear", {"factor": 0.3}), ("rotation", {"angle": 70.0}),
                                  ("motion_blur", {"ksize": 3})],
}


def _jax_with_pil_rotation(ops, imgs):
    """The JAX strict chain one op at a time, with its rotation stage
    replaced by PIL's rotate(-a, NEAREST): the reference's rotation, which
    the port computes exactly and JAX's f32 coordinates do not (ROADMAP
    C.2.9)."""
    x = imgs
    for name, p in ops:
        if name == "rotation":
            x = np.stack([np.asarray(Image.fromarray(im).rotate(-float(p["angle"])))
                          for im in x])
        else:
            x = _jax([(name, p)], x, strict_parity=True)
    return x


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("name", sorted(MIXED))
def test_mixed_chains_match_jax(rng, name, strict):
    """Against the JAX chain; a strict chain's rotation stage against PIL
    (``_jax_with_pil_rotation``), the other ops against JAX as before."""
    imgs = rng.integers(0, 256, (2, 40, 48, 3), dtype=np.uint8)
    ops = MIXED[name]
    out = _port(ops, imgs, strict_parity=strict).numpy()
    if strict and any(n == "rotation" for n, _ in ops):
        want = _jax_with_pil_rotation(ops, imgs)
    else:
        want = _jax(ops, imgs, strict_parity=strict)
    _close(out, want, True)


def test_tiny_images_take_the_blur_first(rng):
    """Images smaller than the blur window + 2: gaussian_blur (u8), then
    the radius-0 kernel, as the JAX megakernel does."""
    imgs = rng.integers(0, 256, (1, 5, 7, 3), dtype=np.uint8)
    ops = [("blur", {"radius": 1.5}), ("rotation", {"angle": 15.0}), ("grayscale", {})]
    out = _port(ops, imgs).numpy()
    _close(out, _jax(ops, imgs), True, frac=0.05)  # 105 values: one flip is ~1%
    blurred = st.gaussian_blur(torch.from_numpy(imgs), 1.5)
    want = mk.fused_blur_rotate_image(blurred, 0.0, 15.0, grayscale_out=True, stream=True)
    assert torch.equal(torch.from_numpy(out), want)


def test_fast_compile_falls_back_like_jax(rng, imgs):
    """Inputs the per-image-angle kernel does not take (float32, HWC) run
    the normal build, as in JAX."""
    ops = [("blur", {"radius": 1.5}), ("rotation", {"angle": 15.0})]
    x = (rng.random((2, 24, 20, 3)) * 255).astype(np.float32)
    out = _port(ops, x, fast_compile=True).numpy()
    assert _err(out, _jax(ops, x, fast_compile=True))[0] <= 2e-3
    assert torch.equal(_port(ops, imgs[0], fast_compile=True), _port(ops, imgs[0]))
