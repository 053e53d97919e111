"""The port's per-image-angle rotation against the JAX package.

imagetransformations_tpu_torch ``fused_blur_rotate_batched``,
``rotate_3shear_batched`` and the chain's array-angle and ``fast_compile``
routes are held against the JAX functions (Pallas kernels in interpret mode
on the CPU) and the numpy oracles. On the CPU the port runs the kernels'
plain PyTorch versions; the CUDA kernels are compared with those on the
card (tests/test_torch_cuda_kernels.py and chip_smoke.py).

Budgets: the device-f32 shifts equal the JAX formulas' bit for bit on the
grid angles; outputs against the JAX kernels <= 1 LSB on <= 0.1% of pixels
(XLA-CPU contracts FMAs); against the oracles, which take host-f64 shifts,
<= 1 LSB (tests/test_megakernel.py's budget for the traced kernels).
"""

import numpy as np
import pytest
import torch

import cv2
import jax.numpy as jnp

from imagetransformations_tpu.oracle import fast_warp as ofw
from imagetransformations_tpu.ops.pallas import megakernel as jmk
from imagetransformations_tpu.ops.pallas import shear as jshear
from imagetransformations_tpu.pipeline import chain as jchain

from imagetransformations_tpu_torch import OpSpec, build_chain_fn
from imagetransformations_tpu_torch.ops.hopper import megakernel as mk
from imagetransformations_tpu_torch.ops.stencil import cv2_gaussian_ksize
from imagetransformations_tpu_torch.ops.hopper import shear as tshear
from imagetransformations_tpu_torch.pipeline import chain as tchain

GRID_ANGLES = np.arange(-22.5, 22.51, 2.5).astype(np.float32)


def _assert_close(out, ref, max_frac=0.001):
    err = np.abs(out.astype(int) - ref.astype(int))
    assert err.max() <= 1, err.max()
    assert (err > 0).mean() <= max_frac, (err > 0).mean()


def _jax_traced_shifts(angles, n, h, w, max_angle_deg):
    """The f32 shift formulas of megakernel.py:1101-1116, in jnp."""
    ang = jnp.clip(jnp.asarray(angles, jnp.float32), -max_angle_deg, max_angle_deg)
    t = jnp.broadcast_to(jnp.deg2rad(-ang).reshape(-1), (n,))
    a, b = -jnp.tan(t / 2.0), jnp.sin(t)
    ys = jnp.arange(h, dtype=jnp.float32) + 0.5 - h / 2.0
    xs = jnp.arange(w, dtype=jnp.float32) + 0.5 - w / 2.0
    sx, sy = a[:, None] * ys[None, :], b[:, None] * xs[None, :]
    k1, k2 = jnp.floor(sx), jnp.floor(sy)
    return [np.asarray(v) for v in (k1.astype(jnp.int32), sx - k1, k2.astype(jnp.int32),
                                    sy - k2, (t == 0.0).astype(jnp.int32))]


@pytest.mark.parametrize("h,w", [(64, 48), (40, 56), (224, 224), (512, 512)])
def test_traced_shifts_equal_jax_on_grid_angles(h, w):
    n = len(GRID_ANGLES)
    got = mk._traced_params(torch.from_numpy(GRID_ANGLES), n, h, w, 23.0, torch.device("cpu"))
    want = _jax_traced_shifts(GRID_ANGLES, n, h, w, 23.0)
    for g, wv, name in zip(got, want, ("k1", "f1", "k2", "f2", "identity")):
        assert g.numpy().dtype == wv.dtype, name
        assert np.array_equal(g.numpy(), wv), name


def test_traced_shifts_clip_and_broadcast():
    k1, f1, k2, f2, ident = mk._traced_params(torch.tensor(40.0), 3, 8, 6, 22.5,
                                              torch.device("cpu"))
    assert k1.shape == (3, 8) and k2.shape == (3, 6) and ident.tolist() == [0, 0, 0]
    clipped = mk._traced_params(torch.tensor([22.5] * 3), 3, 8, 6, 22.5, torch.device("cpu"))
    for a, b in zip((k1, f1, k2, f2), clipped):
        assert torch.equal(a, b)


def _port(imgs, radius, angles, gray, stream, **kw):
    return mk.fused_blur_rotate_batched(torch.from_numpy(imgs), radius, angles,
                                        grayscale_out=gray, stream=stream, **kw).numpy()


@pytest.mark.parametrize("gray", [True, False])
@pytest.mark.parametrize("stream", [True, False])
def test_batched_matches_jax_kernel(rng, gray, stream):
    imgs = rng.integers(0, 256, (3, 64, 48, 3), dtype=np.uint8)
    angles = np.asarray([-15.0, 0.0, 22.4], np.float32)
    out = _port(imgs, 1.5, angles, gray, stream)
    want = np.asarray(jmk.fused_blur_rotate_batched(
        jnp.asarray(imgs), 1.5, jnp.asarray(angles), grayscale_out=gray, stream=stream))
    assert out.shape == imgs.shape and out.dtype == np.uint8
    _assert_close(out, want)


@pytest.mark.parametrize("gray", [True, False])
def test_batched_stream_matches_oracle_per_image(rng, gray):
    imgs = rng.integers(0, 256, (2, 40, 56, 3), dtype=np.uint8)
    angles = np.asarray([22.5, -22.5], np.float32)
    out = _port(imgs, 1.5, angles, gray, True)
    for i, a in enumerate(angles):
        ref = ofw.fused_stream_chain(imgs[i : i + 1], 1.5, float(a), grayscale_out=gray)
        assert np.abs(out[i : i + 1].astype(int) - ref.astype(int)).max() <= 1, a


def test_batched_radius0_strict_matches_rotate_3shear_oracle(rng):
    imgs = rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)
    angles = np.asarray([-22.5, -7.5, 0.0, 17.5], np.float32)
    out = _port(imgs, 0.0, angles, False, False, max_angle_deg=23.0)
    for i, a in enumerate(angles):
        ref = ofw.rotate_3shear(imgs[i : i + 1], float(a))
        assert np.abs(out[i : i + 1].astype(int) - ref.astype(int)).max() <= 1, a


def test_traced_stream_nongray_zero_angle_uses_rint(rng):
    """An angle-0 image in a traced stream non-gray batch quantizes with
    rint (blur only), the others with trunc: taking trunc for it would flip
    ~50% of its pixels (tests/test_megakernel.py:321)."""
    imgs = rng.integers(0, 256, (2, 64, 48, 3), dtype=np.uint8)
    angles = np.asarray([0.0, 12.0], np.float32)
    out = _port(imgs, 1.5, angles, False, True)
    for i, a in enumerate(angles):
        ref = ofw.fused_stream_chain(imgs[i : i + 1], 1.5, float(a))
        diff = out[i : i + 1].astype(int) - ref.astype(int)
        assert np.abs(diff).max() <= 1, a
        assert (diff != 0).mean() < 0.05, (a, (diff != 0).mean())


def test_batched_matches_static_per_image(rng):
    """Device-f32 shifts against the static path's host-f64 ones: <= 1 LSB."""
    imgs = rng.integers(0, 256, (3, 64, 48, 3), dtype=np.uint8)
    angles = np.asarray([-15.0, 0.0, 22.4], np.float32)
    for stream in (True, False):
        out = _port(imgs, 1.5, angles, True, stream)
        for i, a in enumerate(angles):
            ref = mk.fused_blur_rotate_image(torch.from_numpy(imgs[i : i + 1]), 1.5, float(a),
                                             grayscale_out=True, stream=stream).numpy()
            assert np.abs(out[i : i + 1].astype(int) - ref.astype(int)).max() <= 1


def test_scalar_angle_broadcasts(rng):
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 32, 40, 3), dtype=np.uint8))
    one = mk.fused_blur_rotate_batched(imgs, 1.0, 10.0, stream=True)
    two = mk.fused_blur_rotate_batched(imgs, 1.0, torch.tensor([10.0, 10.0]), stream=True)
    assert torch.equal(one, two)


def test_budget_and_unported_inputs_raise(rng):
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 64, 48, 3), dtype=np.uint8))
    with pytest.raises(ValueError, match="budget"):
        mk.fused_blur_rotate_batched(imgs, 1.5, np.asarray([10.0, -23.0], np.float32))
    mk.fused_blur_rotate_batched(imgs, 1.5, np.asarray([10.0, -23.0], np.float32),
                                 max_angle_deg=25.0)
    with pytest.raises(ValueError):
        mk.fused_blur_rotate_batched(imgs, 1.5, np.zeros(3, np.float32))  # 3 angles, 2 images
    with pytest.raises(ValueError):
        mk.fused_blur_rotate_batched(imgs[..., :1], 1.5, 5.0, grayscale_out=True)
    # images smaller than the blur window + 2: gaussian_blur, then radius 0, as
    # in JAX; the port's gaussian_blur is cv2's integer blur: 0 LSB against
    # cv2's blur then the JAX function at radius 0, and the JAX function
    # (f32 blur) within <= 1 LSB on <= 10% (measured 6.7%)
    tiny = rng.integers(0, 256, (2, 5, 48, 3), dtype=np.uint8)
    angles = np.asarray([5.0, -7.0], np.float32)
    out = mk.fused_blur_rotate_batched(torch.from_numpy(tiny), 1.5, angles).numpy()
    k = cv2_gaussian_ksize(1.5)
    blurred = np.stack([cv2.GaussianBlur(im, (k, k), 1.5) for im in tiny])
    np.testing.assert_array_equal(out, np.asarray(jmk.fused_blur_rotate_batched(
        jnp.asarray(blurred), 0.0, jnp.asarray(angles))))
    want = np.asarray(jmk.fused_blur_rotate_batched(jnp.asarray(tiny), 1.5, jnp.asarray(angles)))
    err = np.abs(out.astype(int) - want.astype(int))
    assert err.max() <= 1 and (err > 0).mean() <= 0.10, (err.max(), (err > 0).mean())


def test_cpu_counts_no_launch(rng):
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 40, 36, 3), dtype=np.uint8))
    before = dict(mk.LAUNCHES)
    mk.fused_blur_rotate_batched(imgs, 1.5, [5.0, -5.0], grayscale_out=True, stream=True)
    mk.fused_blur_rotate_batched(imgs, 0.0, [5.0, 0.0], stream=False)
    assert mk.LAUNCHES == before


# ------------------------------------------------------------ rotate_3shear


def test_rotate_3shear_batched_matches_jax_and_oracle(rng):
    imgs = rng.integers(0, 256, (3, 48, 40, 3), dtype=np.uint8)
    angles = np.asarray([-30.0, 0.0, 45.0], np.float32)
    out = tshear.rotate_3shear_batched(torch.from_numpy(imgs), angles, fill=7).numpy()
    want = np.asarray(jshear.rotate_3shear_batched(jnp.asarray(imgs), jnp.asarray(angles),
                                                   fill=7))
    _assert_close(out, want)
    for i, a in enumerate(angles):
        ref = ofw.rotate_3shear(imgs[i : i + 1], float(a), fill=7)
        assert np.abs(out[i : i + 1].astype(int) - ref.astype(int)).max() <= 1, a
    with pytest.raises(ValueError, match="budget"):
        tshear.rotate_3shear_batched(torch.from_numpy(imgs), angles, max_angle_deg=40.0)


# ------------------------------------------------------------ chain routes


@pytest.mark.parametrize(
    "ops",
    [
        [("blur", {"radius": 1.5}), ("rotation", {"angle": np.asarray([-15.0, 7.5], np.float32)}),
         ("grayscale", {})],
        [("rotation", {"angle": np.asarray([30.0, 0.0], np.float32)})],
        [("rotation", {"angle": np.float32(12.0)}), ("blur", {"radius": 1.0})],
    ],
    ids=["blur>rotation[array]>gray", "rotation[array, budget 30]", "rotation[np.float32]|blur"],
)
def test_chain_array_angles_match_jax(rng, ops):
    imgs = rng.integers(0, 256, (2, 64, 48, 3), dtype=np.uint8)
    out = build_chain_fn([OpSpec(n, dict(p)) for n, p in ops], device="cpu")(imgs).numpy()
    want = np.asarray(jchain.build_chain_fn([jchain.OpSpec(n, dict(p)) for n, p in ops])(
        jnp.asarray(imgs)))
    _assert_close(out, want)


def test_chain_array_angle_routing_matches_jax():
    angles = np.asarray([-15.0, 7.5], np.float32)
    x = jnp.zeros((2, 64, 48, 3), jnp.uint8)
    ops = [("blur", {"radius": 1.5}), ("rotation", {"angle": angles}), ("grayscale", {})]
    want = jchain._match_mega([jchain.OpSpec(n, p) for n, p in ops], 0, False, x)
    got = tchain._match_mega([tchain.OpSpec(n, p) for n, p in ops], 0, 3)
    assert got[0] == want[0] and got[2:] == want[2:]
    assert np.array_equal(got[1], want[1])
    assert tchain._round_budget(7.4) == jchain._round_budget(7.4) == 10.0
    assert tchain._round_budget(0.0) == jchain._round_budget(0.0) == 5.0


@pytest.mark.parametrize("gray", [True, False])
def test_fast_compile_matches_jax_and_static_route(rng, gray):
    imgs = rng.integers(0, 256, (2, 64, 48, 3), dtype=np.uint8)
    ops = [("blur", {"radius": 1.5}), ("rotation", {"angle": 15.0})] + (
        [("grayscale", {})] if gray else [])
    fc = build_chain_fn([OpSpec(n, dict(p)) for n, p in ops], fast_compile=True, device="cpu")
    out = fc(imgs).numpy()
    want = np.asarray(jchain.build_chain_fn(
        [jchain.OpSpec(n, dict(p)) for n, p in ops], fast_compile=True)(jnp.asarray(imgs)))
    _assert_close(out, want)
    static = build_chain_fn([OpSpec(n, dict(p)) for n, p in ops], device="cpu")(imgs).numpy()
    assert np.abs(out.astype(int) - static.astype(int)).max() <= 1
    batched = mk.fused_blur_rotate_batched(torch.from_numpy(imgs), 1.5, [15.0, 15.0],
                                           grayscale_out=gray, stream=True, max_angle_deg=15.0)
    assert np.array_equal(out, batched.numpy())  # the route JAX's fast_compile takes


def test_fast_compile_spec_matches_jax():
    chains = [
        [("blur", {"radius": 1.5}), ("rotation", {"angle": 15.0}), ("grayscale", {})],
        [("rotation", {"angle": -30.0})],
        [("rotation", {"angle": 0.0})],
        [("rotation", {"angle": 50.0})],
        [("blur", {"radius": 1.5})],
        [("rotation", {"angle": 15.0}), ("blur", {"radius": 1.0})],
    ]
    for ops in chains:
        want = jchain._fast_compile_spec([jchain.OpSpec(n, p) for n, p in ops])
        got = tchain._fast_compile_spec([tchain.OpSpec(n, p) for n, p in ops])
        assert got == want, ops


def test_fast_compile_falls_back_for_other_inputs(rng):
    """A gray chain on a 1-channel batch is not the kernel's: the normal
    build takes it and computes (grayscale of one channel is its own luma),
    with the same output; float32 input takes the normal build too."""
    ops = [OpSpec("blur", {"radius": 1.5}), OpSpec("rotation", {"angle": 15.0}),
           OpSpec("grayscale")]
    fc = build_chain_fn(ops, fast_compile=True, device="cpu")
    one_channel = rng.integers(0, 256, (1, 40, 36, 1), dtype=np.uint8)
    out = fc(one_channel)
    assert out.shape == (1, 40, 36, 3)
    assert torch.equal(out, build_chain_fn(ops, device="cpu")(one_channel))
    floats = rng.random((1, 40, 36, 3), dtype=np.float32) * 255
    assert torch.equal(fc(floats), build_chain_fn(ops, device="cpu")(floats))
