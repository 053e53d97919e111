"""The port's fused blur -> rotate (-> grayscale) against the JAX package.

imagetransformations_tpu_torch/ops/hopper/megakernel.py is held against the
numpy oracles (oracle/fast_warp.py, oracle/stencil.py) and the JAX
``fused_blur_rotate_image``, which runs its Pallas kernels in interpret mode
on the CPU. On the CPU the port runs the kernels' plain PyTorch versions;
the CUDA kernels themselves are compared with those on the card
(tests/test_torch_cuda_kernels.py and chip_smoke.py).

Budgets: the plain stream path equals the f32 oracle bit for bit (both
round every op separately); against the JAX kernels, which XLA-CPU
compiles with FMA contraction, <= 1 LSB on <= 0.1% of pixels
(the budget of tests/test_megakernel.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from imagetransformations_tpu.oracle import elementwise as oe
from imagetransformations_tpu.oracle import fast_warp as ofw
from imagetransformations_tpu.oracle import stencil as ost
from imagetransformations_tpu.ops.pallas import megakernel as jmk
from imagetransformations_tpu.ops.pallas import shear as jshear

from imagetransformations_tpu_torch.ops import stencil as tst
from imagetransformations_tpu_torch.ops.hopper import megakernel as mk
from imagetransformations_tpu_torch.ops.hopper import shear as tshear


def _port(imgs, radius, angle, gray, stream, fill=0):
    return mk.fused_blur_rotate_image(
        torch.from_numpy(imgs), radius, angle, fill=fill, grayscale_out=gray, stream=stream
    ).numpy()


def _jax(imgs, radius, angle, gray, stream, fill=0):
    return np.asarray(
        jmk.fused_blur_rotate_image(
            jnp.asarray(imgs), radius, angle, fill=fill, grayscale_out=gray, stream=stream
        )
    )


def _per_op_oracle(imgs, radius, angle, gray):
    out = np.stack([ost.gaussian_blur(im, radius) for im in imgs]) if radius else imgs
    if angle:
        out = ofw.rotate_3shear(out, angle)
    if gray:
        out = np.stack([oe.grayscale_rgb(im) for im in out])
    return out


def _assert_close(out, ref, max_frac=0.001):
    err = np.abs(out.astype(int) - ref.astype(int))
    assert err.max() <= 1, err.max()
    assert (err > 0).mean() <= max_frac, (err > 0).mean()


# ---------------------------------------------------------------- constants


def test_core_image_helpers_match_jax():
    from imagetransformations_tpu.core import image as jimg
    from imagetransformations_tpu_torch.core import image as timg

    v = np.array([-3.5, -0.5, -0.0, 0.5, 1.5, 2.5, 2.7, 127.5, 254.5, 255.49, 255.5, 300.0],
                 np.float32)
    for name in ("to_uint8_trunc", "to_uint8_rint"):
        got = getattr(timg, name)(torch.from_numpy(v)).numpy()
        want = np.asarray(getattr(jimg, name)(jnp.asarray(v)))
        assert got.dtype == want.dtype == np.uint8
        assert np.array_equal(got, want), name
    hwc = torch.zeros((5, 4, 3), dtype=torch.uint8)
    batch, single = timg.as_batch(hwc)
    assert tuple(batch.shape) == (1, 5, 4, 3) and single
    assert timg.restore_layout(batch, single).shape == hwc.shape
    nhwc, single = timg.as_batch(batch)
    assert nhwc is batch and not single
    with pytest.raises(ValueError):
        timg.as_batch(torch.zeros((5, 4)))


@pytest.mark.parametrize("radius", [0.5, 1.0, 1.5, 2.5])
def test_gaussian_constants_match_oracle(radius):
    k = tst.cv2_gaussian_ksize(radius)
    assert k == ost.cv2_gaussian_ksize(radius)
    assert np.array_equal(tst.gaussian_taps(k, radius), ost.gaussian_taps(k, radius))


@pytest.mark.parametrize("angle", [7.0, -7.0, 15.0, -15.0, 22.5, -22.5, 45.0])
def test_shear_constants_match_jax(angle):
    assert tshear._paeth_params(angle) == jshear._paeth_params(angle)
    a, b = tshear._paeth_params(angle)
    for size in (32, 48, 64, 224, 512):
        for slope in (a, b):
            got = tshear._row_shifts(size, slope, size / 2.0)
            want = jshear._row_shifts(size, slope, size / 2.0)
            assert got.dtype == want.dtype == np.float32
            assert np.array_equal(got, want)


# (shape, radius, angle, gray, fill)
STREAM_CASES = [
    ((2, 64, 48), 1.5, 15.0, True, 0),
    ((2, 64, 48), 1.5, 15.0, False, 0),
    ((1, 96, 64), 0.0, -22.5, True, 0),    # radius 0: no blur
    ((3, 32, 32), 1.0, 22.5, False, 0),
    ((1, 64, 64), 1.0, 0.0, True, 0),      # angle 0, luma kernel
    ((1, 64, 64), 1.0, 0.0, False, 0),     # angle 0: identity, rint
    ((1, 64, 48), 0.0, 0.0, True, 0),      # no blur, no rotation: PIL gray
    ((1, 64, 48), 1.5, 15.0, True, 128),   # fill != 0 on the luma plane
    ((1, 64, 48), 2.5, -45.0, False, 128),
]


@pytest.mark.parametrize("shape,radius,angle,gray,fill", STREAM_CASES)
def test_plain_stream_equals_f32_oracle(rng, shape, radius, angle, gray, fill):
    imgs = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    out = _port(imgs, radius, angle, gray, stream=True, fill=fill)
    ref = ofw.fused_stream_chain(imgs, radius, angle, grayscale_out=gray, fill=fill)
    assert out.shape == ref.shape and out.dtype == np.uint8
    assert np.array_equal(out, ref)


@pytest.mark.parametrize("shape,radius,angle,gray,fill", STREAM_CASES)
def test_plain_stream_matches_jax_kernel(rng, shape, radius, angle, gray, fill):
    imgs = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    out = _port(imgs, radius, angle, gray, stream=True, fill=fill)
    _assert_close(out, _jax(imgs, radius, angle, gray, stream=True, fill=fill))


# (shape, radius, angle, gray)
STRICT_CASES = [
    ((2, 64, 48), 1.5, 15.0, True),
    ((2, 64, 48), 1.5, 15.0, False),
    ((1, 96, 64), 0.0, -22.5, True),
    ((3, 32, 32), 1.0, 22.5, False),
    ((1, 64, 64), 1.0, 0.0, True),
]


@pytest.mark.parametrize("shape,radius,angle,gray", STRICT_CASES)
def test_plain_strict_matches_per_op_oracle(rng, shape, radius, angle, gray):
    """stream=False: rint after the blur, trunc after each shear, PIL gray;
    the blur oracle is f64, hence the 1-LSB budget at 0.5 boundaries."""
    imgs = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    out = _port(imgs, radius, angle, gray, stream=False)
    _assert_close(out, _per_op_oracle(imgs, radius, angle, gray))


@pytest.mark.parametrize("shape,radius,angle,gray", STRICT_CASES)
def test_plain_strict_matches_jax_kernel(rng, shape, radius, angle, gray):
    imgs = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    out = _port(imgs, radius, angle, gray, stream=False)
    _assert_close(out, _jax(imgs, radius, angle, gray, stream=False))


def test_packed_geometry_equals_unpacked(rng):
    """A packable CIFAR-size batch takes the many-images-a-block geometry
    (the counterpart of _mega_gray1_packed_kernel);
    its output equals the oracle, the JAX packed kernel, and each image run
    on its own."""
    imgs = rng.integers(0, 256, (64, 32, 32, 3), dtype=np.uint8)
    g = mk._luma_geometry(32, 32, 4)
    assert g.groups > 1 and g.seg_w == 32  # several images a block, whole rows
    assert jmk._pack_factors(64, 32, 32) != (1, 1)  # JAX packs it too
    out = _port(imgs, 1.5, 15.0, True, stream=True)
    one_by_one = np.concatenate(
        [_port(imgs[i : i + 1], 1.5, 15.0, True, stream=True) for i in range(len(imgs))]
    )
    assert mk._luma_geometry(512, 512, 4).groups == 1  # one unit a block at 512
    assert np.array_equal(out, one_by_one)
    assert np.array_equal(out, ofw.fused_stream_chain(imgs, 1.5, 15.0, grayscale_out=True))
    _assert_close(out, _jax(imgs, 1.5, 15.0, True, stream=True), max_frac=1e-4)


@pytest.mark.parametrize(
    "h,w,p,want",
    [
        # whole rows, several small images a block (h < 128: the JAX
        # package's packed route)
        (32, 32, 4, (16, 4, 32, 34, 8, 16)),
        (64, 48, 4, (16, 4, 48, 50, 12, 10)),
        # bands of whole rows
        (512, 512, 4, (32, 8, 512, 514, 128, 1)),
        (224, 224, 4, (32, 8, 224, 226, 56, 2)),
        (130, 48, 7, (32, 8, 48, 50, 12, 10)),
        # column segments: rows too wide for a block's threads, or a radius
        # whose ring of X rows fills shared memory
        (600, 3000, 4, (32, 8, 512, 1026, 257, 1)),
        (2000, 2000, 500, (32, 8, 16, 34, 9, 1)),
    ],
)
def test_images_per_block(h, w, p, want):
    """The luma kernel's geometry (images a block, band rows, segments) is
    the host's choice from the shapes alone, and fits the kernel's limits."""
    g = mk._luma_geometry(h, w, p)
    assert tuple(g) == want
    assert g.threads * g.groups <= mk._LUMA_THREADS
    assert g.threads * mk._LUMA_COLS >= min(g.win, w)
    assert g.win >= (w + 2 if g.seg_w >= w else g.seg_w + 1)
    assert max(mk._luma_smem(g, h, w, p)) <= mk._SMEM_MAX


def test_per_image_shifts_equal_shared_shifts(rng):
    """The plain shears take shifts per image ([n, h], [n, w]) as well as one
    set for the batch; the same set repeated per image gives the same bits."""
    imgs = torch.from_numpy(rng.integers(0, 256, (3, 40, 36, 3), dtype=np.uint8))
    taps, p, k1, f1, k2, f2 = mk._params(40, 36, 1.5, 15.0, torch.device("cpu"))
    shared = mk.luma_blur_rotate(imgs, taps, p, k1, f1, k2, f2)
    rep = [t.expand(3, -1).contiguous() for t in (k1, f1, k2, f2)]
    assert torch.equal(mk.luma_blur_rotate(imgs, taps, p, *rep), shared)
    assert mk._shift_strides(rep[0], rep[2], 3) == (40, 36)
    assert mk._shift_strides(k1, k2, 3) == (0, 0)


def test_cpu_runs_plain_and_counts_no_launch(rng):
    imgs = torch.from_numpy(rng.integers(0, 256, (2, 40, 36, 3), dtype=np.uint8))
    before = dict(mk.LAUNCHES)
    mk.fused_blur_rotate_image(imgs, 1.5, 15.0, grayscale_out=True, stream=True)
    mk.fused_blur_rotate_image(imgs, 1.5, 15.0, stream=False)
    assert mk.LAUNCHES == before


def test_wrappers_raise_off_cpu_and_cuda(rng):
    """A tensor neither on the CPU nor on CUDA is refused, never computed
    some other way."""
    imgs = torch.zeros((1, 40, 36, 3), dtype=torch.uint8, device="meta")
    taps, p, k1, f1, k2, f2 = mk._params(40, 36, 1.5, 15.0, torch.device("cpu"))
    with pytest.raises(ValueError):
        mk.luma_blur_rotate(imgs, taps, p, k1, f1, k2, f2)
    with pytest.raises(ValueError):
        mk.rgb_blur_rotate(imgs, taps, p, k1, f1, k2, f2)


def test_unported_inputs_raise(rng):
    """|angle| > 45 and images smaller than the blur window + 2 now run as
    the JAX function runs them (pads from the shifts; gaussian_blur, then
    the radius-0 kernel); float and 1-channel gray inputs still raise."""
    imgs = rng.integers(0, 256, (1, 64, 48, 3), dtype=np.uint8)
    for a in (50.0, -80.0):
        np.testing.assert_array_equal(_port(imgs, 1.5, a, True, True),
                                      _jax(imgs, 1.5, a, True, True))
        np.testing.assert_array_equal(_port(imgs, 0.0, a, False, False),
                                      ofw.rotate_3shear(imgs, a))
    tiny = rng.integers(0, 256, (1, 5, 48, 3), dtype=np.uint8)  # 9 taps need h >= 6
    np.testing.assert_array_equal(_port(tiny, 1.5, 15.0, True, True),
                                  _jax(tiny, 1.5, 15.0, True, True))
    blurred = np.stack([ost.gaussian_blur(im, 1.5) for im in tiny])
    np.testing.assert_array_equal(_port(tiny, 1.5, 15.0, False, False),
                                  _per_op_oracle(blurred, 0.0, 15.0, False))
    t = torch.from_numpy(imgs)
    with pytest.raises(ValueError):
        mk.fused_blur_rotate_image(t.float(), 1.5, 15.0)
    with pytest.raises(ValueError):
        mk.fused_blur_rotate_image(t[..., :1], 1.5, 15.0, grayscale_out=True)
