"""The port's CUDA kernels against their plain PyTorch versions, on the card.

The blur-rotate kernels with one angle for the batch and one an image, the
BICUBIC shear (also with the sweep's int32 canvas shifts), the row-shift
shear, the bilinear zoom, the PIL NEAREST rotation, the separable Gaussian
blur (cv2's integers, with host rows and the sweep's tap table), the row
shifts of ``shear_rows`` and
``shear_rows_per_image``, the column pass and the 3-shear rotations built
on them, the apply_all sweep (every flag combination) and ``build_chain_fn``
(every route) on the card against their CPU routes; and
``pipeline.io.prefetch_to_device`` staging host batches onto the card.

Every test here needs an NVIDIA GPU: it carries the ``cuda`` marker and
skips without one (the decision is made inside the fixture). The file
imports nothing of JAX, so it runs on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda_kernels.py -q

Budget: 0 LSB. Both sides round every f32 operation separately, or sum
the same integers (the blur).
"""

import numpy as np
import pytest
import torch

from imagetransformations_tpu_torch import OpSpec, apply_all_transformations, build_chain_fn
from imagetransformations_tpu_torch.ops.hopper import blur as bl
from imagetransformations_tpu_torch.ops.hopper import megakernel as mk
from imagetransformations_tpu_torch.ops.hopper import resample as rs
from imagetransformations_tpu_torch.ops.hopper import rotate_gather as rg
from imagetransformations_tpu_torch.ops.hopper import shear as sh
from imagetransformations_tpu_torch.ops import stencil as st
from imagetransformations_tpu_torch.ops import warp as wp
from imagetransformations_tpu_torch.pipeline import batch
from imagetransformations_tpu_torch.pipeline.batch import TYPES

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
        ((3, 64, 48), 1.5, 15.0, True, True, 0, "luma_blur_rotate_packed"),  # odd batch
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
    g = mk._luma_geometry(32, 32, p)
    assert g.groups > 1
    packed = mk.luma_blur_rotate(x, taps, p, k1, f1, k2, f2, 0)
    single = mk.luma_blur_rotate(x, taps, p, k1, f1, k2, f2, 0, geometry=g._replace(groups=1))
    assert torch.equal(packed, single)


def test_default_chain_runs_on_the_card(rng, cuda):
    imgs = rng.integers(0, 256, (2, 64, 48, 3), dtype=np.uint8)
    chain = [OpSpec("blur", {"radius": 1.5}), OpSpec("rotation", {"angle": 15.0}),
             OpSpec("grayscale")]
    out = build_chain_fn(chain)(imgs)
    assert out.device.type == "cuda"
    assert torch.equal(out.cpu(), build_chain_fn(chain, device="cpu")(imgs))


# ---------------------------------------------------------------- per-image angles


@pytest.mark.parametrize(
    "shape,radius,angles,gray,stream,kernel",
    [
        ((3, 64, 48), 1.5, [-15.0, 0.0, 22.4], True, True, "luma_blur_rotate_traced"),
        ((64, 32, 32), 1.5, np.linspace(-22.5, 22.5, 64), True, True, "luma_blur_rotate_traced"),
        ((4, 33, 65), 0.0, [-22.5, 0.0, 7.5, 22.5], False, False, "rgb_blur_rotate_traced"),
        ((3, 64, 48), 1.5, [0.0, 12.0, -3.0], False, True, "rgb_blur_rotate_traced"),
        ((2, 64, 48), 1.5, [5.0, -20.0], True, False, "rgb_blur_rotate_traced"),
    ],
)
def test_traced_kernel_equals_plain(rng, cuda, shape, radius, angles, gray, stream, kernel):
    """The shifts are computed once on the card and fed to the kernel and
    to its plain version; the entry point routes to the kernel."""
    x = torch.from_numpy(rng.integers(0, 256, (*shape, 3), dtype=np.uint8)).to(cuda)
    n, h, w = shape
    angles = np.asarray(angles, np.float32)
    taps, p = mk._params(h, w, radius, 0.0, x.device)[:2]
    k1, f1, k2, f2, ident = mk._traced_params(angles, n, h, w, 22.5, x.device)
    before = mk.LAUNCHES[kernel]
    out = mk.fused_blur_rotate_batched(x, radius, angles, grayscale_out=gray, stream=stream)
    torch.cuda.synchronize()
    assert mk.LAUNCHES[kernel] == before + 1
    if kernel.startswith("luma"):
        plain = mk.luma_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, 0)
    else:
        plain = mk.rgb_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, 0, not stream, gray, ident)
    assert torch.equal(out, plain)


def test_traced_packed_geometry_byte_equal_to_one_image_a_block(rng, cuda):
    x = torch.from_numpy(rng.integers(0, 256, (64, 32, 32, 3), dtype=np.uint8)).to(cuda)
    taps, p = mk._params(32, 32, 1.5, 0.0, x.device)[:2]
    k1, f1, k2, f2, _ = mk._traced_params(np.linspace(-22.5, 22.5, 64), 64, 32, 32, 22.5,
                                          x.device)
    g = mk._luma_geometry(32, 32, p)
    assert g.groups > 1
    packed = mk.luma_blur_rotate(x, taps, p, k1, f1, k2, f2, 0)
    single = mk.luma_blur_rotate(x, taps, p, k1, f1, k2, f2, 0, geometry=g._replace(groups=1))
    assert torch.equal(packed, single)


# ---------------------------------------------------------------- BICUBIC shear


@pytest.mark.parametrize("shape", [(11, 48, 40, 3), (3, 40, 56, 1), (4, 17, 300, 3)])
def test_shear_bicubic_equals_plain(rng, cuda, shape):
    x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(cuda)
    f = torch.from_numpy(np.resize(np.arange(11, dtype=np.float32) / 10, shape[0])).to(cuda)
    before = mk.LAUNCHES["shear_bicubic"]
    out = rs.shear_bicubic_batched(x, f)
    torch.cuda.synchronize()
    assert mk.LAUNCHES["shear_bicubic"] == before + 1
    assert torch.equal(out, rs.shear_bicubic_plain(x, f))
    assert torch.equal(out.cpu(), rs.shear_bicubic_plain(x.cpu(), f.cpu()))


@pytest.mark.parametrize("h", [10, 40, 100])
def test_shear_bicubic_takes_int32_canvas_shifts(rng, cuda, h):
    """The sweep's shifts (the grid's f64 table, gathered by index) and
    shifts off by one: the kernel equals its plain version on the same
    int32 shifts, and the table's shifts equal the CPU route's."""
    x = torch.from_numpy(rng.integers(0, 256, (11, h, 37, 3), dtype=np.uint8)).to(cuda)
    idx = torch.arange(11, device=cuda)
    f = torch.from_numpy(np.float32(SHEAR_GRID)).to(cuda)
    table = rs.shear_shift_table(tuple(SHEAR_GRID), h, cuda)[idx]
    for shifts in (table, table + 1):
        out = rs.shear_bicubic(x, f, shifts)
        assert torch.equal(out, rs.shear_bicubic_plain(x, f, shifts))
        assert torch.equal(out.cpu(), rs.shear_bicubic_plain(x.cpu(), f.cpu(), shifts.cpu()))


# ---------------------------------------------------------------- row shift, zoom, rotation

# shapes: w not a multiple of 32, a single image, one channel, a wide row
NEW_KERNEL_SHAPES = [(3, 40, 45, 3), (1, 33, 70, 3), (5, 24, 20, 1), (2, 17, 300, 3)]


@pytest.mark.parametrize("shape", NEW_KERNEL_SHAPES)
def test_shear_rows_equals_plain(rng, cuda, shape):
    """The fast shear's shifts over the shear grid, plus a beyond-budget
    row (saturation) and a beyond-canvas row (all fill)."""
    n, h, w, _ = shape
    x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(cuda)
    shifts = batch.fast_shear_shifts(np.resize(np.arange(11, dtype=np.float32) / 10, n), h, cuda)
    bound = batch.fast_shear_budget(1.0, h)
    shifts[0, 0], shifts[-1, -1] = -(bound + 7.5), 3.0 * w
    before = mk.LAUNCHES["shear_rows_logrouted"]
    out = sh.shear_rows_logrouted(x, shifts, fill=255, max_shift_px=bound)
    torch.cuda.synchronize()
    assert mk.LAUNCHES["shear_rows_logrouted"] == before + 1
    b_px = min(bound + 1, w + 2)
    assert torch.equal(out, sh.shear_rows_plain(x, shifts, 255, b_px))
    assert torch.equal(out.cpu(), sh.shear_rows_logrouted(x.cpu(), shifts.cpu(), fill=255,
                                                          max_shift_px=bound))


@pytest.mark.parametrize("shape", NEW_KERNEL_SHAPES)
def test_zoom_bilinear_equals_plain(rng, cuda, shape):
    n = shape[0]
    x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(cuda)
    f = torch.from_numpy(np.resize(np.asarray([0.9, 1.0, 1.1, 1.2, 1.3, 1.4, 0.85, 1.45],
                                              np.float32), n)).to(cuda)
    before = mk.LAUNCHES["zoom_bilinear"]
    out = rs.zoom_bilinear_batched(x, f)
    torch.cuda.synchronize()
    assert mk.LAUNCHES["zoom_bilinear"] == before + 1
    assert torch.equal(out, rs.zoom_bilinear_plain(x, f))
    assert torch.equal(out.cpu(), rs.zoom_bilinear_plain(x.cpu(), f.cpu()))


ROTATION_ANGLES = [-22.5 + 2.5 * i for i in range(19)] + [45.0, -45.0, 60.0, -90.0, 135.0,
                                                         180.0, 179.0, 13.37]


@pytest.mark.parametrize("shape", NEW_KERNEL_SHAPES)
def test_pil_rotate_nearest_equals_plain(rng, cuda, shape):
    """The coefficients are host integers, so the kernel equals the plain
    version on the card and on the CPU bit for bit."""
    n, h, w, _ = shape
    x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(cuda)
    angles = np.resize(np.asarray(ROTATION_ANGLES, np.float32), n)
    coeffs = torch.from_numpy(rg.pil_rotate_coeffs(angles, w, h).fixed).to(cuda)
    before = mk.LAUNCHES["pil_rotate_nearest"]
    out = rg.pil_rotate_nearest_batched(x, angles, fill=7)
    torch.cuda.synchronize()
    assert mk.LAUNCHES["pil_rotate_nearest"] == before + 1
    assert torch.equal(out, rg.pil_rotate_nearest_plain(x, coeffs, 7))
    assert torch.equal(out.cpu(), rg.pil_rotate_nearest_batched(x.cpu(), angles, fill=7))


@pytest.mark.parametrize("c", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("hw", [(32, 32), (37, 53), (7, 1), (1, 9), (130, 70)])
def test_pil_rotate_nearest_kernel_cases_equal_plain(rng, cuda, c, hw):
    """c 1-5, w = 1 and h = 1, tiles with ragged ends, every angle of
    ROTATION_ANGLES (one an image, and one for the batch)."""
    h, w = hw
    n = len(ROTATION_ANGLES)
    x = torch.from_numpy(rng.integers(0, 256, (n, h, w, c), dtype=np.uint8)).to(cuda)
    a = np.asarray(ROTATION_ANGLES, np.float32)
    want = rg.pil_rotate_nearest_batched(x.cpu(), a, fill=9)
    assert torch.equal(rg.pil_rotate_nearest_batched(x, a, fill=9).cpu(), want)
    one = rg.pil_rotate_nearest_batched(x, 135.0)
    assert torch.equal(one.cpu(), rg.pil_rotate_nearest_batched(x.cpu(), 135.0))


@pytest.mark.parametrize("c", [1, 3, 4])
def test_pil_rotate_nearest_takes_an_odd_data_ptr(rng, cuda, c):
    """A contiguous view whose data starts at an odd address: unaligned
    rows, byte loads and stores."""
    base = torch.from_numpy(rng.integers(0, 256, (4, 37, 23, c), dtype=np.uint8)).to(cuda)
    x = base[1:]
    assert x.is_contiguous() and (c == 4 or x.data_ptr() % 2 == 1)
    xo = torch.from_numpy(rng.integers(0, 256, (4 * 37 * 23 * c + 1,),
                                       dtype=np.uint8)).to(cuda)[1:].view(4, 37, 23, c)
    for img in (x, xo):
        a = np.asarray([-60.0, 12.5, 90.0, 180.0][: img.shape[0]], np.float32)
        got = rg.pil_rotate_nearest_batched(img, a)
        assert torch.equal(got.cpu(), rg.pil_rotate_nearest_batched(img.cpu(), a))


def test_pil_rotate_nearest_full_sweep_shapes_and_tall_images(rng, cuda):
    """4096x32x32x3 on the grid; 70000 rows (no cap on h); 65537 images."""
    x = torch.from_numpy(rng.integers(0, 256, (4096, 32, 32, 3), dtype=np.uint8)).to(cuda)
    a = np.resize(np.asarray(ROTATION_ANGLES, np.float32), 4096)
    assert torch.equal(rg.pil_rotate_nearest_batched(x, a).cpu(),
                       rg.pil_rotate_nearest_batched(x.cpu(), a))
    tall = torch.from_numpy(rng.integers(0, 256, (2, 70000, 3, 1), dtype=np.uint8)).to(cuda)
    for angle in (0.0, 90.0, -30.0):
        co = rg.pil_rotate_coeffs(angle, 3, 70000)
        assert co.flagged.all()  # a corner beyond 32768: Pillow's f64 path
        assert torch.equal(rg.pil_rotate_nearest_batched(tall, angle).cpu(),
                           rg.pil_rotate_nearest_batched(tall.cpu(), angle))
        # the fixed-point route alone at 70000 rows, its sums wrapping
        k = torch.from_numpy(co.fixed)
        assert torch.equal(rg.pil_rotate_nearest(tall, k.to(cuda).expand(2, 6)).cpu(),
                           rg.pil_rotate_nearest_plain(tall.cpu(), k, 0))
    many = torch.from_numpy(rng.integers(0, 256, (65537, 3, 4, 1), dtype=np.uint8)).to(cuda)
    a = np.resize(np.asarray(ROTATION_ANGLES, np.float32), 65537)
    assert torch.equal(rg.pil_rotate_nearest_batched(many, a).cpu(),
                       rg.pil_rotate_nearest_batched(many.cpu(), a))


def test_pil_rotate_nearest_float_path_equals_plain(rng, cuda):
    """1x3x40000x1 (Pillow's f64 path: every angle flagged) and a batch
    mixing flagged and fixed-point images (90 degrees fits at 3x40000)."""
    x = torch.from_numpy(rng.integers(0, 256, (3, 3, 40000, 1), dtype=np.uint8)).to(cuda)
    a = np.asarray([7.0, 90.0, 180.0], np.float32)
    assert rg.pil_rotate_coeffs(a, 40000, 3).flagged.tolist() == [True, False, True]
    before = mk.LAUNCHES["pil_rotate_nearest"]
    got = rg.pil_rotate_nearest_batched(x, a)
    assert mk.LAUNCHES["pil_rotate_nearest"] == before + 1
    assert torch.equal(got.cpu(), rg.pil_rotate_nearest_batched(x.cpu(), a))
    one = rg.pil_rotate_nearest_batched(x[:1], 7.0)
    assert torch.equal(one.cpu(), rg.pil_rotate_nearest_batched(x[:1].cpu(), 7.0))


def test_warp_ops_route_to_the_kernels_on_the_card(rng, cuda):
    x = torch.from_numpy(rng.integers(0, 256, (2, 40, 45, 3), dtype=np.uint8)).to(cuda)
    before = dict(mk.LAUNCHES)
    rot, zoom = wp.apply_rotation(x, 12.5), wp.random_zoom(x, 1.2)
    assert mk.LAUNCHES["pil_rotate_nearest"] == before["pil_rotate_nearest"] + 1
    assert mk.LAUNCHES["zoom_bilinear"] == before["zoom_bilinear"] + 1
    assert rot.device.type == "cuda" and zoom.device.type == "cuda"
    assert torch.equal(zoom, wp.affine_warp(x, wp.zoom_matrix(1.2, 45, 40), method="bilinear"))
    assert torch.equal(rot.cpu(), wp.apply_rotation(x.cpu(), 12.5))
    rot135 = wp.apply_rotation(x, np.asarray([135.0, -60.0], np.float32))
    assert mk.LAUNCHES["pil_rotate_nearest"] == before["pil_rotate_nearest"] + 2
    assert torch.equal(rot135.cpu(), wp.apply_rotation(x.cpu(), [135.0, -60.0]))


# ---------------------------------------------------------------- separable blur


@pytest.mark.parametrize("shape", [(2, 48, 40, 3), (4, 5, 7, 3), (3, 33, 70, 1),
                                   (2, 17, 300, 4), (1, 1, 9, 3)])
@pytest.mark.parametrize("radius", [0.5, 1.5, 5.0])
def test_blur_separable_equals_plain(rng, cuda, shape, radius):
    """Any shape (w*c not a multiple of 128, images narrower than the
    window, one row), any channel count."""
    x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(cuda)
    before = mk.LAUNCHES["blur_separable"]
    out = bl.blur_separable(x, radius)
    torch.cuda.synchronize()
    assert mk.LAUNCHES["blur_separable"] == before + 1
    assert torch.equal(out, st.gaussian_blur_plain(x, radius))
    assert torch.equal(out.cpu(), bl.blur_separable(x.cpu(), radius))
    assert torch.equal(st.gaussian_blur(x, radius), out)  # u8 on the card: the kernel


def test_blur_separable_wide_window_and_sheared_rows(rng, cuda):
    x = torch.from_numpy(rng.integers(0, 256, (2, 40, 45, 3), dtype=np.uint8)).to(cuda)
    assert torch.equal(bl.blur_separable(x, 12.0), st.gaussian_blur_plain(x, 12.0))  # 73 taps
    out = bl.blur_to_sheared_rows(x, 1.5, 9, 200, 7)
    assert torch.equal(out.cpu(), bl.blur_to_sheared_rows(x.cpu(), 1.5, 9, 200, 7))


def test_blur_separable_row_with_zero_taps_takes_the_runtime_body(rng, cuda):
    """cv2's r 5 row has 31 taps, its outer two 0: launched as one row of
    31, the K = 31 instance finds K = 29 and runs the runtime-K body in the
    shared memory sized for the K body; the same bytes as the plain
    version."""
    x = torch.from_numpy(rng.integers(0, 256, (2, 40, 45, 3), dtype=np.uint8)).to(cuda)
    taps = torch.from_numpy(st.cv2_taps_q8(5.0)).to(cuda)
    assert taps.shape == (31,) and taps[0] == 0
    out = bl._launch(x, taps, 0, "blur_separable")
    assert torch.equal(out, st.gaussian_blur_plain(x, 5.0))


BLUR_GRID = [0.5 * i for i in range(11)]  # apply_all's radii 0:0.5:5
SHEAR_GRID = [round(0.1 * i, 1) for i in range(11)]  # apply_all's shear factors 0:0.1:1


@pytest.mark.parametrize("shape", [(12, 48, 40, 3), (12, 5, 7, 3), (12, 33, 70, 1),
                                   (12, 17, 300, 4), (12, 1, 9, 3)])
def test_blur_separable_batched_equals_plain(rng, cuda, shape):
    """One radius an image, in a shuffled order: every grid radius (0: a
    copy) and 6.0, whose 37 integer taps widen every row to 37 (the
    runtime-K body). One launch a call; the grid table's rows, gathered by
    index, give the same bytes."""
    x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(cuda)
    radii = torch.tensor(rng.permutation(BLUR_GRID + [6.0]), dtype=torch.float32, device=cuda)
    before = mk.LAUNCHES["blur_separable_batched"]
    out = bl.blur_separable_batched(x, radii)
    torch.cuda.synchronize()
    assert mk.LAUNCHES["blur_separable_batched"] == before + 1
    assert torch.equal(out, st.blur_batched_plain(x, radii))
    assert torch.equal(out[radii == 0], x[radii == 0])
    assert torch.equal(out.cpu(), bl.blur_separable_batched(x.cpu(), radii.cpu()))
    grid = radii[radii <= 5.0]
    idx = torch.round(grid * 2).to(torch.int64)
    taps = batch._blur_table(tuple(BLUR_GRID), cuda)[idx]
    xg = x[radii <= 5.0].contiguous()
    assert torch.equal(bl.blur_separable_batched(xg, grid, taps=taps),
                       st.blur_batched_plain(xg, grid))


def test_apply_blur_with_an_array_runs_the_kernel(rng, cuda):
    x = torch.from_numpy(rng.integers(0, 256, (4, 40, 48, 3), dtype=np.uint8)).to(cuda)
    radii = torch.tensor([0.0, 1.5, 3.0, 5.0], device=cuda)
    before = dict(mk.LAUNCHES)
    out = st.apply_blur(x, radii)
    torch.cuda.synchronize()
    assert mk.LAUNCHES["blur_separable_batched"] == before["blur_separable_batched"] + 1
    assert mk.LAUNCHES["blur_separable"] == before["blur_separable"]
    assert torch.equal(out, st.blur_batched_plain(x, radii))
    hwc = st.apply_blur(x[1], radii[1:2])  # one HWC image: a batch of one
    assert torch.equal(hwc, out[1])


def test_blur_kernel_strides_over_more_than_65535_images(rng, cuda):
    x = torch.from_numpy(rng.integers(0, 256, (70000, 3, 4, 1), dtype=np.uint8)).to(cuda)
    radii = torch.from_numpy(np.resize(np.float32(BLUR_GRID), 70000)).to(cuda)
    assert torch.equal(bl.blur_separable(x, 1.5), st.gaussian_blur_plain(x, 1.5))
    assert torch.equal(bl.blur_separable_batched(x, radii), st.blur_batched_plain(x, radii))


# ---------------------------------------------------------------- row shifts, 3-shear


@pytest.mark.parametrize("shape", NEW_KERNEL_SHAPES)
def test_shear_rows_shared_and_gray_equal_plain(rng, cuda, shape):
    """One shift vector for the batch, within and beyond an explicit
    pad_px (saturation), with and without the grayscale post-op."""
    n, h, w, c = shape
    x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(cuda)
    shifts = ((rng.random(h) - 0.5) * 30.0).astype(np.float32)
    for pad_px, postop in ((None, None), (6, None), (None, "grayscale"), (6, "grayscale")):
        if postop and c != 3:
            continue
        before = mk.LAUNCHES["shear_rows"]
        out = sh.shear_rows(x, shifts, fill=9, pad_px=pad_px, postop=postop)
        torch.cuda.synchronize()
        assert mk.LAUNCHES["shear_rows"] == before + 1
        want = sh.shear_rows(x.cpu(), shifts, fill=9, pad_px=pad_px, postop=postop)
        assert torch.equal(out.cpu(), want), (pad_px, postop)


@pytest.mark.parametrize("shape", NEW_KERNEL_SHAPES)
def test_shear_rows_per_image_equals_plain(rng, cuda, shape):
    n, h, w, c = shape
    x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(cuda)
    shifts = ((rng.random((n, h)) - 0.5) * 30.0).astype(np.float32)
    for pad_px in (None, 4):
        before = mk.LAUNCHES["shear_rows_per_image"]
        out = sh.shear_rows_per_image(x, shifts, fill=3, pad_px=pad_px)
        torch.cuda.synchronize()
        assert mk.LAUNCHES["shear_rows_per_image"] == before + 1
        b_px = max(pad_px or int(np.ceil(np.abs(shifts).max())) + 1, 1)
        assert torch.equal(out, sh.shear_rows_plain(x, torch.from_numpy(shifts).to(cuda), 3,
                                                    b_px))


@pytest.mark.parametrize("angle,gray", [(15.0, False), (-44.0, True), (70.0, False)])
def test_rotate_3shear_and_blur_rotate_fused_equal_plain(rng, cuda, angle, gray):
    x = torch.from_numpy(rng.integers(0, 256, (3, 40, 45, 3), dtype=np.uint8)).to(cuda)
    before = dict(mk.LAUNCHES)
    out = sh.rotate_3shear(x, angle, fill=5, grayscale_out=gray)
    fused = sh.blur_rotate_fused(x, 1.5, angle, fill=5, grayscale_out=gray)
    torch.cuda.synchronize()
    assert mk.LAUNCHES["shear_rows"] == before["shear_rows"] + 6
    assert mk.LAUNCHES["blur_separable"] == before["blur_separable"] + 1
    assert torch.equal(out.cpu(), sh.rotate_3shear(x.cpu(), angle, fill=5, grayscale_out=gray))
    assert torch.equal(fused.cpu(), sh.blur_rotate_fused(x.cpu(), 1.5, angle, fill=5,
                                                         grayscale_out=gray))


# the redesigned row pass: channel counts 1-5, rows whose byte length is not
# a multiple of 16, w in {1, 2, 3}, a row longer than one 4 KB segment
ROW_KERNEL_SHAPES = [(2, 37, 53), (3, 23, 37), (2, 9, 1), (2, 7, 2), (3, 8, 3), (2, 5, 1500)]


@pytest.mark.parametrize("c", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("hw", ROW_KERNEL_SHAPES)
def test_shear_rows_kernel_cases_equal_plain(rng, cuda, c, hw):
    """Shifts beyond +-(w+1), b_px 1 and w+2, fill 0 / 7 / 255, shift
    stride 0 (shear_rows, with the grayscale flag at c = 3) and h
    (shear_rows_per_image), each call against the plain version, 0 LSB."""
    n, h, w = hw
    x = torch.from_numpy(rng.integers(0, 256, (n, h, w, c), dtype=np.uint8)).to(cuda)
    scale = 2.6 * (w + 3)
    s1 = ((rng.random(h) - 0.5) * scale).astype(np.float32)
    s2 = ((rng.random((n, h)) - 0.5) * scale).astype(np.float32)
    s1[0], s2[0, 0], s2[-1, -1] = -(w + 4.5), w + 1.25, 0.0
    for fill in (0, 7, 255):
        for b_px in (1, w + 2):
            for gray in ((False, True) if c == 3 else (False,)):
                before = mk.LAUNCHES["shear_rows"]
                out = sh.shear_rows(x, s1, fill, b_px, "grayscale" if gray else None)
                assert mk.LAUNCHES["shear_rows"] == before + 1
                want = sh.shear_rows_plain(x, torch.from_numpy(s1).to(cuda), fill, b_px, gray)
                assert torch.equal(out, want), (fill, b_px, gray)
            before = mk.LAUNCHES["shear_rows_per_image"]
            out = sh.shear_rows_per_image(x, s2, fill, b_px)
            assert mk.LAUNCHES["shear_rows_per_image"] == before + 1
            assert torch.equal(out, sh.shear_rows_plain(x, torch.from_numpy(s2).to(cuda), fill,
                                                        b_px)), (fill, b_px)


@pytest.mark.parametrize("c", [1, 3])
def test_shear_kernels_take_an_odd_data_ptr(rng, cuda, c):
    """A contiguous view whose data starts at an odd address (2553 bytes an
    image at c = 3): the row pass (every entry point) and the column pass."""
    base = torch.from_numpy(rng.integers(0, 256, (4, 37, 23, c), dtype=np.uint8)).to(cuda)
    x = base[1:]
    assert x.is_contiguous() and (c != 3 or x.data_ptr() % 2 == 1)
    n, h, w, _ = x.shape
    s = torch.from_numpy(((rng.random((n, h)) - 0.5) * 40.0).astype(np.float32)).to(cuda)
    assert torch.equal(sh.shear_rows(x, s[0], 7, 6), sh.shear_rows_plain(x, s[0], 7, 6))
    assert torch.equal(sh.shear_rows_per_image(x, s, 255, w + 2),
                       sh.shear_rows_plain(x, s, 255, w + 2))
    assert torch.equal(sh.shear_rows_logrouted(x, s, 255, 12), sh.shear_rows_plain(x, s, 255, 13))
    if c == 3:
        assert torch.equal(sh.shear_rows(x, s[0], 0, 20, "grayscale"),
                           sh.shear_rows_plain(x, s[0], 0, 20, True))
    sy = torch.from_numpy(((rng.random(w) - 0.5) * 30.0).astype(np.float32)).to(cuda)
    assert torch.equal(sh._col_shift(x, sy, 9, 16), sh.shear_cols_plain(x, sy, 9, 16))


def test_shear_kernels_stride_over_more_than_65535_images(rng, cuda):
    x = torch.from_numpy(rng.integers(0, 256, (70000, 3, 4, 1), dtype=np.uint8)).to(cuda)
    s = torch.from_numpy(((rng.random((70000, 3)) - 0.5) * 8.0).astype(np.float32)).to(cuda)
    assert torch.equal(sh.shear_rows_per_image(x, s, 3, 6), sh.shear_rows_plain(x, s, 3, 6))
    assert torch.equal(sh.shear_rows(x, s[1], 3, 6), sh.shear_rows_plain(x, s[1], 3, 6))
    sy = torch.from_numpy(np.float32([-1.5, 0.25, 2.75, -4.0])).to(cuda)
    assert torch.equal(sh._col_shift(x, sy, 3, 5), sh.shear_cols_plain(x, sy, 3, 5))


def test_shear_rows_indexes_more_than_2_to_the_32_segments(cuda):
    """65537 images of 65536 one-byte rows: 2**32 + 65536 row segments, past
    the 32-bit index path, onto the 64-bit one. Rows are independent, so
    each slice of the output equals the plain version of that slice."""
    n, h = 65537, 65536
    gen = torch.Generator(device=cuda).manual_seed(7)
    x = torch.empty((n, h, 1, 1), dtype=torch.uint8, device=cuda).random_(0, 256, generator=gen)
    # shifts in (-1, 1): every output byte lerps its source byte with fill
    s = ((torch.rand(h, generator=gen, device=cuda) - 0.5) * 1.98).contiguous()
    s[:3] = torch.tensor([-1.25, 0.5, 0.0])
    out = sh.shear_rows(x, s, 9, 3)
    for lo in (0, n // 2, n - 3):
        assert torch.equal(out[lo:lo + 3], sh.shear_rows_plain(x[lo:lo + 3], s, 9, 3)), lo
    del x, out


@pytest.mark.parametrize("c", [1, 3, 4, 5])
@pytest.mark.parametrize("shape", [(2, 37, 53), (3, 70, 45), (1, 160, 300), (64, 32, 32)])
def test_column_pass_equals_plain(rng, cuda, c, shape):
    """The column pass against shear_cols_plain and the transposed row pass:
    Paeth shifts at several angles and random shift vectors, including spans
    wider than the kernel's stage (taps read from device memory)."""
    n, h, w = shape
    x = torch.from_numpy(rng.integers(0, 256, (n, h, w, c), dtype=np.uint8)).to(cuda)
    vectors = [sh._rotation_shifts(h, w, a, cuda)[2:] for a in (15.0, -44.0, 80.0)]
    for spread in (0.5, 3.0):
        s = ((rng.random(w) - 0.5) * 2 * spread * (h + 3)).astype(np.float32)
        vectors.append((torch.from_numpy(s).to(cuda), int(np.ceil(np.abs(s).max())) + 1))
        vectors.append((torch.from_numpy(s).to(cuda), 2))
    for sy, b_px in vectors:
        for fill in (0, 255):
            before = dict(mk.LAUNCHES)
            out = sh._col_shift(x, sy, fill, b_px)
            assert mk.LAUNCHES["shear_cols"] == before["shear_cols"] + 1
            assert mk.LAUNCHES["shear_rows"] == before["shear_rows"] + 1
            want = sh.shear_cols_plain(x, sy, fill, b_px)
            assert torch.equal(out, want), (b_px, fill)
            assert torch.equal(out, sh._swap_hw(sh.shear_rows_plain(sh._swap_hw(x), sy, fill,
                                                                    b_px)))


def test_rotate_3shear_is_three_launches_and_no_transpose(rng, cuda, monkeypatch):
    x = torch.from_numpy(rng.integers(0, 256, (3, 40, 45, 3), dtype=np.uint8)).to(cuda)
    want = sh.rotate_3shear_plain(x, 15.0, fill=5, grayscale_out=True)
    want_fused = sh.blur_rotate_fused_plain(x, 1.5, -30.0)

    def no_transpose(_):
        raise AssertionError("transposed on the card")

    monkeypatch.setattr(sh, "_swap_hw", no_transpose)
    before = mk.LAUNCHES["shear_rows"]
    cols = mk.LAUNCHES["shear_cols"]
    out = sh.rotate_3shear(x, 15.0, fill=5, grayscale_out=True)
    assert mk.LAUNCHES["shear_rows"] == before + 3
    assert mk.LAUNCHES["shear_cols"] == cols + 1
    assert torch.equal(out, want)
    assert torch.equal(sh.blur_rotate_fused(x, 1.5, -30.0), want_fused)
    assert mk.LAUNCHES["shear_rows"] == before + 6
    assert mk.LAUNCHES["shear_cols"] == cols + 2


@pytest.mark.parametrize("shape,radius,angle,gray,stream", [
    ((2, 40, 36), 1.5, 60.0, True, True),
    ((2, 40, 36), 0.0, -80.0, False, False),
    ((2, 5, 7), 1.5, 15.0, True, True),    # smaller than the window: blurred first
    ((2, 5, 7), 1.5, 0.0, False, False),
])
def test_fused_beyond_45_and_tiny_images_equal_plain(rng, cuda, shape, radius, angle, gray,
                                                     stream):
    imgs = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    got = _run(imgs, cuda, radius, angle, gray, stream, 0)
    assert torch.equal(got, _run(imgs, "cpu", radius, angle, gray, stream, 0))


CHAIN_CASES = {
    "strict blur>rotate>gray": ([("blur", {"radius": 1.5}), ("rotation", {"angle": 15.0}),
                                 ("grayscale", {})], {"strict_parity": True}),
    "rotation 60": ([("rotation", {"angle": 60.0})], {}),
    "affine run": ([("translation", {"tx": 3, "ty": -2}), ("zoom", {"factor": 1.2}),
                    ("rotation", {"angle": 10.0})], {}),
    "photometric": ([("brightness", {"factor": 0.05}), ("contrast", {"alpha": 1.2}),
                     ("sharpness", {"factor": 1.5}), ("histogram_equalization", {}),
                     ("invert", {})], {}),
    "simple ops": ([("enhance_contrast", {"factor": 1.3}), ("enhance_color", {"factor": 0.6}),
                    ("motion_blur", {"ksize": 5}), ("scale", {"factor": 1.1}),
                    ("shear", {"factor": 0.2}), ("flip_vertical", {}),
                    ("translation", {"tx": 2.7}), ("zoom", {"factor": 1.3})], {}),
}


@pytest.mark.parametrize("name", sorted(CHAIN_CASES))
def test_chain_routes_on_the_card_equal_the_cpu(rng, cuda, name):
    """Every route of build_chain_fn on the card equals the CPU route. The
    rotation matrices are computed on each device (cos and sin may differ by
    an ulp between them), so the affine-warp routes are held to <= 1 LSB on
    <= 1% of values; the others to 0."""
    ops, kwargs = CHAIN_CASES[name]
    imgs = rng.integers(0, 256, (2, 40, 48, 3), dtype=np.uint8)
    chain = [OpSpec(n, dict(p)) for n, p in ops]
    out = build_chain_fn(chain, **kwargs)(imgs)
    assert out.device.type == "cuda"
    want = build_chain_fn(chain, device="cpu", **kwargs)(imgs)
    err = (out.cpu().to(torch.int16) - want.to(torch.int16)).abs()
    if name in ("rotation 60", "affine run"):
        assert int(err.max()) <= 1 and float((err > 0).float().mean()) <= 0.01
    else:
        assert int(err.max()) == 0


# ---------------------------------------------------------------- the sweep


def test_apply_all_on_the_card_binds_values_to_the_cpu_ops(rng, cuda):
    """Every type but the noise (whose draw is the card's) equals the CPU
    route applied with the values the card drew; the noise is
    deterministic per seed."""
    imgs = rng.integers(0, 256, (4, 40, 48, 3), dtype=np.uint8)
    res = apply_all_transformations(imgs, 11)
    again = apply_all_transformations(imgs, 11)
    assert set(res) == set(TYPES)
    for t, (values, out) in res.items():
        assert out.device.type == "cuda" and out.shape == imgs.shape
        assert torch.equal(out, again[t][1]), t
        if t == "gaussian_noise":
            continue
        ref = _apply_type(t, torch.from_numpy(imgs), values.cpu())
        assert torch.equal(out.cpu(), ref), t


@pytest.mark.parametrize("fast,rotation", [(True, False), (True, True), (False, True)])
def test_apply_all_flags_on_the_card_bind_values_to_the_cpu_ops(rng, cuda, fast, rotation):
    """The fast scale and shear and the PIL rotation (host coefficients)
    bit-equal to the CPU route on the values the card drew."""
    imgs = rng.integers(0, 256, (4, 40, 48, 3), dtype=np.uint8)
    flags = {"pil_parity_scale_shear": not fast, "pil_parity_rotation": rotation}
    res = apply_all_transformations(imgs, 11, **flags)
    assert set(res) == set(TYPES)
    x = torch.from_numpy(imgs)
    for t, (values, out) in res.items():
        assert out.device.type == "cuda" and out.shape == imgs.shape
        if t == "gaussian_noise":
            continue
        if t == "rotation" and rotation:
            assert torch.equal(out.cpu(), batch._apply_per_value(x, "rotation_pil", values.cpu()))
            continue
        ref = _apply_type(t, x, values.cpu(), pil_parity=not fast)
        assert torch.equal(out.cpu(), ref), t


def _apply_type(t, x, values, pil_parity=True):
    if t == "shear" and pil_parity:
        # the sweep's canvas shifts: the grid's Python floats, by drawn index
        idx = torch.searchsorted(torch.tensor(SHEAR_GRID, dtype=torch.float32), values)
        return batch._shear_pil(x, idx, values)
    if t == "scale" and pil_parity:
        return batch._apply_per_value(x, t, values)
    if t == "blur":
        return st.apply_blur(x, values)
    return batch._BATCHED_OPS[t](x, values, None)


# ---------------------------------------------------------------- prefetch


def test_prefetch_to_device_stages_batches_in_order(rng, cuda):
    """Pinned host buffers copied on a side stream: the batches arrive on
    the card, in order, equal to the host batches, with at most
    buffer_size staged ahead; the consumer can compute on each at once."""
    from imagetransformations_tpu_torch.pipeline.io import batched, prefetch_to_device

    host = rng.integers(0, 256, (10, 64, 48, 3), dtype=np.uint8)
    got = []
    for b in prefetch_to_device(batched(host, 3), buffer_size=2, device=cuda):
        assert b.device.type == "cuda" and b.dtype == torch.uint8
        got.append((b.to(torch.int32) + 1).cpu())
    assert [g.shape[0] for g in got] == [3, 3, 3, 1]
    np.testing.assert_array_equal(torch.cat(got).numpy(), host.astype(np.int32) + 1)
