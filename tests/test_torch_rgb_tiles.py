"""The tile decomposition of the rgb blur -> 3-shear rotation kernel.

``csrc/rgb_blur_rotate.cu`` runs one block an output tile and stages in
shared memory only the source footprint of its tile: S2 columns C2, S1 rows
R1, B columns C1 a chunk of R1, and the source rows and columns around them
that the blur reads (``megakernel.tile_footprint``). The host sizes the
shared memory from a bound on the shift slopes (``megakernel._tiling``,
``footprint_bound``), with no read from the device.

On the CPU (no card needed): each tile's values are computed with the plain
version's own helpers (``_blur_along``, ``_shear_x``, ``_shear_y``) from a
source, and from intermediates, in which everything outside what the kernel
stages is NaN. The tile's values must be finite and equal to the unpoisoned
ones, and the quantized tiles must equal ``rgb_blur_rotate_plain``. A lerp
at f = 0 still reads its second tap (0 * NaN is NaN), so this also holds
the rule's "+ 1". The host bound must cover every tile's real footprint.

On the card (the ``cuda`` marker; skipped without one): the kernel against
its plain version at 0 LSB over the same angles, radii, channel counts,
fills and shapes, per-image angles at the budget's edges with identity
images, more than 65535 images, an odd ``data_ptr``, one launch a call, and
the luma kernel's cases. Run there with
``python -m pytest tests/test_torch_rgb_tiles.py -q``.
"""

import math

import numpy as np
import pytest
import torch

from imagetransformations_tpu_torch.ops.hopper import megakernel as mk
from imagetransformations_tpu_torch.ops.stencil import cv2_gaussian_ksize

ANGLES = [0.0, 7.5, -7.5, 15.0, -22.5, 23.0, 45.0, -45.0, 90.0, 135.0, 170.0]
SHAPES = [(33, 65), (64, 48), (32, 32), (9, 9)]
RADII = [0.0, 1.5, 5.0]
FILLS = [0, 128, 255]
CPU = torch.device("cpu")


def _case(i: int, h: int, w: int):
    """(radius, c, fill, strict, gray) cycled over the case index; the
    radius falls to 1.0 where its window does not fit the image."""
    radius = RADII[i % 3]
    c = 1 + i % 4
    if radius > 0 and cv2_gaussian_ksize(radius) // 2 > min(h, w) - 1:
        radius = 1.0
    gray = c == 3 and i % 2 == 0
    return radius, c, FILLS[(i // 3) % 3], i % 5 != 0, gray


def _forced(spread1, spread2, h, w, p, c, ty, tx, rc):
    mr1, mc2, mc1 = mk.footprint_bound(spread1, spread2, h, w, ty, tx, rc)
    tyl, txl, rc = ty.bit_length() - 1, tx.bit_length() - 1, min(rc, mr1)
    return mk.Tiling(tyl, txl, rc, mr1, mc2, mc1,
                     mk._smem_bytes(p, c, tyl, txl, rc, mr1, mc2, mc1))


def _tilings(h, w, p, c, slopes):
    """The host's tiling for these slopes and a forced small one (many
    tiles, chunks of 4 rows)."""
    s1, s2 = mk._slope_spread(slopes[0]), mk._slope_spread(slopes[1])
    return [mk._tiling(h, w, p, c, slopes), _forced(s1, s2, h, w, p, c, 8, 16, 4)]


def _poisoned_tile(xf, taps, p, k1, f1, k2, f2, fill, strict, ident, fp, box):
    """Pre-quantization values of one tile [C, rows, cols] computed only
    from what the kernel stages: NaN elsewhere, at every pass."""
    y0, y1, x0, x1 = box
    h, w = xf.shape[-2:]
    nan = float("nan")
    b = torch.full_like(xf, nan)
    for ra, rb, cl, cr in fp["chunks"]:
        cl, cr = max(cl, 0), min(cr, w - 1)  # -1 and w: fill
        if cr < cl:
            continue
        src = torch.full_like(xf, nan)
        r0, r1, c0, c1 = max(ra - p, 0), min(rb + p, h - 1), max(cl - p, 0), min(cr + p, w - 1)
        src[:, r0:r1 + 1, c0:c1 + 1] = xf[:, r0:r1 + 1, c0:c1 + 1]
        v = mk._blur_along(mk._blur_along(src[None], taps, p, 2), taps, p, 3)[0]
        if strict:
            v = torch.round(v)
        b[:, ra:rb + 1, cl:cr + 1] = v[:, ra:rb + 1, cl:cr + 1]
    if ident:
        return b[:, y0:y1 + 1, x0:x1 + 1]
    (c2lo, c2hi), (r1lo, r1hi) = fp["c2"], fp["r1"]
    c2lo, c2hi, r1lo, r1hi = max(c2lo, 0), min(c2hi, w - 1), max(r1lo, 0), min(r1hi, h - 1)
    s1 = torch.full_like(xf, nan)
    v = mk._shear_x(b[None], k1, f1, fill, strict)[0]
    s1[:, r1lo:r1hi + 1, c2lo:c2hi + 1] = v[:, r1lo:r1hi + 1, c2lo:c2hi + 1]
    s2 = torch.full_like(xf, nan)
    v = mk._shear_y(s1[None], k2, f2, fill, strict)[0]
    s2[:, y0:y1 + 1, c2lo:c2hi + 1] = v[:, y0:y1 + 1, c2lo:c2hi + 1]
    return mk._shear_x(s2[None], k1, f1, fill, strict)[0][:, y0:y1 + 1, x0:x1 + 1]


def _check_tiles(x, taps, p, k1, f1, k2, f2, fill, strict, gray, ident, slopes):
    """Every tile of every image, under the host tiling and a forced small
    one: finite, equal to the unpoisoned values, within the host bound;
    the quantized batch equals the plain version."""
    n, h, w, c = x.shape
    want = mk.rgb_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, fill, strict, gray, ident)
    flags = torch.as_tensor(ident).reshape(-1).expand(n)
    xf = x.permute(0, 3, 1, 2).to(torch.float32)
    full = mk._blur_along(mk._blur_along(xf, taps, p, 2), taps, p, 3)
    if strict:
        full = torch.round(full)
    per_image = k1.ndim == 2
    for t in _tilings(h, w, p, c, slopes):
        ty, tx = 1 << t.tile_rows_log2, 1 << t.tile_cols_log2
        got = torch.full((n, c, h, w), float("nan"))
        for i in range(n):
            tabs = [v[i] if per_image else v for v in (k1, f1)] + \
                   [v[i] if per_image else v for v in (k2, f2)]
            ref = full[i] if flags[i] else mk._shears(full[i:i + 1], *tabs, float(fill),
                                                      strict)[0]
            for y0 in range(0, h, ty):
                for x0 in range(0, w, tx):
                    fp = mk.tile_footprint(tabs[0].numpy(), tabs[2].numpy(), h, w, y0, x0, ty,
                                           tx, t.chunk_rows, bool(flags[i]))
                    (c2lo, c2hi), (r1lo, r1hi) = fp["c2"], fp["r1"]
                    assert c2hi - c2lo + 1 <= t.max_c2 and r1hi - r1lo + 1 <= t.max_r1
                    assert len(fp["chunks"]) <= -(-t.max_r1 // t.chunk_rows)
                    assert all(cr - cl + 1 <= t.max_c1 for _, _, cl, cr in fp["chunks"])
                    box = (y0, min(y0 + ty, h) - 1, x0, min(x0 + tx, w) - 1)
                    v = _poisoned_tile(xf[i], taps, p, *tabs, float(fill), strict,
                                       bool(flags[i]), fp, box)
                    assert torch.isfinite(v).all(), (y0, x0, fp)
                    assert torch.equal(v, ref[:, box[0]:box[1] + 1, box[2]:box[3] + 1])
                    got[i, :, box[0]:box[1] + 1, box[2]:box[3] + 1] = v
        if gray:
            q = mk._replicate3(mk._l24(got[:, 0], got[:, 1], got[:, 2]))
        else:
            f = flags.reshape(-1, 1, 1, 1) != 0
            q = torch.where(f, mk.to_uint8_rint(got), mk.to_uint8_trunc(got))
            q = q.permute(0, 2, 3, 1)
        assert torch.equal(q, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("angle", ANGLES)
def test_tiles_need_only_their_footprint(rng, shape, angle):
    h, w = shape
    i = ANGLES.index(angle) + 11 * SHAPES.index(shape)
    radius, c, fill, strict, gray = _case(i, h, w)
    x = torch.from_numpy(rng.integers(0, 256, (2, h, w, c), dtype=np.uint8))
    taps, p, k1, f1, k2, f2 = mk._params(h, w, radius, angle, CPU)
    _check_tiles(x, taps, p, k1, f1, k2, f2, fill, strict, gray, angle == 0.0,
                 mk.slope_bound(angle))


@pytest.mark.parametrize("shape,radius,c,strict,gray,budget", [
    ((5, 33, 65), 0.0, 3, True, False, 22.5),
    ((4, 32, 32), 1.5, 3, False, True, 23.0),
    ((4, 64, 48), 5.0, 4, True, False, 45.0),
    ((6, 9, 9), 1.0, 1, False, False, 22.5),
    ((3, 33, 65), 1.5, 2, True, False, 90.0),
])
def test_per_image_tiles_need_only_their_footprint(rng, shape, radius, c, strict, gray, budget):
    """Per-image angles from the rotation grid with the budget's edges and
    identity images mixed in."""
    n, h, w = shape
    grid = [-budget, 0.0, budget, -22.5 + 2.5 * 3, 0.0, 12.5]
    angles = np.resize(np.asarray(grid, np.float32), n)
    x = torch.from_numpy(rng.integers(0, 256, (n, h, w, c), dtype=np.uint8))
    taps, p = mk._params(h, w, radius, 0.0, CPU)[:2]
    k1, f1, k2, f2, ident = mk._traced_params(angles, n, h, w, budget, CPU)
    assert int(ident.sum()) >= 1
    _check_tiles(x, taps, p, k1, f1, k2, f2, 0, strict, gray, ident,
                 mk.budget_slope_bound(budget))


@pytest.mark.parametrize("shape", [(512, 512), (224, 224), (32, 32), (33, 65), (600, 97)])
def test_host_bound_covers_every_tile(shape):
    """The shared memory sized from the slopes alone holds the footprint of
    every tile the kernel runs, static tables at many angles (up to the
    k clip near 180 degrees) and f32 per-image tables at the budget."""
    h, w = shape
    for angle in [0.0, 2.5, -15.0, 22.5, 45.0, -60.0, 90.0, 120.0, -135.0, 170.0, 179.9, 200.0]:
        _, _, k1, _, k2, _ = mk._params(h, w, 0.0, angle, CPU)
        _assert_covered(k1.numpy()[None], k2.numpy()[None], h, w, mk.slope_bound(angle))
    for budget in (22.5, 45.0, 90.0):
        angles = np.linspace(-budget, budget, 9, dtype=np.float32)
        k1, _, k2, _, _ = mk._traced_params(angles, 9, h, w, budget, CPU)
        _assert_covered(k1.numpy(), k2.numpy(), h, w, mk.budget_slope_bound(budget))


def _assert_covered(k1s, k2s, h, w, slopes):
    t = mk._tiling(h, w, 4, 3, slopes)
    ty, tx = 1 << t.tile_rows_log2, 1 << t.tile_cols_log2
    assert (ty, tx) in mk._TILE_SHAPES and t.smem <= mk._SMEM_MAX
    for k1, k2 in zip(k1s, k2s):
        for y0 in range(0, h, ty):
            for x0 in range(0, w, tx):
                fp = mk.tile_footprint(k1, k2, h, w, y0, x0, ty, tx, t.chunk_rows)
                assert fp["c2"][1] - fp["c2"][0] + 1 <= t.max_c2
                assert fp["r1"][1] - fp["r1"][0] + 1 <= t.max_r1
                assert all(cr - cl + 1 <= t.max_c1 for _, _, cl, cr in fp["chunks"])


def test_a_tiling_fits_at_any_angle_size_and_radius():
    """Chunks of R1 keep the footprint bounded where k1 jumps by w a row."""
    for h, w in ((4096, 4096), (64, 8192), (2048, 3)):
        for angle in (0.0, 45.0, 90.0, 135.0, 179.0, 179.99, 180.0):
            for p, c in ((0, 3), (4, 3), (15, 5)):
                if p > min(h, w) - 1:
                    continue
                t = mk._tiling(h, w, p, c, mk.slope_bound(angle))
                assert t.smem <= mk._SMEM_MAX
                assert t.smem == mk._smem_bytes(p, c, *t[:6])
    # the default chain's tiles at 512x512: three blocks an SM
    assert 3 * (mk._tiling(512, 512, 4, 3, mk.slope_bound(15.0)).smem + 1024) <= mk._SM_SMEM


def test_table_spread_matches_the_slope_bound():
    """The exact spreads read from tables never exceed the slope bound."""
    for angle in (7.5, 45.0, 135.0):
        _, _, k1, _, k2, _ = mk._params(200, 300, 0.0, angle, CPU)
        a, b = mk.slope_bound(angle)
        t1, s1 = mk._table_spread(k1), mk._slope_spread(a)
        t2, s2 = mk._table_spread(k2), mk._slope_spread(b)
        for count in (1, 2, 7, 32, 64, 150, 200):
            assert t1(count) <= s1(count)
        for count in (1, 3, 64, 300):
            assert t2(count) <= s2(count)
    assert mk._slope_spread(math.inf)(2) >= 1 << 29


# ------------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _kernel_vs_plain(x, radius, angle, fill, strict, gray):
    n, h, w, c = x.shape
    taps, p, k1, f1, k2, f2 = mk._params(h, w, radius, angle, x.device)
    want = mk.rgb_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, fill, strict, gray,
                                    angle == 0.0)
    before = mk.LAUNCHES["rgb_blur_rotate"]
    got = mk.rgb_blur_rotate(x, taps, p, k1, f1, k2, f2, fill, strict, gray, angle == 0.0,
                             slopes=mk.slope_bound(angle))
    direct = mk.rgb_blur_rotate(x, taps, p, k1, f1, k2, f2, fill, strict, gray, angle == 0.0)
    torch.cuda.synchronize()
    assert mk.LAUNCHES["rgb_blur_rotate"] == before + 2
    assert torch.equal(got, want) and torch.equal(direct, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("angle", ANGLES + [-90.0, 179.9])
def test_kernel_equals_plain_on_the_card(rng, cuda, shape, angle):
    h, w = shape
    i = (ANGLES + [-90.0, 179.9]).index(angle) + 13 * SHAPES.index(shape)
    radius, c, fill, strict, gray = _case(i, h, w)
    x = torch.from_numpy(rng.integers(0, 256, (3, h, w, c), dtype=np.uint8)).to(cuda)
    _kernel_vs_plain(x, radius, angle, fill, strict, gray)
    _kernel_vs_plain(x, radius, angle, fill, not strict, False)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 2, 3, 4, 5])
def test_radius_0_and_5_every_channel_count(rng, cuda, c):
    """p = 0 (no blur pass) and p = 15 (the generic body) on one batch."""
    x = torch.from_numpy(rng.integers(0, 256, (2, 40, 70, c), dtype=np.uint8)).to(cuda)
    for radius in (0.0, 5.0):
        for angle in (15.0, -45.0, 0.0):
            _kernel_vs_plain(x, radius, angle, 255, True, False)
            _kernel_vs_plain(x, radius, angle, 0, False, False)


@pytest.mark.cuda
@pytest.mark.parametrize("budget,radius,stream", [(22.5, 0.0, False), (23.0, 1.5, True),
                                                  (45.0, 1.5, False), (90.0, 0.0, False)])
def test_per_image_angles_at_the_budget_edges(rng, cuda, budget, radius, stream):
    n, h, w = 7, 48, 64
    angles = np.asarray([-budget, budget, 0.0, budget * 0.999, 0.0, -0.1, 12.5], np.float32)
    x = torch.from_numpy(rng.integers(0, 256, (n, h, w, 3), dtype=np.uint8)).to(cuda)
    taps, p = mk._params(h, w, radius, 0.0, x.device)[:2]
    k1, f1, k2, f2, ident = mk._traced_params(angles, n, h, w, budget, x.device)
    before = mk.LAUNCHES["rgb_blur_rotate_traced"]
    out = mk.fused_blur_rotate_batched(x, radius, angles, stream=stream, max_angle_deg=budget)
    torch.cuda.synchronize()
    assert mk.LAUNCHES["rgb_blur_rotate_traced"] == before + 1
    want = mk.rgb_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, 0, not stream, False, ident)
    assert torch.equal(out, want)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [None, 1])
def test_more_than_65535_images_and_an_odd_data_ptr(rng, cuda, monkeypatch, batch):
    """Batch 1: 65537 blocks of one image in grid y, capped at 65535, so
    blocks loop over the images."""
    if batch is not None:
        monkeypatch.setattr(mk, "_batch", lambda *_: batch)
    n, h, w, c = 65537, 6, 5, 3
    base = torch.from_numpy(rng.integers(0, 256, (n * h * w * c + 1,), dtype=np.uint8)).to(cuda)
    x = base[1:].view(n, h, w, c)
    assert x.data_ptr() % 2 == 1
    for angle in (20.0, 0.0):
        _kernel_vs_plain(x, 0.0, angle, 9, True, False)
    _kernel_vs_plain(x[:3], 1.0, 33.0, 0, False, True)


@pytest.mark.cuda
def test_entry_points_size_the_stage_on_the_host(rng, cuda, monkeypatch):
    """No table is read back on the entry points' path."""
    def no_read(*_):
        raise AssertionError("the tables were read from the card")

    monkeypatch.setattr(mk, "_table_spread", no_read)
    x = torch.from_numpy(rng.integers(0, 256, (2, 64, 48, 3), dtype=np.uint8)).to(cuda)
    for stream in (False, True):
        mk.fused_blur_rotate_image(x, 1.5, 135.0, stream=stream)
        mk.fused_blur_rotate_batched(x, 0.0, [-22.5, 22.5], stream=stream)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("shape,radius,angle,fill", [((2, 130, 48), 1.5, 15.0, 0),
                                                     ((64, 32, 32), 1.5, 15.0, 0),
                                                     ((2, 70, 45), 2.5, -30.0, 255)])
def test_luma_kernel_unchanged(rng, cuda, shape, radius, angle, fill):
    x = torch.from_numpy(rng.integers(0, 256, (*shape, 3), dtype=np.uint8)).to(cuda)
    n, h, w = shape
    taps, p, k1, f1, k2, f2 = mk._params(h, w, radius, angle, x.device)
    got = mk.fused_blur_rotate_image(x, radius, angle, fill=fill, grayscale_out=True,
                                     stream=True)
    assert torch.equal(got, mk.luma_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, fill))
