"""The staged rows of the per-image resampling kernels.

``csrc/shear_bicubic.cu`` (#11) runs units of (image, row, segment): a team
finds the segment's valid run [xa, xb] (xx is monotone in x), stages source
positions [x0(xa) - 1, x0(xb) + 2] of the row as f32 with the edge value
outside [0, w), and reads every tap from that stage. ``csrc/zoom_bilinear.cu``
(#10) runs units of (image, band of R output rows): the valid columns
[xa, xe) and the band's valid rows [ya, ye), then source rows
[min i0(y), max i1(y)] at columns [min i0(x), max i1(x)] staged as f32, in
sub-bands of halves where the rows need more than the stage's ``cap``.

On the CPU (no card needed): a torch model of each kernel's units computes
every unit from a source that is NaN outside the span the unit stages, by
the kernel's rule. It must equal ``shear_bicubic_plain`` /
``zoom_bilinear_plain`` at 0 LSB with no NaN reaching a valid output: no
tap reads outside the stage. The plain versions are held against the JAX
kernels in interpret mode on the same edge shapes, with the factors each
JAX entry point accepts and its budget arguments; outside that range
(s < 0) the model and the plain version only against each other.

On the card (the ``cuda`` marker; skipped without one): both kernels
against their plain versions at 0 LSB in the same cases, and on shapes
that select each of the kernels' routes: #11's row segments (w > 1024) and
its taps read from device memory where a row's shift drifts past the
stage; #10's bands of 1, 3 and h rows, sub-bands, a stage cut to fit
shared memory and the direct route (rows too wide for two stage rows);
more than 65535 images at an odd ``data_ptr``, h > 65535, and the CIFAR
shape's block packing. Run there with
``python -m pytest tests/test_torch_resample_rows.py -q``.
"""

import numpy as np
import pytest
import torch

from imagetransformations_tpu_torch.ops.hopper import megakernel as mk
from imagetransformations_tpu_torch.ops.hopper import resample as rs

SHEAR_FACTORS = [0.0, 0.05, 0.5, 1.0, 1.05]
ZOOM_FACTORS = [0.5, 0.85, 1.0, 1.45, 4.0]
CHANNELS = [1, 2, 3, 4, 5]
# (h, w): w = 1, 2, 3, odd h and w, w*c not a multiple of 16
SHEAR_SHAPES = [(7, 1), (6, 2), (9, 3), (13, 29)]
ZOOM_SHAPES = [(9, 7), (6, 2), (13, 3)]
ZOOM_BANDS = [1, 3, None]  # None: R = h


def _jax():
    """jax.numpy, the JAX package's warp ops and its resample kernels; the
    JAX tests skip where JAX is not installed (the card's machine)."""
    jnp = pytest.importorskip("jax.numpy")
    from imagetransformations_tpu.ops import warp as jwp
    from imagetransformations_tpu.ops.pallas import resample as jrs

    return jnp, jwp, jrs


def _images(rng, n, h, w, c):
    return torch.from_numpy(rng.integers(0, 256, (n, h, w, c), dtype=np.uint8))


def _cubic(cm1, c0, c1, c2, fx):
    """The plain version's A = -1 cubic, clip and trunc, op for op."""
    p2 = -cm1 + c1
    p3 = ((2.0 * (cm1 - c0)) + c1) - c2
    p4 = ((-cm1 + c0) - c1) + c2
    out = c0 + fx * (p2 + fx * (p3 + fx * p4))
    return torch.where(out <= 0, 0.0, torch.where(out >= 255, 255.0, torch.trunc(out)))


def shear_units(x: torch.Tensor, factors: torch.Tensor, seg: int = 0) -> torch.Tensor:
    """#11 by units of (image, row, segment of ``seg`` pixels; 0: the whole
    row): each unit reads its taps from a row that holds f32 source values
    (the edge value outside [0, w)) only at positions [x0(xa) - 1,
    x0(xb) + 2] of its valid run [xa, xb], NaN elsewhere."""
    n, h, w, c = x.shape
    seg = seg or w
    s = factors.reshape(n, 1, 1)
    m2 = -torch.where(s > 0, torch.ceil(s * float(h)), 0.0)
    xo = torch.arange(w, dtype=torch.float32).view(1, 1, w) + 0.5
    yo = torch.arange(h, dtype=torch.float32).view(1, h, 1) + 0.5
    xx = (xo + s * yo) + m2
    xin = xx - 0.5
    fl = torch.floor(xin)
    x0 = torch.where(torch.isfinite(fl), fl, 0.0).clamp(-2, w + 1).to(torch.int64)
    fx = (xin - fl)[..., None]
    valid = (xx >= 0) & (xx < w)
    pos = torch.arange(-2, w + 2)  # stage positions, edge-replicated source
    row = x.to(torch.float32)[:, :, pos.clamp(0, w - 1)]  # [n, h, w + 4, c]
    out = torch.full((n, h, w, c), 255.0)
    for px0 in range(0, w, seg):
        px1 = min(px0 + seg, w)
        v = valid[..., px0:px1]
        idx = torch.arange(px0, px1)
        xa = torch.where(v, idx, w).amin(-1).clamp(max=w - 1)
        xb = torch.where(v, idx, -1).amax(-1).clamp(min=0)
        lo = torch.gather(x0, 2, xa[..., None]) - 1
        hi = torch.gather(x0, 2, xb[..., None]) + 2
        inside = (pos >= lo) & (pos <= hi) & v.any(-1, keepdim=True)
        stage = torch.where(inside[..., None], row, torch.nan)

        def tap(j):
            i = (x0[..., px0:px1] + j + 2).clamp(0, w + 3)[..., None].expand(-1, -1, -1, c)
            return torch.gather(stage, 2, i)

        res = _cubic(tap(-1), tap(0), tap(1), tap(2), fx[..., px0:px1, :])
        assert not torch.isnan(res[v]).any(), "a valid pixel read outside its unit's stage"
        out[..., px0:px1, :] = torch.where(v[..., None], res, 255.0)
    return out.to(torch.uint8)


def _band_span(i0, i1, a, b):
    """Source rows (or columns) [lo, hi] of the valid run [a, b]: the taps
    are monotone in the position, so the ends bound them."""
    return min(int(i0[a]), int(i0[b])), max(int(i1[a]), int(i1[b]))


def zoom_units(x: torch.Tensor, factors: torch.Tensor, rows: int, cap=None) -> torch.Tensor:
    """#10 by units of (image, band of ``rows`` output rows): each sub-band
    (the valid rows, halved until their source rows fit ``cap``; None:
    never) reads from an image that holds f32 source values only at the
    rows and columns the unit stages, NaN elsewhere."""
    n, h, w, c = x.shape
    inv = 1.0 / factors.reshape(n, 1)
    x0, x1, fx, vx = rs.zoom_axis(inv, w)
    y0, y1, fy, vy = rs.zoom_axis(inv, h)
    v = x.to(torch.float32)
    out = torch.zeros((n, h, w, c))
    for i in range(n):
        cols = vx[i].nonzero().flatten()
        if cols.numel() == 0:
            continue
        c0, c1 = _band_span(x0[i], x1[i], cols[0], cols[-1])
        for yb0 in range(0, h, rows):
            valid_rows = yb0 + vy[i, yb0:yb0 + rows].nonzero().flatten()
            if valid_rows.numel() == 0:
                continue
            y, ye = int(valid_rows[0]), int(valid_rows[-1]) + 1
            while y < ye:
                S = ye - y
                while True:
                    r0, r1 = _band_span(y0[i], y1[i], y, y + S - 1)
                    if cap is None or r1 - r0 + 1 <= cap or S == 1:
                        break
                    S = (S + 1) // 2
                stage = torch.full((h, w, c), torch.nan)
                stage[r0:r1 + 1, c0:c1 + 1] = v[i, r0:r1 + 1, c0:c1 + 1]
                ys = torch.arange(y, y + S)

                def hpass(src_rows):
                    r = stage[src_rows]  # [S, w, c]
                    a, b = r[:, x0[i]], r[:, x1[i]]
                    return torch.where(vx[i][None, :, None], a + fx[i][None, :, None] * (b - a),
                                       0.0)

                top, bot = hpass(y0[i, ys]), hpass(y1[i, ys])
                o = torch.clamp(torch.trunc(top + fy[i, ys][:, None, None] * (bot - top)), 0, 255)
                assert not torch.isnan(o).any(), "a valid pixel read outside its unit's stage"
                out[i, y:y + S] = o
                y += S
    return out.to(torch.uint8)


# ---------------------------------------------------------------- #11 on the CPU


@pytest.mark.parametrize("hw", SHEAR_SHAPES)
@pytest.mark.parametrize("c", CHANNELS)
def test_shear_units_equal_plain(rng, c, hw):
    """The grid's edge factors, s > max_shear (rows with no valid pixel)
    and s < 0 (m2 = 0)."""
    x = _images(rng, 8, *hw, c)
    f = torch.tensor(SHEAR_FACTORS + [-0.4, 0.3, 2.5], dtype=torch.float32)
    assert torch.equal(shear_units(x, f), rs.shear_bicubic_plain(x, f))


@pytest.mark.parametrize("seg", [5, 16, 48])
def test_shear_segments_equal_plain(rng, seg):
    x = _images(rng, 6, 11, 50, 3)
    f = torch.tensor(SHEAR_FACTORS + [-0.4], dtype=torch.float32)
    assert torch.equal(shear_units(x, f, seg), rs.shear_bicubic_plain(x, f))


def test_shear_rows_with_no_valid_pixel_stage_nothing(rng):
    """At s = 1.05 the canvas shift ceil(s*h) leaves the top rows with no
    valid pixel: those rows are all fill (255), whatever the source."""
    x = _images(rng, 2, 17, 9, 3)
    f = torch.tensor([1.05, 1.0], dtype=torch.float32)
    s = 1.05
    xx = (torch.arange(9) + 0.5)[None, :] + (s * (torch.arange(17) + 0.5) - np.ceil(s * 17))[:, None]
    empty = ~((xx >= 0) & (xx < 9)).any(1)
    assert empty.any()
    out = shear_units(x, f)
    assert (out[0][empty] == 255).all()
    assert torch.equal(out, rs.shear_bicubic_plain(x, f))


def test_shear_negative_factor_takes_no_canvas_shift(rng):
    """s < 0: m2 = 0 (the rule's else branch), so xx = x + 0.5 + s*(y + 0.5)."""
    x = _images(rng, 3, 8, 12, 1)
    f = torch.tensor([-0.25, -1.0, -0.05], dtype=torch.float32)
    out = shear_units(x, f)
    assert torch.equal(out, rs.shear_bicubic_plain(x, f))
    # row 0 of s = -0.25: xx = x + 0.5 - 0.125, valid for every x
    assert (out[0, 0] != 255).any()


@pytest.mark.parametrize("shape", [(5, 9, 3, 1), (5, 13, 29, 5), (5, 6, 2, 4), (5, 7, 2, 3)])
def test_shear_plain_matches_jax_on_edge_shapes(rng, shape):
    jnp, _, jrs = _jax()
    imgs = rng.integers(0, 256, shape, dtype=np.uint8)
    f = np.asarray(SHEAR_FACTORS, np.float32)
    out = rs.shear_bicubic_batched(torch.from_numpy(imgs), f, max_shear=1.05).numpy()
    want = np.asarray(jrs.shear_bicubic_batched(jnp.asarray(imgs), jnp.asarray(f),
                                                max_shear=1.05))
    assert np.array_equal(out, want)


def test_shear_one_pixel_wide_follows_apply_shear(rng):
    """w = 1: every tap clamps to pixel 0, so each valid output is the
    cubic of four equal taps. The port equals the exact op
    ``apply_shear(...)[:, :, :1]``; the JAX kernel's border remaps assume
    w >= 2 and depart from it (ROADMAP C.2)."""
    jnp, jwp, jrs = _jax()
    imgs = rng.integers(0, 256, (5, 7, 1, 3), dtype=np.uint8)
    f = np.asarray(SHEAR_FACTORS, np.float32)
    out = rs.shear_bicubic_batched(torch.from_numpy(imgs), f).numpy()
    ref = np.concatenate([np.asarray(jwp.apply_shear(imgs[i:i + 1], float(v)))[:, :, :1]
                          for i, v in enumerate(f)])
    assert np.array_equal(out, ref)
    want = np.asarray(jrs.shear_bicubic_batched(jnp.asarray(imgs), jnp.asarray(f)))
    assert not np.array_equal(want, ref)


# ---------------------------------------------------------------- #10 on the CPU


@pytest.mark.parametrize("rows", ZOOM_BANDS)
@pytest.mark.parametrize("hw", ZOOM_SHAPES)
@pytest.mark.parametrize("c", CHANNELS)
def test_zoom_units_equal_plain(rng, c, hw, rows):
    x = _images(rng, 5, *hw, c)
    f = torch.tensor(ZOOM_FACTORS, dtype=torch.float32)
    assert torch.equal(zoom_units(x, f, rows or hw[0]), rs.zoom_bilinear_plain(x, f))


@pytest.mark.parametrize("cap", [2, 3, 5])
def test_zoom_sub_bands_equal_plain(rng, cap):
    """A stage of ``cap`` rows: zooms out need sub-bands (f = 0.5 reads
    about 2 source rows an output row)."""
    x = _images(rng, 7, 15, 11, 3)
    f = torch.tensor(ZOOM_FACTORS + [0.3, 0.7], dtype=torch.float32)
    assert torch.equal(zoom_units(x, f, 15, cap), rs.zoom_bilinear_plain(x, f))


def _zoom_numpy_f32(imgs, factors):
    """The JAX kernels' arithmetic (resample.py _coords, _hpass_kernel,
    _vpass_kernel) in numpy f32, every op rounded on its own."""
    f32 = np.float32
    n, h, w, _ = imgs.shape
    out = np.empty_like(imgs)
    for i in range(n):
        inv = f32(1.0) / f32(factors[i])

        def axis(dim):
            half = f32(dim / 2.0)
            src = inv * (np.arange(dim, dtype=f32) + f32(0.5)) + (half - inv * half)
            sm = src - f32(0.5)
            s0 = np.floor(sm)
            i0 = np.clip(s0, 0, dim - 1).astype(np.int64)
            i1 = np.clip(s0 + f32(1.0), 0, dim - 1).astype(np.int64)
            return i0, i1, sm - s0, (src >= 0) & (src < dim)

        x0, x1, fx, vx = axis(w)
        y0, y1, fy, vy = axis(h)
        v = imgs[i].astype(f32)

        def hpass(rows):
            a, b = v[rows][:, x0], v[rows][:, x1]
            return np.where(vx[None, :, None], a + fx[None, :, None] * (b - a), f32(0.0))

        top, bot = hpass(y0), hpass(y1)
        o = np.clip(np.trunc(top + fy[:, None, None] * (bot - top)), 0, 255)
        out[i] = np.where(vy[:, None, None], o, 0).astype(np.uint8)
    return out


@pytest.mark.parametrize("shape", [(5, 9, 7, 1), (5, 13, 3, 5), (5, 6, 2, 4), (5, 11, 29, 3)])
def test_zoom_plain_matches_jax_on_edge_shapes(rng, shape):
    """random_zoom's factor range [0.5, 4] as the JAX entry point's budget
    (min_factor, max_factor). 0 LSB against the JAX kernels' arithmetic in
    numpy f32; against the JAX kernel in interpret mode <= 1 LSB on <= 1%
    (XLA-CPU contracts m = half - inv*half and src = inv*pos + m into FMAs:
    tests/test_torch_warp.py's budget)."""
    jnp, _, jrs = _jax()
    imgs = rng.integers(0, 256, shape, dtype=np.uint8)
    f = np.asarray(ZOOM_FACTORS, np.float32)
    out = rs.zoom_bilinear_batched(torch.from_numpy(imgs), f, min_factor=0.5,
                                   max_factor=4.0).numpy()
    assert np.array_equal(out, _zoom_numpy_f32(imgs, f))
    want = np.asarray(jrs.zoom_bilinear_batched(jnp.asarray(imgs), jnp.asarray(f),
                                                min_factor=0.5, max_factor=4.0))
    err = np.abs(out.astype(int) - want.astype(int))
    assert err.max() <= 1 and (err > 0).mean() <= 0.01, (err.max(), (err > 0).mean())


# ------------------------------------------- #11's drifting shift (CPU side)

# (s, h, w): in the last row t = s*(h - 0.5) = 2^30 - 512 and (x + 0.5) + t
# rounds to multiples of 64 or 128, so xx takes only the values 0 and 128 on
# its valid run [480, 591]: x0 - x drifts by 128 - 112 along the run, and the
# run's source span outgrows the stage (16 slots beyond the last group's
# window). The kernel then reads those taps from device memory.
DRIFT = (1024.0, 1 << 20, 592)


def _shear_stage_need(s, h, w, y):
    """The #11 kernel's staging rule for row ``y`` in numpy f32, each op
    rounded on its own: (slots the valid run needs, slots the stage holds)
    for the row's first segment, or None where the row has no valid pixel."""
    f32 = np.float32
    seg = min(w, 1024)
    capq = 16 * ((seg + 15) // 16) + 3 + 16
    m2 = -np.ceil(f32(s) * f32(h)) if s > 0 else f32(0.0)
    xx = ((np.arange(seg, dtype=f32) + f32(0.5)) + f32(s) * (f32(y) + f32(0.5))) + m2
    x0 = np.floor(xx - f32(0.5)).astype(np.int64)
    run = np.flatnonzero((xx >= 0) & (xx < w))
    if run.size == 0:
        return None
    xa, xb = run[0], run[-1]
    return int(x0[xb] + 3 - (x0[xa] - xa)), capq


def _shear_plain_rows(x: torch.Tensor, s: float, ys) -> torch.Tensor:
    """``shear_bicubic_plain`` of one image [1, h, w, c] at factor ``s``,
    output rows ``ys`` only: the same ops on [len(ys), w] (the plain
    version at h = 2^20 would hold tens of GB of intermediates)."""
    _, h, w, c = x.shape
    f = torch.tensor([s], dtype=torch.float32, device=x.device)
    m2 = -torch.where(f > 0, torch.ceil(f * float(h)), 0.0)
    yo = torch.tensor(ys, dtype=torch.float32, device=x.device).view(-1, 1) + 0.5
    xo = torch.arange(w, dtype=torch.float32, device=x.device).view(1, w) + 0.5
    xx = (xo + f * yo) + m2
    xin = xx - 0.5
    fl = torch.floor(xin)
    fx = (xin - fl)[..., None]
    v = x[0, list(ys)].to(torch.float32)  # [len(ys), w, c]

    def tap(j):
        idx = (fl.to(torch.int64) + j).clamp(0, w - 1)[..., None].expand(-1, -1, c)
        return torch.gather(v, 1, idx)

    out = _cubic(tap(-1), tap(0), tap(1), tap(2), fx)
    return torch.where(((xx >= 0) & (xx < w))[..., None], out, 255.0).to(torch.uint8)


def test_shear_plain_rows_equals_plain(rng):
    x = _images(rng, 1, 13, 29, 3)
    for s in SHEAR_FACTORS + [-0.4, 2.5]:
        f = torch.tensor([s], dtype=torch.float32)
        assert torch.equal(_shear_plain_rows(x, s, [0, 5, 12]),
                           rs.shear_bicubic_plain(x, f)[0, [0, 5, 12]])


def test_drifting_shift_outgrows_the_stage():
    """DRIFT's last row needs more slots than the stage holds, its other
    rows have no valid pixel; the grid's factors at 512x512 always fit."""
    s, h, w = DRIFT
    need, capq = _shear_stage_need(s, h, w, h - 1)
    assert need >= capq, (need, capq)
    assert all(_shear_stage_need(s, h, w, y) is None for y in range(h - 4, h - 1))
    for s in SHEAR_FACTORS:
        for y in range(0, 512, 37):
            got = _shear_stage_need(s, 512, 512, y)
            assert got is None or got[0] < got[1]


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _launch(kernel, fn):
    before = mk.LAUNCHES[kernel]
    out = fn()
    torch.cuda.synchronize()
    assert mk.LAUNCHES[kernel] == before + 1
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("hw", SHEAR_SHAPES + [(5, 1100), (3, 2100)])
@pytest.mark.parametrize("c", CHANNELS)
def test_shear_kernel_equals_plain_on_the_card(rng, cuda, c, hw):
    """Whole rows (w <= 1024), and segments of 1024 pixels (w 1100, 2100)."""
    x = _images(rng, 8, *hw, c).to(cuda)
    f = torch.tensor(SHEAR_FACTORS + [-0.4, 0.3, 2.5], dtype=torch.float32, device=cuda)
    out = _launch("shear_bicubic", lambda: rs.shear_bicubic(x, f))
    assert torch.equal(out, rs.shear_bicubic_plain(x, f))


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3])
def test_shear_drifting_shift_reads_device_memory(rng, cuda, c):
    """DRIFT (1x2^20x592): the last row's taps come from device memory."""
    s, h, w = DRIFT
    x = torch.randint(0, 256, (1, h, w, c), dtype=torch.uint8, device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(int(rng.integers(1 << 30))))
    f = torch.tensor([s], dtype=torch.float32, device=cuda)
    out = _launch("shear_bicubic", lambda: rs.shear_bicubic(x, f))
    last = list(range(h - 4, h))
    assert torch.equal(out[0, last], _shear_plain_rows(x, s, last))
    assert bool((out[0, :h - 4] == 255).all())  # no valid pixel: xx < 0


# #10's routes by shape (the host picks them from h, w and c): gw = ceil(w/16)
# threads a row, R = 256 // gw rows a band; R = h (several images a block)
# at the small shapes and (16, 33); R = 3 at w = 1100 (stage of 6 rows);
# R = 1 at w = 4100 (at c >= 4 the stage is cut to 2 rows to fit shared
# memory); R = 8 at w = 500 and R = 256 at (300, 7), whose zooms out need
# sub-bands; at w = 20000 not even two rows and the table fit: direct taps.
ZOOM_CARD_SHAPES = ZOOM_SHAPES + [(16, 33), (7, 1100), (3, 4100), (24, 500), (300, 7),
                                  (2, 20000)]


@pytest.mark.cuda
@pytest.mark.parametrize("hw", ZOOM_CARD_SHAPES)
@pytest.mark.parametrize("c", CHANNELS)
def test_zoom_kernel_equals_plain_on_the_card(rng, cuda, c, hw):
    x = _images(rng, 7, *hw, c).to(cuda)
    f = torch.tensor(ZOOM_FACTORS + [0.3, 0.9], dtype=torch.float32, device=cuda)
    out = _launch("zoom_bilinear", lambda: rs.zoom_bilinear(x, f))
    assert torch.equal(out, rs.zoom_bilinear_plain(x, f))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["shear_bicubic", "zoom_bilinear"])
def test_more_than_65535_images_at_an_odd_data_ptr(rng, cuda, kernel):
    n = 65537
    buf = torch.from_numpy(rng.integers(0, 256, n * 5 * 6 * 3 + 1, dtype=np.uint8)).to(cuda)
    x = buf[1:].view(n, 5, 6, 3)
    assert x.data_ptr() % 2 == 1
    grid = SHEAR_FACTORS if kernel == "shear_bicubic" else ZOOM_FACTORS
    f = torch.tensor(np.resize(np.asarray(grid, np.float32), n), device=cuda)
    run, plain = ((rs.shear_bicubic, rs.shear_bicubic_plain) if kernel == "shear_bicubic"
                  else (rs.zoom_bilinear, rs.zoom_bilinear_plain))
    assert torch.equal(_launch(kernel, lambda: run(x, f)), plain(x, f))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["shear_bicubic", "zoom_bilinear"])
def test_taller_than_65535_rows(rng, cuda, kernel):
    x = _images(rng, 1, 65600, 3, 1).to(cuda)
    if kernel == "shear_bicubic":
        f = torch.tensor([1e-5], device=cuda)  # shifts the rows by 0 .. 1 pixel
        out = _launch(kernel, lambda: rs.shear_bicubic(x, f))
        assert torch.equal(out, rs.shear_bicubic_plain(x, f))
    else:
        f = torch.tensor([1.2], device=cuda)
        out = _launch(kernel, lambda: rs.zoom_bilinear(x, f))
        assert torch.equal(out, rs.zoom_bilinear_plain(x, f))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["shear_bicubic", "zoom_bilinear"])
def test_cifar_block_packing(rng, cuda, kernel):
    """4096x32x32x3 on the sweep's grids: 128 rows (shear) or 4 whole
    images (zoom) a block, byte-equal to the plain version."""
    x = _images(rng, 4096, 32, 32, 3).to(cuda)
    if kernel == "shear_bicubic":
        f = torch.tensor(np.resize(np.round(np.arange(11) * 0.1, 1).astype(np.float32), 4096),
                         device=cuda)
        out = _launch(kernel, lambda: rs.shear_bicubic(x, f))
        assert torch.equal(out, rs.shear_bicubic_plain(x, f))
    else:
        f = torch.tensor(np.resize(np.asarray([0.9, 1.0, 1.1, 1.2, 1.3, 1.4, 0.85, 1.45],
                                              np.float32), 4096), device=cuda)
        out = _launch(kernel, lambda: rs.zoom_bilinear(x, f))
        assert torch.equal(out, rs.zoom_bilinear_plain(x, f))
