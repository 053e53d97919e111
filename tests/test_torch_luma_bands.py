"""The band decomposition of the luma blur -> 3-shear rotation kernel.

``csrc/luma_blur_rotate.cu`` runs two launches over units of (image, band
of rows, column segment) with one f32 plane S1 between them: the row launch
stages the source rows [y0 - p, y1 + p] of a band (reflected) at the
columns its window needs, blurs them (X, then Y) and shifts the B rows into
S1 (pass 1); the column launch reads S1 from device memory (pass 2), shifts
the S2 rows (pass 3) and quantizes. The window of a band's rows is the rule
``megakernel.luma_windows`` (sub-bands where the shifts spread wider than
the window buffer), the geometry ``megakernel._luma_geometry``.

On the CPU (no card needed): a torch model of the two launches computes
each band from a luma plane that is NaN everywhere the row launch does not
stage, shifts it through a window buffer indexed as the kernel indexes it,
and reads S1 only through the tensor that stands for device memory. It
must equal ``luma_blur_rotate_plain`` at 0 LSB, and, on shared and
per-image tables, the oracle ``fused_stream_chain`` and the JAX
``fused_blur_rotate_image`` / ``fused_blur_rotate_batched`` (Pallas in
interpret mode) within the budget of tests/test_torch_megakernel.py.

From 128 rows on, where the plane fits a thread-block cluster's shared
memory, the host takes the resident route instead
(``megakernel._resident_geometry``): one launch, a cluster of C blocks an
image, block r holding S1 rows [r*ceil(h/C), (r+1)*ceil(h/C)) on chip,
each built from its own reflected halo rows; pass 2 reads each S1 row from
the block that owns it. A torch model of that decomposition must equal the
plain version at 0 LSB too, and the route choice follows from (h, w, p).

On the card (the ``cuda`` marker; skipped without one): the kernel against
its plain version at 0 LSB in the same cases and geometries, more than
65535 images at an odd ``data_ptr``, the packed shapes, a width that needs
column segments, and per-image angles at the budget's edge; the resident
route at the chain's 1024x224x224, at 8x512x512, at odd shapes at the
route's edges, at an odd ``data_ptr``, at per-image angles and at every
angle of ``ANGLES``, each also bit-equal to the band route. Run there with
``python -m pytest tests/test_torch_luma_bands.py -q``.
"""

import numpy as np
import pytest
import torch

from imagetransformations_tpu_torch.ops.hopper import megakernel as mk

CPU = torch.device("cpu")
ANGLES = [-90.0, -30.0, 0.0, 15.0, 60.0, 135.0, 179.9]
RADII = {0: 0.0, 4: 1.5, 7: 2.5}  # p -> radius (cv2 ksize int(6r), odd)
SHAPES = [(2, 19, 23), (3, 24, 17)]  # odd h and w
G = mk.LumaGeometry


def _band_geometry(rows: int, h: int, w: int) -> "mk.LumaGeometry":
    """Whole rows in bands of ``rows`` (rows_b a little apart, so the two
    launches cut the plane differently)."""
    return G(rows, max(1, rows - 1) if rows < h else h, w, w + 2, -(-w // 4), 1)


def _params(x, radius, angle, traced):
    n, h, w, _ = x.shape
    if traced is None:
        return mk._params(h, w, radius, angle, CPU)
    taps, p = mk._params(h, w, radius, 0.0, CPU)[:2]
    k1, f1, k2, f2, _ = mk._traced_params(np.asarray(traced, np.float32), n, h, w, 180.0, CPU)
    return taps, p, k1, f1, k2, f2


def _reflect(i: torch.Tensor, n: int) -> torch.Tensor:
    i = i.abs()
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def _take(buf: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """buf[..., cols] with every index inside the buffer (no wrap)."""
    assert int(cols.min()) >= 0 and int(cols.max()) < buf.shape[-1], "read outside the window"
    return torch.gather(buf, -1, cols)


def _model(x, taps, p, k1, f1, k2, f2, fill: int, geo) -> tuple:
    """Torch model of the row and column launches, unit by unit. Returns
    (output u8 [n, h, w, 3], the number of sub-bands)."""
    n, h, w, _ = x.shape
    xi = x.to(torch.int32)
    lum = ((xi[..., 1] * 38470 + xi[..., 0] * 19595) + xi[..., 2] * 7471).to(torch.float32)
    lum = lum * (1.0 / 65536.0)
    s1 = torch.full((n, h, w), float("nan"))  # device memory between the launches
    out = torch.zeros((n, h, w), dtype=torch.uint8)
    fillf = float(fill)

    def tables(img):
        t = [v if v.ndim == 1 else v[img] for v in (k1, f1, k2, f2)]
        return [v.to(torch.int64) if v.dtype == torch.int32 else v for v in t]

    def units(rows):
        for img in range(n):
            for y0 in range(0, h, rows):
                for x0 in range(0, w, min(geo.seg_w, w)):
                    yield img, y0, min(rows, h - y0), x0, min(x0 + geo.seg_w, w)

    def lerp_window(buf, k, f, x0, x1, c0):
        """Rows of buf (window columns c0..) shifted by k [r], f [r]: the
        kernel's clamped taps (-1 and w hold fill)."""
        xs = torch.arange(x0, x1)[None, :] + k[:, None]
        a = _take(buf, (xs.clamp(-1, w) - c0))
        b = _take(buf, ((xs + 1).clamp(-1, w) - c0))
        return mk._lerp(a, b, f[:, None])

    def window_buffer(values, c0, c1):
        """[r, c1 - c0 + 1]: values at canvas columns, fill at -1 and w."""
        buf = torch.full((values.shape[0], c1 - c0 + 1), fillf)
        lo, hi = max(c0, 0), min(c1, w - 1)
        if lo <= hi:
            buf[:, lo - c0:hi - c0 + 1] = values
        return buf

    count = 0
    for img, y0, rows, x0, x1 in units(min(geo.rows_a, h)):  # row launch
        ka, fa, _, _ = tables(img)
        for ya, yb, c0, c1 in mk.luma_windows(ka[y0:y0 + rows], x0, x1, w, geo.win):
            assert c1 - c0 + 1 <= geo.win
            count += 1
            lo, hi = max(c0, 0), min(c1, w - 1)
            b = torch.empty((yb - ya, 0))
            if lo <= hi:
                src_rows = _reflect(torch.arange(y0 + ya - p, y0 + yb + p), h)
                src_cols = _reflect(torch.arange(lo - p, hi + p + 1), w)
                staged = torch.full((h, w), float("nan"))
                staged[src_rows[:, None], src_cols[None, :]] = lum[img][src_rows[:, None],
                                                                        src_cols[None, :]]
                v = mk._blur_along(mk._blur_along(staged[None, None], taps, p, 3), taps, p, 2)
                b = v[0, 0, y0 + ya:y0 + yb, lo:hi + 1]
                assert bool(torch.isfinite(b).all()), "the blur read outside the staged rows"
            buf = window_buffer(b, c0, c1)
            rr = slice(y0 + ya, y0 + yb)
            s1[img, rr, x0:x1] = lerp_window(buf, ka[rr], fa[rr], x0, x1, c0)
    assert bool(torch.isfinite(s1).all()), "the row launch left S1 unwritten"
    for img, y0, rows, x0, x1 in units(min(geo.rows_b, h)):  # column launch
        ka, fa, kc, fc = tables(img)
        for ya, yb, c0, c1 in mk.luma_windows(ka[y0:y0 + rows], x0, x1, w, geo.win):
            lo, hi = max(c0, 0), min(c1, w - 1)
            s2 = torch.empty((yb - ya, 0))
            if lo <= hi:
                ys = torch.arange(y0 + ya, y0 + yb)[:, None] + kc[None, lo:hi + 1]
                cols = torch.arange(lo, hi + 1)[None, :].expand_as(ys)

                def tap(r):
                    got = s1[img][r.clamp(0, h - 1), cols]
                    return torch.where((r >= 0) & (r < h), got, fillf)

                s2 = mk._lerp(tap(ys), tap(ys + 1), fc[None, lo:hi + 1])
            buf = window_buffer(s2, c0, c1)
            rr = slice(y0 + ya, y0 + yb)
            s3 = lerp_window(buf, ka[rr], fa[rr], x0, x1, c0)
            out[img, rr, x0:x1] = (s3 + 0.5).to(torch.int32).clamp(0, 255).to(torch.uint8)
    return out[..., None].expand(n, h, w, 3).contiguous(), count


def _cases():
    """(shape, p, angle, fill, band rows): band rows 1, 3, 8 and h over the
    angles, p and fill cycled."""
    out = []
    for i, rows in enumerate((1, 3, 8, None)):
        for j, angle in enumerate(ANGLES):
            k = i * len(ANGLES) + j
            shape = SHAPES[k % 2]
            out.append((shape, (0, 4, 7)[k % 3], angle, (0, 255)[(k // 3) % 2],
                        rows or shape[1]))
    return out


CASES = _cases()
# column segments (width 40 in segments of 16 and 8): window 34 holds the
# spread of moderate angles, window 10 splits most bands into sub-bands
SEGMENT_CASES = [
    ((2, 21, 40), 4, angle, fill, G(rows, rows, seg, win, -(-min(win, 40) // 4), 1))
    for angle, fill, rows, seg, win in [(15.0, 0, 8, 16, 34), (-30.0, 255, 5, 16, 34),
                                        (60.0, 0, 8, 8, 10), (135.0, 255, 3, 8, 10),
                                        (179.9, 0, 21, 16, 34), (-90.0, 255, 7, 8, 18)]
]


@pytest.mark.parametrize("shape,p,angle,fill,rows", CASES)
def test_bands_equal_plain(rng, shape, p, angle, fill, rows):
    x = torch.from_numpy(rng.integers(0, 256, (*shape, 3), dtype=np.uint8))
    taps, p_, k1, f1, k2, f2 = _params(x, RADII[p], angle, None)
    assert p_ == p
    got, _ = _model(x, taps, p, k1, f1, k2, f2, fill, _band_geometry(rows, *shape[1:]))
    assert torch.equal(got, mk.luma_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, fill))


@pytest.mark.parametrize("shape,p,angle,fill,geo", SEGMENT_CASES)
def test_column_segments_equal_plain(rng, shape, p, angle, fill, geo):
    x = torch.from_numpy(rng.integers(0, 256, (*shape, 3), dtype=np.uint8))
    taps, _, k1, f1, k2, f2 = _params(x, RADII[p], angle, None)
    got, count = _model(x, taps, p, k1, f1, k2, f2, fill, geo)
    assert torch.equal(got, mk.luma_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, fill))
    bands = -(-shape[1] // geo.rows_a) * -(-shape[2] // geo.seg_w) * shape[0]
    if geo.win == 10 and abs(angle) > 45:
        assert count > bands  # the shifts spread past the window: sub-bands


def test_host_geometry_routes_the_segments():
    """The host cuts rows into segments only where whole rows do not fit,
    and its window always holds one row of a segment."""
    assert mk._luma_geometry(512, 512, 4).seg_w == 512
    for h, w, p in ((600, 3000, 4), (600, 5000, 15), (2000, 2000, 500)):
        g = mk._luma_geometry(h, w, p)
        assert g.seg_w < w and g.win >= g.seg_w + 1 and g.groups == 1


def test_windows_cover_every_tap():
    """luma_windows: each sub-band's window holds every column its rows'
    taps read (clamped to -1 and w) and fits the buffer; sub-bands tile
    the band."""
    rng = np.random.default_rng(5)
    for _ in range(200):
        w = int(rng.integers(3, 60))
        k1 = rng.integers(-(w + 1), w + 2, size=int(rng.integers(1, 20)))
        seg = int(rng.integers(1, w + 1))
        x0 = int(rng.integers(0, w - seg + 1))
        win = int(rng.integers(seg + 1, 2 * seg + 3))
        ya_next = 0
        for ya, yb, c0, c1 in mk.luma_windows(k1, x0, x0 + seg, w, win):
            assert ya == ya_next and yb > ya and c1 - c0 + 1 <= win
            ya_next = yb
            for k in k1[ya:yb]:
                taps = np.clip(np.arange(x0, x0 + seg + 1) + k, -1, w)
                assert taps.min() >= c0 and taps.max() <= c1
        assert ya_next == len(k1)


def _resident_model(x, taps, p, k1, f1, k2, f2, fill: int, cluster: int) -> torch.Tensor:
    """Torch model of the resident route: per image, ``cluster`` slabs of
    ceil(h / cluster) S1 rows, each computed from a luma plane that is NaN
    outside the slab's reflected source rows [y0 - p, y1 + p); pass 2 reads
    each S1 row only through the slab that owns it. Returns u8 [n, h, w, 3]."""
    n, h, w, _ = x.shape
    xi = x.to(torch.int32)
    lum = ((xi[..., 1] * 38470 + xi[..., 0] * 19595) + xi[..., 2] * 7471).to(torch.float32)
    lum = lum * (1.0 / 65536.0)
    rows = -(-h // cluster)
    out = torch.zeros((n, h, w), dtype=torch.uint8)
    fillf = float(fill)
    for img in range(n):
        ka, fa, kc, fc = [v if v.ndim == 1 else v[img] for v in (k1, f1, k2, f2)]
        ka, kc = ka.to(torch.int64), kc.to(torch.int64)
        slabs = []
        for r in range(cluster):  # phase A: each block's slab from its own halo rows
            y0, y1 = r * rows, min((r + 1) * rows, h)
            if y1 <= y0:
                slabs.append(torch.empty((0, w)))
                continue
            src = _reflect(torch.arange(y0 - p, y1 + p), h)
            staged = torch.full((h, w), float("nan"))
            staged[src] = lum[img][src]
            b = mk._blur_along(mk._blur_along(staged[None, None], taps, p, 3), taps, p, 2)
            b = b[0, 0, y0:y1]
            assert bool(torch.isfinite(b).all()), "the blur read outside the slab's rows"
            buf = torch.full((y1 - y0, w + 2), fillf)
            buf[:, 1:w + 1] = b
            xs = torch.arange(w)[None, :] + ka[y0:y1, None]
            slabs.append(mk._lerp(_take(buf, xs.clamp(-1, w) + 1), _take(buf, (xs + 1).clamp(-1, w) + 1),
                                  fa[y0:y1, None]))
        cols = torch.arange(w)[None, :].expand(h, w)

        def tap(ys):  # S1[ys, c] through the slab that owns row ys; fill off the canvas
            inside = (ys >= 0) & (ys < h)
            yc = ys.clamp(0, h - 1)
            owner, local = yc // rows, yc % rows
            got = torch.empty(ys.shape)
            for r in range(cluster):
                m = owner == r
                if bool(m.any()):
                    got[m] = slabs[r][local[m], cols[m]]
            return torch.where(inside, got, fillf)

        ys = torch.arange(h)[:, None] + kc[None, :]
        s2 = mk._lerp(tap(ys), tap(ys + 1), fc[None, :])  # phase B: pass 2
        buf = torch.full((h, w + 2), fillf)
        buf[:, 1:w + 1] = s2
        xs = torch.arange(w)[None, :] + ka[:, None]
        s3 = mk._lerp(_take(buf, xs.clamp(-1, w) + 1), _take(buf, (xs + 1).clamp(-1, w) + 1),
                      fa[:, None])
        out[img] = (s3 + 0.5).to(torch.int32).clamp(0, 255).to(torch.uint8)
    return out[..., None].expand(n, h, w, 3).contiguous()


def _resident_cases():
    """(shape, p, angle, fill, cluster, per-image angles or None): clusters
    1, 2 and 4 over the angles, p, the shapes and fill cycled; per-image
    tables at each cluster size."""
    out = []
    for i, cluster in enumerate((1, 2, 4)):
        for j, angle in enumerate(ANGLES):
            k = i * len(ANGLES) + j
            out.append((SHAPES[k % 2], (0, 4, 7)[k % 3], angle, (0, 255)[(k // 2) % 2], cluster,
                        None))
        out.append(((3, 37, 29), (4, 7, 0)[i], None, 9, cluster, [-150.0, 22.5, 0.0]))
    return out


@pytest.mark.parametrize("shape,p,angle,fill,cluster,traced", _resident_cases())
def test_cluster_slabs_equal_plain(rng, shape, p, angle, fill, cluster, traced):
    x = torch.from_numpy(rng.integers(0, 256, (*shape, 3), dtype=np.uint8))
    taps, p_, k1, f1, k2, f2 = _params(x, RADII[p], angle, traced)
    assert p_ == p
    got = _resident_model(x, taps, p, k1, f1, k2, f2, fill, cluster)
    assert torch.equal(got, mk.luma_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, fill))


@pytest.mark.parametrize("shape,p,route", [
    ((224, 224), 4, "resident"),
    ((224, 224), 7, "resident"),
    ((128, 301), 4, "resident"),
    ((223, 227), 4, "resident"),
    ((512, 512), 4, "resident"),  # one block an SM, clusters of 16
    ((900, 500), 4, "band"),  # no cluster holds the plane
    ((127, 224), 4, "band"),  # below 128 rows: the packed shapes keep the band route
    ((32, 32), 4, "band"),
    ((2000, 2000), 4, "band"),  # beyond what a cluster holds
    ((130, 2600), 7, "band"),
])
def test_route_from_the_shapes(shape, p, route):
    """The host's route from (h, w, p) alone: the resident route's geometry
    fits a block's shared memory, with two blocks an SM where any cluster
    allows it, and it is the least cluster that reaches that count."""
    h, w = shape
    g = mk._resident_geometry(h, w, p)
    assert (g is not None) == (route == "resident")
    if g is None:
        assert isinstance(mk._luma_geometry(h, w, p), mk.LumaGeometry)
        return

    def blocks(c):  # blocks of cluster size c that fit an SM (0: none fits)
        s = mk._resident_smem(h, w, p, mk.ResidentGeometry(c))
        return 0 if s > 232448 else mk._SM_SMEM // (s + 1024)

    most = max(min(blocks(c), 2) for c in mk._RESIDENT_CLUSTERS)
    assert min(blocks(g.cluster), 2) == most >= 1
    assert all(min(blocks(c), 2) < most for c in mk._RESIDENT_CLUSTERS if c < g.cluster)
    if (h, w, p) == (224, 224, 4):
        assert g == mk.ResidentGeometry(4)


def _jax():
    """The JAX package's oracle and kernels (imported here: the card tests
    below run where only PyTorch is installed)."""
    jnp = pytest.importorskip("jax.numpy")
    from imagetransformations_tpu.oracle import fast_warp as ofw
    from imagetransformations_tpu.ops.pallas import megakernel as jmk

    return jnp, ofw, jmk


def _jax_close(out, ref, max_frac=0.001):
    err = np.abs(out.astype(int) - ref.astype(int))
    assert err.max() <= 1, err.max()
    assert (err > 0).mean() <= max_frac, (err > 0).mean()


@pytest.mark.parametrize("shape,radius,angle,fill,rows", [
    ((2, 64, 48), 1.5, 15.0, 0, 16),
    ((1, 48, 40), 2.5, -30.0, 255, 5),
    ((2, 32, 32), 1.5, 22.5, 0, 32),
])
def test_bands_match_oracle_and_jax(rng, shape, radius, angle, fill, rows):
    jnp, ofw, jmk = _jax()
    imgs = rng.integers(0, 256, (*shape, 3), dtype=np.uint8)
    x = torch.from_numpy(imgs)
    taps, p, k1, f1, k2, f2 = _params(x, radius, angle, None)
    got = _model(x, taps, p, k1, f1, k2, f2, fill, _band_geometry(rows, *shape[1:]))[0].numpy()
    ref = ofw.fused_stream_chain(imgs, radius, angle, grayscale_out=True, fill=fill)
    assert np.array_equal(got, ref)
    _jax_close(got, np.asarray(jmk.fused_blur_rotate_image(
        jnp.asarray(imgs), radius, angle, fill=fill, grayscale_out=True, stream=True)))


@pytest.mark.parametrize("angles,rows", [([-22.5, 0.0, 7.5, 22.5], 16), ([12.0, -3.0], 7)])
def test_per_image_bands_match_jax(rng, angles, rows):
    """Per-image tables ([n, h], [n, w]): the model equals the plain version
    and the JAX fused_blur_rotate_batched."""
    jnp, _, jmk = _jax()
    imgs = rng.integers(0, 256, (len(angles), 48, 40, 3), dtype=np.uint8)
    x = torch.from_numpy(imgs)
    taps, p, k1, f1, k2, f2 = _params(x, 1.5, None, angles)
    got, _ = _model(x, taps, p, k1, f1, k2, f2, 0, _band_geometry(rows, 48, 40))
    assert torch.equal(got, mk.luma_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, 0))
    _jax_close(got.numpy(), np.asarray(jmk.fused_blur_rotate_batched(
        jnp.asarray(imgs), 1.5, jnp.asarray(angles, jnp.float32), grayscale_out=True,
        stream=True)))


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on the card")
    return torch.device("cuda")


def _kernel_vs_plain(x, radius, angle, fill, geo=None, traced=None):
    n, h, w, _ = x.shape
    dev = x.device
    if traced is None:
        taps, p, k1, f1, k2, f2 = mk._params(h, w, radius, angle, dev)
    else:
        taps, p = mk._params(h, w, radius, 0.0, dev)[:2]
        k1, f1, k2, f2, _ = mk._traced_params(np.asarray(traced, np.float32), n, h, w, 180.0,
                                              dev)
    got = mk.luma_blur_rotate(x, taps, p, k1, f1, k2, f2, fill, geometry=geo)
    torch.cuda.synchronize()
    assert torch.equal(got, mk.luma_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, fill))


@pytest.mark.cuda
@pytest.mark.parametrize("shape,p,angle,fill,rows", CASES)
def test_kernel_equals_plain_on_the_card(rng, cuda, shape, p, angle, fill, rows):
    x = torch.from_numpy(rng.integers(0, 256, (*shape, 3), dtype=np.uint8)).to(cuda)
    _kernel_vs_plain(x, RADII[p], angle, fill, _band_geometry(rows, *shape[1:]))
    _kernel_vs_plain(x, RADII[p], angle, fill)  # the host's geometry


@pytest.mark.cuda
@pytest.mark.parametrize("shape,p,angle,fill,geo", SEGMENT_CASES)
def test_column_segments_on_the_card(rng, cuda, shape, p, angle, fill, geo):
    x = torch.from_numpy(rng.integers(0, 256, (*shape, 3), dtype=np.uint8)).to(cuda)
    _kernel_vs_plain(x, RADII[p], angle, fill, geo)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,radius,angle", [((2, 40, 3000), 1.5, 20.0),
                                                ((1, 130, 2600), 2.5, 170.0)])
def test_a_width_that_needs_segments(rng, cuda, shape, radius, angle):
    n, h, w = shape
    p = mk._params(h, w, radius, angle, CPU)[1]
    assert mk._luma_geometry(h, w, p).seg_w < w
    x = torch.from_numpy(rng.integers(0, 256, (*shape, 3), dtype=np.uint8)).to(cuda)
    _kernel_vs_plain(x, radius, angle, 255)


@pytest.mark.cuda
def test_more_than_65535_images_at_an_odd_data_ptr(rng, cuda):
    n, h, w = 65537, 6, 5
    base = torch.from_numpy(rng.integers(0, 256, (n * h * w * 3 + 1,), dtype=np.uint8)).to(cuda)
    x = base[1:].view(n, h, w, 3)
    assert x.data_ptr() % 2 == 1
    _kernel_vs_plain(x, 0.0, 33.0, 9)
    _kernel_vs_plain(x[:5], 0.0, 140.0, 200, G(2, 3, 2, 4, 1, 1))  # segments, sub-bands


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 32, 32), (3, 32, 32), (7, 33, 45)])
def test_packed_shapes(rng, cuda, shape):
    """Below 128 rows: several images a block; the same bytes as one band a
    block."""
    x = torch.from_numpy(rng.integers(0, 256, (*shape, 3), dtype=np.uint8)).to(cuda)
    n, h, w = shape
    g = mk._luma_geometry(h, w, 4)
    assert g.groups > 1 and g.seg_w == w
    before = mk.LAUNCHES["luma_blur_rotate_packed"]
    _kernel_vs_plain(x, 1.5, 15.0, 0)
    _kernel_vs_plain(x, 1.5, 15.0, 0, g._replace(groups=1))
    assert mk.LAUNCHES["luma_blur_rotate_packed"] == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 64, 48), (16, 160, 96)])
def test_per_image_angles_at_the_budget_edge(rng, cuda, shape):
    n = shape[0]
    x = torch.from_numpy(rng.integers(0, 256, (*shape, 3), dtype=np.uint8)).to(cuda)
    angles = np.where(np.arange(n) % 2 == 0, 22.5, -22.5).astype(np.float32)
    angles[1] = 0.0
    before = mk.LAUNCHES["luma_blur_rotate_traced"]
    out = mk.fused_blur_rotate_batched(x, 1.5, angles, grayscale_out=True, stream=True)
    assert mk.LAUNCHES["luma_blur_rotate_traced"] == before + 1
    h, w = shape[1:]
    taps, p = mk._params(h, w, 1.5, 0.0, cuda)[:2]
    k1, f1, k2, f2, _ = mk._traced_params(angles, n, h, w, 22.5, cuda)
    assert torch.equal(out, mk.luma_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, 0))
    _kernel_vs_plain(x, 1.5, None, 0, traced=angles)


def _resident_vs_plain_and_bands(x, radius, angle, fill, traced=None, geometry=None):
    """The resident route (the host's, or ``geometry``) against the plain
    version and against the band route at the host's band geometry."""
    n, h, w, _ = x.shape
    dev = x.device
    if traced is None:
        taps, p, k1, f1, k2, f2 = mk._params(h, w, radius, angle, dev)
    else:
        taps, p = mk._params(h, w, radius, 0.0, dev)[:2]
        k1, f1, k2, f2, _ = mk._traced_params(np.asarray(traced, np.float32), n, h, w, 180.0,
                                              dev)
    assert geometry is not None or mk._resident_geometry(h, w, p) is not None
    before = dict(mk.LAUNCHES)
    got = mk.luma_blur_rotate(x, taps, p, k1, f1, k2, f2, fill, geometry=geometry)
    key = "luma_blur_rotate_traced" if traced is not None else "luma_blur_rotate"
    assert mk.LAUNCHES["luma_blur_rotate_resident"] == before["luma_blur_rotate_resident"] + 1
    assert mk.LAUNCHES[key] == before[key] + 1
    bands = mk.luma_blur_rotate(x, taps, p, k1, f1, k2, f2, fill,
                                geometry=mk._luma_geometry(h, w, p))
    torch.cuda.synchronize()
    assert torch.equal(got, mk.luma_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, fill))
    assert torch.equal(got, bands)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,radius,angle,fill", [
    ((1024, 224, 224), 1.5, 15.0, 0),  # the chain cell's call
    ((8, 512, 512), 1.5, 15.0, 0),  # clusters of 16, one block an SM
    ((3, 128, 301), 2.5, -30.0, 255),  # the route's edges: 128 rows, odd widths
    ((3, 128, 512), 1.5, 15.0, 0),  # 128 rows of the widest row it takes
    ((3, 223, 227), 1.5, 135.0, 7),
    ((2, 224, 224), 5.0, 179.9, 255),  # p 15: any p, its taps from shared memory
])
def test_resident_route_on_the_card(rng, cuda, shape, radius, angle, fill):
    x = torch.from_numpy(rng.integers(0, 256, (*shape, 3), dtype=np.uint8)).to(cuda)
    _resident_vs_plain_and_bands(x, radius, angle, fill)


@pytest.mark.cuda
@pytest.mark.parametrize("angle", ANGLES)
def test_resident_route_at_every_angle(rng, cuda, angle):
    x = torch.from_numpy(rng.integers(0, 256, (4, 224, 224, 3), dtype=np.uint8)).to(cuda)
    _resident_vs_plain_and_bands(x, 1.5, angle, 0 if angle < 60 else 255)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_resident_geometries_at_an_odd_data_ptr(rng, cuda, cluster):
    """Other clusters give the same bytes, from a batch and into an output
    that start at odd addresses."""
    n, h, w = 3, 160, 149
    base = torch.from_numpy(rng.integers(0, 256, (n * h * w * 3 + 1,), dtype=np.uint8)).to(cuda)
    x = base[1:].view(n, h, w, 3)
    assert x.data_ptr() % 2 == 1
    _resident_vs_plain_and_bands(x, 1.5, 33.0, 9, geometry=mk.ResidentGeometry(cluster))


@pytest.mark.cuda
def test_resident_per_image_angles_at_the_budget_edge(rng, cuda):
    n = 8
    x = torch.from_numpy(rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8)).to(cuda)
    angles = np.where(np.arange(n) % 2 == 0, 22.5, -22.5).astype(np.float32)
    angles[1] = 0.0
    _resident_vs_plain_and_bands(x, 1.5, None, 0, traced=angles)
    before = mk.LAUNCHES["luma_blur_rotate_resident"]
    out = mk.fused_blur_rotate_batched(x, 1.5, angles, grayscale_out=True, stream=True)
    assert mk.LAUNCHES["luma_blur_rotate_resident"] == before + 1
    taps, p = mk._params(224, 224, 1.5, 0.0, cuda)[:2]
    k1, f1, k2, f2, _ = mk._traced_params(angles, n, 224, 224, 22.5, cuda)
    assert torch.equal(out, mk.luma_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, 0))
