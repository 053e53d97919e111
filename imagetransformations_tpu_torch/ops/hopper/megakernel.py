"""Fused blur -> 3-shear rotation (-> grayscale) on NHWC uint8 batches.

PyTorch counterpart of ``imagetransformations_tpu/ops/pallas/megakernel.py``
``fused_blur_rotate_image`` (one angle for the batch) and
``fused_blur_rotate_batched`` (one angle an image). Two hand-written CUDA
kernels carry both on the card (``csrc/luma_blur_rotate.cu``,
``csrc/rgb_blur_rotate.cu``), which take their shifts per image with a
stride (0 for one angle); beside each wrapper sits its plain PyTorch
version, which repeats the kernel's arithmetic op for op. The rgb kernel
is one launch a call: a block an output tile, which stages the source
footprint of its tile in shared memory; the host sizes that from a bound
on the shift slopes (``_tiling``; the footprint rule is mirrored in
``tile_footprint`` and ``footprint_bound``). The luma kernel has two
routes with the same bytes, which the host picks from the shapes alone:
one launch with the f32 plane S1 in a thread-block cluster's shared memory
wherever it fits (``_resident_geometry``), else two streaming launches over
bands of whole rows with S1 in device memory between them
(``_luma_geometry``; the kernel's window rule is mirrored in
``luma_windows``).

A wrapper looks at the tensor it is given: on the CPU it runs the plain
version, on a CUDA device it launches the kernel (or raises). It never
falls back from one to the other.

Semantics (oracles in the JAX package):

- ``stream=True``: f32 intermediates, one final quantization
  (``oracle/fast_warp.fused_stream_chain``). With grayscale on 3 channels,
  the luma is formed first and the blur and shears run on that one plane.
- ``stream=False``: the reference's per-op uint8 rounding: rint after the
  blur, trunc after each shear, then PIL L24 grayscale
  (``gaussian_blur -> fast_warp.rotate_3shear -> grayscale_rgb``).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from imagetransformations_tpu_torch.core.image import to_uint8_rint, to_uint8_trunc, trig_f32
from imagetransformations_tpu_torch.ops.hopper import _lib
from imagetransformations_tpu_torch.ops.hopper.shear import _paeth_params, _row_shifts
from imagetransformations_tpu_torch.ops.stencil import (
    cv2_gaussian_ksize,
    gaussian_blur,
    gaussian_taps,
)
from imagetransformations_tpu_torch.utils import profiling

#: kernel launches, by kernel (the package-wide counters of ``_lib``): each
#: wrapper call that launches its kernel (the luma kernel: its one resident
#: launch, or its row launch and column launch) adds one, under "*_traced"
#: when the shifts are per image and the luma kernel under
#: "luma_blur_rotate_packed" below 128 rows; a luma call that took the
#: resident route adds one to "luma_blur_rotate_resident" besides.
LAUNCHES = _lib.LAUNCHES

_LUMA_WEIGHTS = (19595, 38470, 7471)  # PIL L24 weights of R, G, B


# --------------------------------------------------------------- parameters


@functools.lru_cache(maxsize=64)
def blur_taps_f32(radius: float, device: torch.device) -> torch.Tensor:
    """The fused kernels' f32 cv2 taps [K] of ``radius`` on ``device`` (host
    f64, cast), as the JAX megakernels take them: the stream chain and the
    strict fused stage keep the JAX package's f32 blur, while
    ``stencil.gaussian_blur`` computes cv2's 8U integers."""
    k = cv2_gaussian_ksize(float(radius))
    return torch.from_numpy(gaussian_taps(k, float(radius)).astype(np.float32)).to(device)


@functools.lru_cache(maxsize=64)
def _params(h: int, w: int, radius: float, angle_deg: float, device: torch.device):
    """(taps f32 [2p+1], p, k1 i32 [h], f1 f32 [h], k2 i32 [w], f2 f32 [w])
    on ``device``. Shifts are f32 from the f64 host math; k = floor(s) and
    f = s - floor(s) computed in f32, as the JAX package does. Integer
    shifts are held to +-(w + 1) (k1) and +-(h + 1) (k2): both taps already
    lie off the canvas there, so the output is the same and near 180
    degrees the shift still fits an i32."""
    if radius > 0:
        taps = blur_taps_f32(radius, device)
    else:
        taps = torch.ones(1, dtype=torch.float32, device=device)
    a, b = _paeth_params(angle_deg)
    sx = _row_shifts(h, a, h / 2.0)
    sy = _row_shifts(w, b, w / 2.0)
    arrays = (
        np.clip(np.floor(sx), -(w + 1), w + 1).astype(np.int32),
        (sx - np.floor(sx)).astype(np.float32),
        np.clip(np.floor(sy), -(h + 1), h + 1).astype(np.int32),
        (sy - np.floor(sy)).astype(np.float32),
    )
    k1, f1, k2, f2 = (torch.from_numpy(v).to(device) for v in arrays)
    return taps, (taps.numel() - 1) // 2, k1, f1, k2, f2


@functools.lru_cache(maxsize=8)
def _flag(value: bool, device: torch.device) -> torch.Tensor:
    """One i32 flag on ``device``: the batch-wide identity flag of the rgb
    kernel (read with stride 0)."""
    return torch.tensor([int(value)], dtype=torch.int32, device=device)


def _traced_params(angles, n: int, h: int, w: int, max_angle_deg: float,
                   device: torch.device):
    """(k1 i32 [n, h], f1 f32 [n, h], k2 i32 [n, w], f2 f32 [n, w],
    identity i32 [n]) for one angle an image, computed in f32 on ``device``
    in the op order of the JAX package's traced kernels
    (megakernel.py:1101-1116; not the host f64 of the static path):
    clip to the budget, t = deg2rad(-angle), a = -tan(t/2), b = sin(t),
    shifts a*ys and b*xs, k = floor, f = s - k. identity is 1 where t == 0.
    The tangent and the sine are the correctly rounded f32 values of the
    f32 arguments (``trig_f32``), the same on every device."""
    ang = torch.as_tensor(angles, dtype=torch.float32, device=device)
    ang = torch.clamp(ang, -max_angle_deg, max_angle_deg)
    t = torch.deg2rad(-ang).reshape(-1).expand(n)
    a = -trig_f32(torch.tan, t / 2.0)
    b = trig_f32(torch.sin, t)
    ys = torch.arange(h, dtype=torch.float32, device=device) + 0.5 - h / 2.0
    xs = torch.arange(w, dtype=torch.float32, device=device) + 0.5 - w / 2.0
    sx = a[:, None] * ys[None, :]
    sy = b[:, None] * xs[None, :]
    k1, k2 = torch.floor(sx), torch.floor(sy)
    return (k1.to(torch.int32), sx - k1, k2.to(torch.int32), sy - k2,
            (t == 0.0).to(torch.int32))


# ------------------------------------------------------- luma kernel's bands
#
# csrc/luma_blur_rotate.cu runs two launches over units of (image, band of
# rows, column segment): the row launch streams a band's X rows and writes
# S1, the column launch reads S1 and writes the output. The functions below
# pick the geometry and mirror the kernels' shared-memory layout and their
# window rule on the host.

_LUMA_COLS = 4  # blur columns a thread of the row launch owns (kCols)
_LUMA_THREADS = 512  # threads a block, at most (the kernels' launch bound)
_LUMA_BLOCK = 128  # threads a block of several groups aims at
_LUMA_SMEM = 96 * 1024  # shared memory a block aims at: two blocks an SM at least
_LUMA_TEMPLATED_P = 4  # the half-width with a register window; others use a ring
_LUMA_STAGE = 7  # source rows the row launch has in flight (kStage)
_PACKED_ROWS = 128  # below this many rows, the JAX package's packed kernel (#2)
#: band rows of the row and column launches, below 128 rows and from 128 on
#: (chip_smoke.py, phase geometry, on the H100)
_BAND_ROWS = {True: (16, 4), False: (32, 8)}


class LumaGeometry(NamedTuple):
    """Launch geometry of the luma kernel: band rows of the row launch and
    of the column launch, output columns a unit (w: whole rows), columns a
    window buffer holds (w + 2 with whole rows), threads a group (each of
    the row launch's owns ``_LUMA_COLS`` window columns) and groups a block
    (more than one only with whole rows)."""

    rows_a: int
    rows_b: int
    seg_w: int
    win: int
    threads: int
    groups: int


def _luma_smem(g: LumaGeometry, h: int, w: int, p: int) -> tuple[int, int]:
    """Shared bytes of a block of the row launch and of the column launch
    (the layout of ``launch`` in csrc/luma_blur_rotate.cu)."""
    k, cols = 2 * p + 1, g.threads * _LUMA_COLS
    ra, rb, seg = min(g.rows_a, h), min(g.rows_b, h), min(g.seg_w, w)
    wp, lw, slot = _up(g.win + 4, 4), _up(cols + 2 * p, 4), _up(3 * (cols + 2 * p) + 32, 16)
    ring = 0 if p == _LUMA_TEMPLATED_P else k * wp
    rows = 2 * _up(ra, 4) + 2 * lw + 2 * wp + (_LUMA_STAGE + 1) * slot // 4 + ring
    col = 2 * _up(rb, 4) + rb * _up(g.win, 4) + rb * _up(3 * seg + 16, 16) // 4
    return 4 * (_up(k, 4) + g.groups * rows), 4 * g.groups * col


@functools.lru_cache(maxsize=256)
def _luma_geometry(h: int, w: int, p: int) -> LumaGeometry:
    """The luma kernel's geometry, from the shapes alone: bands of
    ``_BAND_ROWS`` rows; whole rows wherever the buffers fit, with as many
    groups a block as ``_LUMA_BLOCK`` threads hold (several small images a
    block: the JAX package's packed route); else column segments, halved
    until they fit (a window of twice the segment, so moderate angles need
    one sub-band). ValueError if no segment fits the card's shared memory."""
    rows_a, rows_b = _BAND_ROWS[h < _PACKED_ROWS]
    for limit in (_LUMA_SMEM, _SMEM_MAX):
        seg = w
        while seg >= 4:
            whole = seg >= w
            win = w + 2 if whole else 2 * seg + 2
            threads = -(-min(win, w) // _LUMA_COLS)
            g = LumaGeometry(rows_a, rows_b, seg, win, threads,
                             max(1, _LUMA_BLOCK // threads) if whole else 1)
            while g.groups > 1 and max(_luma_smem(g, h, w, p)) > limit:
                g = g._replace(groups=g.groups // 2)
            if threads <= _LUMA_THREADS and max(_luma_smem(g, h, w, p)) <= limit:
                return g
            seg = 1 << ((min(seg, w) - 1).bit_length() - 1)  # the power of two below
    raise ValueError(f"luma_blur_rotate: no geometry fits shared memory at {h}x{w}, p {p}")


def luma_windows(k1_band, x0: int, x1: int, w: int, win: int) -> list:
    """The kernels' window rule (``next_window``) for one band: its rows
    cut into sub-bands [(ya, yb, c0, c1), ...], each the most rows from ya
    on whose window [x0 + min k1, x1 + max k1] (clamped to [-1, w]; -1 and
    w stand for fill) fits ``win`` columns."""
    k1_band = [int(k) for k in k1_band]
    out, ya = [], 0
    while ya < len(k1_band):
        kmin = kmax = k1_band[ya]
        yb, c0, c1 = ya + 1, _clamp(x0 + kmin, -1, w), _clamp(x1 + kmax, -1, w)
        for y in range(ya + 1, len(k1_band)):
            lo, hi = min(kmin, k1_band[y]), max(kmax, k1_band[y])
            d0, d1 = _clamp(x0 + lo, -1, w), _clamp(x1 + hi, -1, w)
            if d1 - d0 + 1 > win:
                break
            kmin, kmax, yb, c0, c1 = lo, hi, y + 1, d0, d1
        out.append((ya, yb, c0, c1))
        ya = yb
    return out


# ---------------------------------------------------- luma kernel's clusters
#
# Where an image's f32 plane S1 fits the shared memory of a thread-block
# cluster, csrc/luma_blur_rotate.cu runs one launch instead (the resident
# route): a cluster of C blocks of 16 warps an image, block r holding S1 rows
# [r*ceil(h/C), (r+1)*ceil(h/C)) on chip; pass 2 reads each S1 row from the
# block that owns it. The functions below mirror its layout and pick C from
# the shapes alone.

_RESIDENT_CLUSTERS = (1, 2, 4, 8, 16)  # blocks a cluster, least first (16: non-portable)
_RESIDENT_BLOCKS_PER_SM = 2  # sought first, so one image's phase B overlaps another's phase A
_RESIDENT_MAX_W = 512  # a lane loads 4 column quads of a source row (128 * kQuads)


class ResidentGeometry(NamedTuple):
    """Launch geometry of the luma kernel's resident route: blocks a
    cluster (one image a cluster)."""

    cluster: int


def _resident_smem(h: int, w: int, p: int, g: ResidentGeometry) -> int:
    """Shared bytes of a block of the resident route (the layout of
    ``resident_layout`` in csrc/luma_blur_rotate.cu): the bands (the B,
    then the S2 rows, with fill columns), the tables, the row pointers and
    the plane (the slab's rows + 2p X rows, then its S1 rows)."""
    slab = -(-h // g.cluster)
    bands = _up(slab * (w + 2) + 1, 4)
    tables = 2 * _up(slab, 4) + _up(2 * p + 1, 4) + 3 * _up(w, 4) + 2 * _up(h + 2, 4)
    plane = (slab + 2 * p) * (_up(w, 4) + _up(2 * p, 4))
    return 4 * (bands + tables + plane)


@functools.lru_cache(maxsize=256)
def _resident_geometry(h: int, w: int, p: int) -> ResidentGeometry | None:
    """The resident route's geometry, from the shapes alone: the least
    cluster at which ``_RESIDENT_BLOCKS_PER_SM`` blocks fit an SM's shared
    memory, else the least at which one does; None (the band route) below
    ``_PACKED_ROWS`` rows, above ``_RESIDENT_MAX_W`` columns, or where no
    cluster holds the plane."""
    if h < _PACKED_ROWS or w > _RESIDENT_MAX_W or p > min(h, w) - 1:
        return None
    for blocks in (_RESIDENT_BLOCKS_PER_SM, 1):
        for cluster in _RESIDENT_CLUSTERS:
            g = ResidentGeometry(cluster)
            smem = _resident_smem(h, w, p, g)
            if smem <= _SMEM_MAX and _SM_SMEM // (smem + 1024) >= blocks:
                return g
    return None


# ------------------------------------------------- rgb kernel's tile footprint
#
# csrc/rgb_blur_rotate.cu runs a block an output tile and stages in shared
# memory the part of the source the tile needs. The functions below mirror
# its footprint rule and its shared-memory layout on the host: the host
# sizes the layout from a bound on the shift slopes (no read from the
# device), the kernel checks each footprint against it.

_SM_SMEM = 233472  # shared memory of an H100 SM (228 KB, 1 KB of it reserved a block)
_SMEM_MAX = 232448  # the most a block may have
# (rows, columns) of an output tile, both powers of two
_TILE_SHAPES = ((32, 64), (32, 32), (16, 64), (16, 32), (8, 64), (8, 32), (4, 32), (2, 32),
                (1, 32), (1, 16), (1, 8), (1, 4))
_CHUNK_ROWS = (64, 32, 16, 8, 4, 2, 1)  # tried, largest first, when one chunk does not fit
_BLOCK_WORK = 20000  # a block's fixed cost in the tiling's work units
_MAX_BATCH = 8  # images whose footprints a block takes at once (a warp each)
_BATCH_BLOCKS = 1600  # blocks a launch aims for (about four waves of 3 an SM on 132 SMs)


class Tiling(NamedTuple):
    """A launch's tiling: tiles of 2**tile_rows_log2 x 2**tile_cols_log2
    pixels, R1 cut into chunks of chunk_rows, footprints of at most max_r1
    rows of S1, max_c2 columns of S2 and max_c1 columns of B a chunk."""

    tile_rows_log2: int
    tile_cols_log2: int
    chunk_rows: int
    max_r1: int
    max_c2: int
    max_c1: int
    smem: int


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def _smem_bytes(p: int, c: int, ty_log2: int, tx_log2: int, rc: int, max_r1: int,
                max_c2: int, max_c1: int) -> int:
    """Shared memory of a block: ``make_layout`` of csrc/rgb_blur_rotate.cu."""
    ty, tx = 1 << ty_log2, 1 << tx_log2
    sp, fp = _up(46 + (max_c1 + 2 * p) * c, 16), _up(max_c1 + 2 * p, 4)
    pitch2 = (max_c2 * c) | 1  # S1 and S2 rows, channels interleaved
    total = _up((rc + 2 * p) * sp, 16)
    total += _up(4 * max(rc * max_c1 * c if p else 0, ty * pitch2), 16)
    total += _up(4 * (rc * fp + 8), 16) if p else 0
    # S1, then the output tile
    total += _up(max(4 * max_r1 * pitch2, ty * _up(46 + tx * c, 16)), 16)
    total += _up(4 * (2 * p + 1), 16)
    return total + _up(4 * _MAX_BATCH * (5 + 2 * -(-max_r1 // rc)), 16)


def _slope_spread(slope: float):
    """Bound on max k - min k over n consecutive entries of k = floor(s)
    for shifts s with |s[i+1] - s[i]| <= slope, plus 1 for the device's
    f32 tan / sin against the host's f64."""
    def spread(count: int) -> int:
        if count <= 1:
            return 0
        d = slope * (count - 1) * (1.0 + 1e-6)
        return 1 << 30 if not math.isfinite(d) or d > 1 << 29 else int(math.floor(d)) + 2
    return spread


def _table_spread(k: torch.Tensor):
    """max k - min k over n consecutive entries of the tables k [..., L]
    (read from the device once)."""
    table = k.detach().cpu().to(torch.int64).reshape(-1, k.shape[-1]).numpy()

    @functools.lru_cache(maxsize=None)
    def spread(count: int) -> int:
        count = min(count, table.shape[-1])
        if count <= 1:
            return 0
        win = np.lib.stride_tricks.sliding_window_view(table, count, axis=-1)
        return int((win.max(-1) - win.min(-1)).max())
    return spread


def footprint_bound(spread1, spread2, h: int, w: int, ty: int, tx: int,
                    rc: int | None) -> tuple[int, int, int]:
    """(max_r1, max_c2, max_c1): the most rows of S1, columns of S2 and
    columns of B a chunk (each with its fill rows or columns at -1 and h or
    w) that a tile of ty x tx pixels (cut to the canvas) can need, given
    spread1(n) / spread2(n), bounds on the spread of k1 over n rows / k2
    over n columns; chunks of rc rows (None: one chunk). Identity images
    need the tile itself: max_r1 and max_c1 cover it."""
    nty, ntx = min(ty, h), min(tx, w)
    c2 = min(ntx + spread1(nty) + 1, w + 2)
    r1 = min(nty + spread2(min(c2, w)) + 1, h + 2)
    rows = min(r1, h) if rc is None else min(rc, r1, h)
    c1 = min(min(c2, w) + spread1(rows) + 1, w + 2)
    return max(r1, nty), c2, max(c1, ntx)


def _choose_tiling(spread1, spread2, h: int, w: int, p: int, c: int) -> Tiling:
    """The tiling of least estimated cost a pixel; ValueError if no layout
    fits a block's shared memory."""
    best = None
    for ty, tx in _TILE_SHAPES:
        for rc in (None, *_CHUNK_ROWS):
            mr1, mc2, mc1 = footprint_bound(spread1, spread2, h, w, ty, tx, rc)
            rc_eff = mr1 if rc is None else min(rc, mr1)
            tyl, txl = ty.bit_length() - 1, tx.bit_length() - 1
            smem = _smem_bytes(p, c, tyl, txl, rc_eff, mr1, mc2, mc1)
            if smem > _SMEM_MAX:
                continue
            # work a pixel: staging (~3 a value), the two blur passes
            # (3p + 1), the three lerps (~8), a block's fixed cost (its
            # barriers and reductions) and a chunk's; 30% more for each
            # block short of three on an SM (four at p = 0: the kernel's
            # register budget)
            nty, ntx = min(ty, h), min(tx, w)
            chunks = -(-mr1 // rc_eff)
            blur = (rc_eff * (mc1 + 2 * p) + rc_eff * mc1) * (3 * p + 1) if p else 0
            work = chunks * ((rc_eff + 2 * p) * (mc1 + 2 * p) * 3 + blur + _BLOCK_WORK)
            work += (mr1 * mc2 + nty * mc2 + nty * ntx) * 8
            most = 4 if p == 0 else 3
            blocks = min(most, _SM_SMEM // (smem + 1024))
            key = (work / (nty * ntx) * (1.0 + 0.3 * (most - blocks)), ty * tx)
            if best is None or key < best[0]:
                best = (key, Tiling(tyl, txl, rc_eff, mr1, mc2, mc1, smem))
            break  # smaller chunks of this tile only cost more
    if best is None:
        raise ValueError(f"rgb_blur_rotate: no tile's footprint fits shared memory at "
                         f"{h}x{w}, p {p}, c {c}")
    return best[1]


def _batch(n: int, h: int, w: int, t: Tiling) -> int:
    """Images a block takes footprints for at once: as many as keep about
    _BATCH_BLOCKS blocks, 1 to _MAX_BATCH."""
    tiles = -(-h // (1 << t.tile_rows_log2)) * -(-w // (1 << t.tile_cols_log2))
    return max(1, min(_MAX_BATCH, n * tiles // _BATCH_BLOCKS))


def slope_bound(angle_deg: float) -> tuple[float, float]:
    """(|a|, |b|) of one rotation angle: the per-row slope |tan(t/2)| of
    shears 1 and 3 and the per-column slope |sin(t)| of shear 2."""
    t = math.radians(angle_deg)
    return abs(math.tan(t / 2.0)), abs(math.sin(t))


def budget_slope_bound(max_angle_deg: float) -> tuple[float, float]:
    """(|a|, |b|) bounds over every angle in [-max, max]."""
    m = min(abs(float(max_angle_deg)), 180.0)
    a = math.inf if m >= 180.0 else math.tan(math.radians(m) / 2.0)
    return a, (math.sin(math.radians(m)) if m < 90.0 else 1.0)


@functools.lru_cache(maxsize=256)
def _tiling(h: int, w: int, p: int, c: int, slopes: tuple[float, float]) -> Tiling:
    """The kernel's tiling for shift tables whose slopes are at most
    ``slopes`` (|a| of k1, |b| of k2): host arithmetic alone."""
    return _choose_tiling(_slope_spread(slopes[0]), _slope_spread(slopes[1]), h, w, p, c)


def _clamp(v: int, lo: int, hi: int) -> int:
    return min(max(v, lo), hi)


def tile_footprint(k1, k2, h: int, w: int, y0: int, x0: int, ty: int, tx: int, rc: int,
                   identity: bool = False) -> dict:
    """The kernel's footprint rule for the tile at (y0, x0) of one image's
    tables k1 [h], k2 [w] (numpy ints): {"c2": (lo, hi), "r1": (lo, hi),
    "chunks": [(row lo, row hi, B column lo, B column hi), ...]}. C2, R1 and
    each chunk's C1 are clamped to [-1, w] / [-1, h], their fill positions
    (hi < lo: not read); the chunks split R1 on the canvas into rc rows. The blur
    of a chunk reads source rows row lo - p .. row hi + p and columns of C1
    on the canvas +- p, reflected."""
    k1 = np.asarray(k1, np.int64)
    k2 = np.asarray(k2, np.int64)
    y1, x1 = min(y0 + ty, h) - 1, min(x0 + tx, w) - 1
    cl, ch = 0, -1
    if identity:
        c2, r1 = (0, -1), (y0, y1)
    else:
        ks = k1[y0:y1 + 1]
        c2 = (_clamp(x0 + int(ks.min()), -1, w), _clamp(x1 + int(ks.max()) + 1, -1, w))
        cl, ch = max(c2[0], 0), min(c2[1], w - 1)
        r1 = (0, -1)
        if cl <= ch:
            kc = k2[cl:ch + 1]
            r1 = (_clamp(y0 + int(kc.min()), -1, h), _clamp(y1 + int(kc.max()) + 1, -1, h))
    chunks = []
    for ra in range(max(r1[0], 0), min(r1[1], h - 1) + 1, rc):
        rb = min(ra + rc - 1, r1[1], h - 1)
        if identity:
            chunks.append((ra, rb, x0, x1))
        elif cl <= ch:
            kr = k1[ra:rb + 1]
            chunks.append((ra, rb, _clamp(cl + int(kr.min()), -1, w),
                           _clamp(ch + int(kr.max()) + 1, -1, w)))
        else:
            chunks.append((ra, rb, 0, -1))
    return {"c2": c2, "r1": r1, "chunks": chunks}


# ------------------------------------------------------------ plain versions


def _reflect101(i: torch.Tensor, n: int) -> torch.Tensor:
    i = i.abs()
    return torch.where(i >= n, 2 * (n - 1) - i, i)


def _blur_along(v: torch.Tensor, taps: torch.Tensor, p: int, dim: int) -> torch.Tensor:
    """cv2 Gaussian pass along ``dim`` with reflect-101 borders: centre tap
    first, then the mirrored pairs as acc + taps[t] * (lo + hi)."""
    size = v.shape[dim]
    idx = _reflect101(torch.arange(-p, size + p, device=v.device), size)
    vp = v.index_select(dim, idx)

    def at(t: int) -> torch.Tensor:
        return vp.narrow(dim, t, size)

    acc = taps[p] * at(p)
    for t in range(p):
        acc = acc + taps[t] * (at(t) + at(2 * p - t))
    return acc


def _lerp(a: torch.Tensor, b: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    # v + f * (nbr - v), three separately rounded ops (not torch.lerp, whose
    # formula changes at f >= 0.5)
    return a + f * (b - a)


def _take(v: torch.Tensor, idx: torch.Tensor, dim: int, fill: float) -> torch.Tensor:
    """v gathered at ``idx`` along ``dim``; indices off the canvas read fill."""
    size = v.shape[dim]
    got = torch.gather(v, dim, idx.clamp(0, size - 1).expand(v.shape))
    return torch.where((idx >= 0) & (idx < size), got, fill)


def _trunc_u8(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.trunc(v), 0.0, 255.0)


def _shear_x(v, k1, f1, fill: float, strict: bool) -> torch.Tensor:
    """Shears 1 and 3 of f32 planes v [n, C, h, w]: x shifted by row, k1/f1
    [h] or [n, h]; fill off the canvas; u8 trunc if strict."""
    h, w = v.shape[-2:]
    k1, f1 = k1.reshape(-1, 1, h, 1), f1.reshape(-1, 1, h, 1)
    xs = torch.arange(w, device=v.device).view(1, 1, 1, w) + k1
    out = _lerp(_take(v, xs, 3, fill), _take(v, xs + 1, 3, fill), f1)
    return _trunc_u8(out) if strict else out


def _shear_y(v, k2, f2, fill: float, strict: bool) -> torch.Tensor:
    """Shear 2: y shifted by column, k2/f2 [w] or [n, w]; as ``_shear_x``."""
    h, w = v.shape[-2:]
    k2, f2 = k2.reshape(-1, 1, 1, w), f2.reshape(-1, 1, 1, w)
    ys = torch.arange(h, device=v.device).view(1, 1, h, 1) + k2
    out = _lerp(_take(v, ys, 2, fill), _take(v, ys + 1, 2, fill), f2)
    return _trunc_u8(out) if strict else out


def _shears(v, k1, f1, k2, f2, fill: float, strict: bool) -> torch.Tensor:
    """The three Paeth shears of f32 planes v [n, C, h, w]: x by row, y by
    column, x by row; fill off the canvas; u8 trunc after each if strict.
    k1/f1 are [h] or [n, h], k2/f2 are [w] or [n, w]."""
    v = _shear_x(v, k1, f1, fill, strict)
    v = _shear_y(v, k2, f2, fill, strict)
    return _shear_x(v, k1, f1, fill, strict)


def _replicate3(q: torch.Tensor) -> torch.Tensor:
    """[n, h, w] u8 -> [n, h, w, 3]."""
    return q[..., None].expand(*q.shape, 3).contiguous()


def luma_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, fill: int) -> torch.Tensor:
    """Plain version of ``luma_blur_rotate``: exact integer L24 luma, blur X
    then Y, three f32 shears, floor(v + 0.5), replicated to 3 channels."""
    xi = x.to(torch.int32)
    r, g, b = xi[..., 0], xi[..., 1], xi[..., 2]
    wr, wg, wb = _LUMA_WEIGHTS
    lum = (g * wg + r * wr) + b * wb  # < 2^24: exact in f32
    v = (lum.to(torch.float32) * (1.0 / 65536.0))[:, None]  # [n, 1, h, w]
    v = _blur_along(_blur_along(v, taps, p, 3), taps, p, 2)
    v = _shears(v, k1, f1, k2, f2, float(fill), strict=False)
    q = (v[:, 0] + 0.5).to(torch.int32).clamp(0, 255).to(torch.uint8)
    return _replicate3(q)


def _l24(r: torch.Tensor, g: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """PIL convert('L') on f32 values: L24 fixed point floored by the int cast."""
    wr, wg, wb = _LUMA_WEIGHTS
    sum3 = (g * float(wg) + r * float(wr)) + b * float(wb)
    return (sum3 * (1.0 / 65536.0) + 0.5).to(torch.int32).clamp(0, 255).to(torch.uint8)


def rgb_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, fill: int, strict: bool,
                          grayscale: bool, identity) -> torch.Tensor:
    """Plain version of ``rgb_blur_rotate``: per-channel blur Y then X [rint
    if strict], three shears [trunc after each if strict] unless identity,
    then PIL grayscale, or rint (identity) / trunc (rotation).

    ``identity`` is one bool for the batch or an i32 flag an image ([n]);
    the shears run on every image and the flagged ones take their
    unsheared values, as the kernel skips their shears."""
    v = x.permute(0, 3, 1, 2).to(torch.float32)  # [n, c, h, w]
    v = _blur_along(_blur_along(v, taps, p, 2), taps, p, 3)
    if strict:
        v = torch.round(v)
    ident = (torch.as_tensor(identity, device=v.device) != 0).reshape(-1, 1, 1, 1)
    v = torch.where(ident, v, _shears(v, k1, f1, k2, f2, float(fill), strict))
    if grayscale:
        return _replicate3(_l24(v[:, 0], v[:, 1], v[:, 2]))
    q = torch.where(ident, to_uint8_rint(v), to_uint8_trunc(v))
    return q.permute(0, 2, 3, 1).contiguous()


# ------------------------------------------------------------ kernel wrappers


def _check_cuda(x: torch.Tensor, *params: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"kernel wrappers take CPU or CUDA tensors, got {x.device}")
    if x.dtype != torch.uint8 or x.ndim != 4 or not x.is_contiguous():
        raise ValueError("expected a contiguous NHWC uint8 tensor")
    for t in params:
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("kernel parameters must be contiguous and on the image's device")


def _shift_strides(k1: torch.Tensor, k2: torch.Tensor, n: int) -> tuple[int, int]:
    """Per-image element strides of the shift arrays: 0 when one set ([h],
    [w]) serves the whole batch, h / w for per-image sets ([n, h], [n, w])."""
    h, w = k1.shape[-1], k2.shape[-1]
    if k1.ndim == 1 and k2.ndim == 1:
        return 0, 0
    if k1.shape == (n, h) and k2.shape == (n, w):
        return h, w
    raise ValueError("shifts must be [h] and [w], or [n, h] and [n, w]")


def luma_blur_rotate(x, taps, p, k1, f1, k2, f2, fill: int = 0, *,
                     geometry=None) -> torch.Tensor:
    """Grayscale-first blur -> rotation: NHWC u8 RGB -> NHWC u8 (luma x 3).

    On CUDA: ``csrc/luma_blur_rotate.cu``. ``geometry`` None: the host's
    choice from the shapes, the resident route (one launch, S1 in a
    cluster's shared memory; ``_resident_geometry``) where the plane fits a
    cluster, else the band route (two launches with an f32 plane S1 in
    device memory between them; ``_luma_geometry``). A ``ResidentGeometry``
    forces the resident route, any other geometry (a ``LumaGeometry``) the
    band route. On the CPU: the plain version."""
    if x.device.type == "cpu":
        return luma_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, fill)
    _check_cuda(x, taps, k1, f1, k2, f2)
    n, h, w, c = x.shape
    if c != 3:
        raise ValueError("luma_blur_rotate needs 3 channels")
    if p > min(h, w) - 1:
        raise ValueError(f"blur half-width {p} needs images of at least {p + 1} pixels a side")
    if not 0 <= int(fill) <= 255:
        raise ValueError(f"fill must be a u8 value, got {fill}")
    sh, sw = _shift_strides(k1, k2, n)
    if geometry is None:
        g = _resident_geometry(h, w, p) or _luma_geometry(h, w, p)
    elif isinstance(geometry, ResidentGeometry):
        g = geometry
    else:
        g = LumaGeometry(*geometry)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    name = "luma_blur_rotate"
    lib = _lib.load(name)
    args = (taps.data_ptr(), p, k1.data_ptr(), f1.data_ptr(), k2.data_ptr(), f2.data_ptr(),
            sh, sw, n, h, w, int(fill))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if isinstance(g, ResidentGeometry):
            err = lib.luma_blur_rotate_resident(x.data_ptr(), out.data_ptr(), *args, *g, stream)
        else:
            s1 = torch.empty((n, h, w), dtype=torch.float32, device=x.device)
            err = lib.luma_blur_rotate(x.data_ptr(), s1.data_ptr(), out.data_ptr(), *args, *g,
                                       stream)
    _lib.check(name, err)
    if isinstance(g, ResidentGeometry):
        LAUNCHES["luma_blur_rotate_resident"] += 1
    if sh:
        LAUNCHES["luma_blur_rotate_traced"] += 1
    else:
        LAUNCHES["luma_blur_rotate_packed" if h < _PACKED_ROWS else name] += 1
    return out


def rgb_blur_rotate(x, taps, p, k1, f1, k2, f2, fill: int = 0, strict: bool = False,
                    grayscale: bool = False, identity=False, *, slopes=None) -> torch.Tensor:
    """Per-channel blur -> rotation (-> PIL grayscale): NHWC u8 -> NHWC u8.
    ``identity``: one bool for the batch, or i32 flags [n] (1: angle 0).

    On CUDA: ``csrc/rgb_blur_rotate.cu``, one launch; on the CPU: the plain
    version. ``slopes`` = (|a|, |b|) bounds the tables' per-row and
    per-column shift slopes (``slope_bound``, ``budget_slope_bound``); the
    shared memory is sized from it on the host. Without it the call reads
    the tables from the card to size it, which waits for the work queued
    before it: the entry points always pass it."""
    if x.device.type == "cpu":
        return rgb_blur_rotate_plain(x, taps, p, k1, f1, k2, f2, fill, strict,
                                     grayscale, identity)
    _check_cuda(x, taps, k1, f1, k2, f2)
    n, h, w, c = x.shape
    if grayscale and c != 3:
        raise ValueError("grayscale needs 3 channels")
    if p > min(h, w) - 1:
        raise ValueError(f"blur half-width {p} needs images of at least {p + 1} pixels a side")
    if not 0 <= int(fill) <= 255:
        raise ValueError(f"fill must be a u8 value, got {fill}")
    sh, sw = _shift_strides(k1, k2, n)
    if isinstance(identity, bool):
        ident, ident_stride = _flag(identity, x.device), 0
    else:
        ident, ident_stride = identity, 1
        if (ident.shape != (n,) or ident.dtype != torch.int32 or ident.device != x.device
                or not ident.is_contiguous()):
            raise ValueError("identity flags must be a contiguous i32 [n] tensor on the "
                             "image's device")
    if slopes is None:
        t = _choose_tiling(_table_spread(k1), _table_spread(k2), h, w, p, c)
    else:
        t = _tiling(h, w, p, c, (float(slopes[0]), float(slopes[1])))
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    name = "rgb_blur_rotate"
    lib = _lib.load(name)
    with torch.cuda.device(x.device):
        err = lib.rgb_blur_rotate(
            x.data_ptr(), out.data_ptr(), taps.data_ptr(), p,
            k1.data_ptr(), f1.data_ptr(), k2.data_ptr(), f2.data_ptr(), sh, sw,
            n, h, w, c, int(fill), int(strict), int(grayscale), ident.data_ptr(),
            ident_stride, *t, _batch(n, h, w, t), torch.cuda.current_stream(x.device).cuda_stream,
        )
    _lib.check(name, err)
    LAUNCHES[name + "_traced" if sh else name] += 1
    return out


# ------------------------------------------------------------ entry point


def fused_blur_rotate_image(
    img: torch.Tensor,
    radius: float,
    angle_deg: float,
    fill: int = 0,
    grayscale_out: bool = False,
    stream: bool = False,
) -> torch.Tensor:
    """Fused blur -> 3-shear rotation (-> grayscale). NHWC uint8 -> NHWC uint8,
    on the tensor's device.

    ``stream=False``: per-op uint8 quantization — gaussian_blur -> oracle
    rotate_3shear (-> grayscale), the reference's image-at-a-time semantics.
    ``stream=True``: f32 streaming with ONE final quantization (the fast-mode
    chain contract; oracle fast_warp.fused_stream_chain). Any angle: the
    rgb kernel's tiles and their stage are sized from the angle's shift
    slopes, as the JAX kernels size their pads from the shifts; the luma
    kernel's bands take their shift windows from the tables on the card.
    Images smaller than the blur window
    + 2 are blurred first by ``gaussian_blur`` (u8, rint; the
    ``blur_separable`` kernel on the card), then rotated at radius 0, as
    the JAX function does.
    """
    if not isinstance(img, torch.Tensor) or img.ndim != 4 or img.dtype != torch.uint8:
        raise ValueError("expected an NHWC uint8 tensor")
    radius, angle_deg = float(radius), float(angle_deg)
    n, h, w, c = img.shape
    if grayscale_out and c != 3:
        raise ValueError("grayscale_out needs 3 channels")
    taps, p, k1, f1, k2, f2 = _params(h, w, radius, angle_deg, img.device)
    if radius > 0 and (h < p + 2 or w < p + 2):
        return fused_blur_rotate_image(gaussian_blur(img, radius), 0.0, angle_deg, fill=fill,
                                       grayscale_out=grayscale_out, stream=stream)
    x = img.contiguous()
    if stream and grayscale_out and (angle_deg != 0.0 or radius > 0):
        return luma_blur_rotate(x, taps, p, k1, f1, k2, f2, fill)
    return rgb_blur_rotate(x, taps, p, k1, f1, k2, f2, fill, strict=not stream,
                           grayscale=grayscale_out, identity=angle_deg == 0.0,
                           slopes=slope_bound(angle_deg))


def fused_blur_rotate_batched(
    img: torch.Tensor,
    radius: float,
    angles_deg,
    fill: int = 0,
    grayscale_out: bool = False,
    stream: bool = False,
    max_angle_deg: float = 22.5,
) -> torch.Tensor:
    """Fused blur -> 3-shear rotation (-> grayscale) with one angle an image.
    NHWC uint8 -> NHWC uint8, on the tensor's device.

    Semantics match ``fused_blur_rotate_image`` per image (``stream`` as
    there), with the shifts computed in f32 on the device
    (``_traced_params``): <= 1 LSB from the static path's host-f64 shifts.
    ``angles_deg`` is a scalar or one angle an image. A max |angle| beyond
    ``max_angle_deg`` raises ValueError (the JAX package's routing budget);
    the angles are then clipped to it. Images smaller than the blur window
    + 2 are blurred first, as in ``fused_blur_rotate_image``.
    """
    if not isinstance(img, torch.Tensor) or img.ndim != 4 or img.dtype != torch.uint8:
        raise ValueError("expected an NHWC uint8 tensor")
    n, h, w, c = img.shape
    # the budget check reads host angles on the host; device angles are read
    # back once here, which waits for every launch queued before it
    if isinstance(angles_deg, torch.Tensor) and angles_deg.device.type != "cpu":
        checked = ang = angles_deg.to(img.device, torch.float32)
    else:
        checked = torch.as_tensor(angles_deg, dtype=torch.float32)
        ang = checked.to(img.device)
    if ang.numel() not in (1, n):
        raise ValueError(f"expected one angle or {n}, got {ang.numel()}")
    amax = float(profiling.host_read(checked.abs().max(), "rotation.max_angle"))
    if amax > float(max_angle_deg) + 1e-6:
        raise ValueError(
            f"fused_blur_rotate_batched: max |angle| {amax} exceeds the routing "
            f"budget max_angle_deg={max_angle_deg}"
        )
    if grayscale_out and c != 3:
        raise ValueError("grayscale_out needs 3 channels")
    radius = float(radius)
    taps, p = _params(h, w, radius, 0.0, img.device)[:2]
    if radius > 0 and (h < p + 2 or w < p + 2):
        return fused_blur_rotate_batched(gaussian_blur(img, radius), 0.0, angles_deg, fill=fill,
                                         grayscale_out=grayscale_out, stream=stream,
                                         max_angle_deg=max_angle_deg)
    k1, f1, k2, f2, ident = _traced_params(ang, n, h, w, float(max_angle_deg), img.device)
    x = img.contiguous()
    if stream and grayscale_out:
        return luma_blur_rotate(x, taps, p, k1, f1, k2, f2, fill)
    return rgb_blur_rotate(x, taps, p, k1, f1, k2, f2, fill, strict=not stream,
                           grayscale=grayscale_out, identity=ident,
                           slopes=budget_slope_bound(max_angle_deg))
