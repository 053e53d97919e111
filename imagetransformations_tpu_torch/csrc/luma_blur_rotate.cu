// Grayscale-first blur -> 3-shear rotation on one luma plane, NHWC u8 RGB in,
// NHWC u8 (luma replicated to 3 channels) out.
//
// Replaces: imagetransformations_tpu/ops/pallas/megakernel.py
//   :435 _mega_gray1_kernel        (one image a grid step)
//   :514 _mega_gray1_packed_kernel (many small images a slab, h < 128)
//   :854 _mega_traced_gray1_kernel (per-image angles: shift tables per
//                                   image, stride h / w; its log-routed
//                                   shifts and group minima exist only for
//                                   the TPU's lane rolls)
// All compute one function. Here it has two routes, which the host picks from
// (h, w, p) alone and whose bytes are the same: the resident route (one
// launch; megakernel._resident_geometry) wherever h >= 128, w <= 512 and the
// plane fits a thread-block cluster, else the band route (two launches;
// megakernel._luma_geometry).
//
// What it computes (oracle: oracle/fast_warp.fused_stream_chain, gray path;
// plain version: megakernel.luma_blur_rotate_plain), every f32 add and
// multiply rounded on its own (_rn intrinsics, and the build's -fmad=false):
//   L = exact integer L24 luma (g*38470 + r*19595) + b*7471, as f32 * 2^-16
//   X = cv2 Gaussian of L along x, B = of X along y (reflect-101; centre tap
//       first, then the mirrored pairs t = 0..p-1 as acc + taps[t]*(lo + hi))
//   S1[y,x] = lerp(B [y, x+k1[y]], B [y, x+k1[y]+1], f1[y])
//   S2[y,x] = lerp(S1[y+k2[x], x], S1[y+k2[x]+1, x], f2[x])
//   S3[y,x] = lerp(S2[y, x+k1[y]], S2[y, x+k1[y]+1], f1[y])
//   lerp(a, b, f) = a + f*(b - a); fill for any index off the h x w canvas;
//   out = clamp((int)(S3 + 0.5), 0, 255) in each of the 3 channels.
// Both routes take that arithmetic from one set of device functions (luma,
// quad_luma, tap_sum, lerp_rn, quantize).
//
// Bound on the H100 (3.35 TB/s): the function reads n*h*w*3 u8 and writes
// as many, 308 MB at 1024x224x224 (0.092 ms); its ~51 unfused operations a
// pixel take 0.039 ms at 67e12 a second, so bytes bound it. Only the column
// shear S2 crosses rows: everything else works within a row.
//
// Resident route (luma_resident_kernel): a cluster of C blocks an image;
// block r keeps S1 rows [r*slab, (r+1)*slab), slab = ceil(h / C), in its
// shared memory, and pass 2 reads each S1 row from the block that owns it
// (distributed shared memory), so only the input and output bytes touch
// device memory and any angle works. Each pass is one wide stage over the
// block's rows, a few barriers in all (see the kernel's note). The host
// takes the least C at which two blocks fit an SM, else the least at which
// one does: at 224x224 C = 4 blocks of 16 warps (115 KB; the launch bound
// holds 64 registers a thread), at 512x512 C = 16 (160 KB, one block).
// Band route: every pass but S2 works within a row, so the plane is cut into
// bands of whole rows, and one f32 plane (S1) lies between two streaming
// launches:
// - Row launch (luma_rows_kernel): a group of threads takes a band of R
//   rows of one image and streams the X rows it needs, [y0-p, y1+p]
//   (reflect-101 at the image's rows), one row an iteration with one
//   barrier. The source rows' bytes arrive by cp.async kStage rows ahead
//   into a ring of byte rows (16-byte words where they lie inside the row,
//   so any alignment works). A thread turns 12 staged bytes into the luma
//   of 4 columns (a column near an edge also writes its reflect-101 mirror,
//   so no tap is reflected later), runs the X pass over its 4 columns from
//   4 + 2p staged values (three 16-byte shared loads at p = 4), keeps the
//   last 2p+1 X values of each column in registers (p = 4, the loop
//   unrolled 2p+1 times so the window rotates by renaming; any other p
//   keeps them in a ring of X rows in shared memory), emits the B row, and
//   shifts the B row of the iteration before into S1 (pass 1, from a B row
//   buffer that holds fill at -1 and w: the taps are clamped, not tested).
// - Column launch (luma_cols_kernel): a group takes a band of R rows. A
//   thread walks a column down the band: S2[y, x] from S1 rows y+k2[x] and
//   y+k2[x]+1, the second tap of a row being the first of the next, the
//   taps of 8 rows loaded at once through the read-only path; a warp's
//   loads touch the few rows that k2 spans over its columns. The S2 band
//   goes to shared memory (fill at -1 and w); pass 3 shifts each row, a
//   pixel a thread, quantizes into a shared byte band at the output's
//   alignment, and the band leaves as 16-byte words.
// - Windows. A unit of either launch is (image, band, column segment); the
//   band's rows read B (S2) columns [x0 + min k1, x1 + max k1] of the
//   segment [x0, x1), clamped to [-1, w], which the threads take from the
//   band's k1 rows in shared memory (next_window). With whole rows (the
//   host's choice wherever the buffers fit, the main path's shapes
//   included) the window always fits. Wide images are cut into segments;
//   where the band's shifts spread wider than the window buffer (near 180
//   degrees) the band is split into sub-bands that fit, each streaming its
//   own X rows. No bound comes from the host.
// - Small images (h < 128): a block holds several images' bands, one
//   group each (the TPU kernel's packing).
// Device traffic: 3 B a pixel in (plus the 2p halo rows of a band), 4 B out
// and ~4 B back of S1, 3 B out.
//
// The band route is kept for what the resident route does not hold: below
// 128 rows (#2, several images a block), above 512 columns, and planes too
// large for a cluster of 16 blocks; tests select it at any shape with a
// LumaGeometry.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md sections 5 and 6):
// at 1024x224x224 the band route's pair takes 0.74-0.75 ms of device time a
// call (the row launch 0.49, the column launch 0.26: ~720 MB moved), the
// resident route 0.44-0.46 ms (308 MB); at 32x512x512 0.110 and 0.095 ms;
// at the route's edges 128x128x512 (C = 8) 0.102 and 0.086 ms, 352x160x149
// (C = 2) 0.246 and 0.125 ms (no other shape measured).
// Removing one stage at a time, the resident route's time at 1024x224x224
// splits into luma and the X pass 0.12 ms, the Y pass 0.05, pass 1 0.05,
// pass 2 0.07, pass 3 and the bytes out 0.08, and 0.07 of launch, tables
// and cluster barriers. Each loop issues a batch of loads before using any:
// one item at a time, behind a branch each, the stages waited on every
// load. Larger clusters (more halo rows), fewer warps a block, and
// persistent clusters looping over images were slower.

#include <cstdint>
#include <cstring>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 4;            // blur columns a thread of the row launch owns
constexpr int kMaxThreads = 512;    // threads a block, at most (the launch bound)
constexpr int kMaxBlocks = 1 << 20; // blocks loop over the units beyond this
constexpr int kMaxSmem = 232448;    // shared bytes a block may have on the H100
constexpr int kStage = 7;           // source rows the row launch has in flight (a ring of 8)
static_assert(((kStage + 1) & kStage) == 0, "the byte ring's slots are a power of two");
constexpr int kPass2 = 8;           // rows of a column the column launch loads at once
constexpr int kMaxCluster = 16;     // blocks a cluster, at most (16: a non-portable size)
constexpr int kQuads = 4;           // column quads of a source row a lane of the resident kernel loads

__host__ __device__ __forceinline__ int up4(int v) { return (v + 3) & ~3; }

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float lerp_rn(float a, float b, float f) {
  return __fadd_rn(a, __fmul_rn(f, __fsub_rn(b, a)));
}

// The blur's taps over a window of 2p + 1 values v(0) .. v(2p): the centre
// tap first, then the mirrored pairs t = 0..p-1 as acc + taps[t]*(lo + hi).
// P >= 0: p as a constant (the loop unrolled, v's indices constant).
template <int P, typename F>
__device__ __forceinline__ float tap_sum(const float* tr, int p, F v) {
  if constexpr (P >= 0) {
    float acc = __fmul_rn(tr[P], v(P));
#pragma unroll
    for (int t = 0; t < P; ++t)
      acc = __fadd_rn(acc, __fmul_rn(tr[t], __fadd_rn(v(t), v(2 * P - t))));
    return acc;
  } else {
    float acc = __fmul_rn(tr[p], v(p));
    for (int t = 0; t < p; ++t)
      acc = __fadd_rn(acc, __fmul_rn(tr[t], __fadd_rn(v(t), v(2 * p - t))));
    return acc;
  }
}

// floor(v + 0.5) held to a byte (v >= -0.5, so the cast's truncation floors)
__device__ __forceinline__ uint32_t quantize(float v) {
  return (uint32_t)clampi((int)__fadd_rn(v, 0.5f), 0, 255);
}

// cv2 BORDER_REFLECT_101 index, exact for i in [-(n-1), 2n-2] (p <= n - 1)
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  return i >= n ? 2 * (n - 1) - i : i;
}

// exact integer L24 luma (< 2^24, exact in f32) times 2^-16
__device__ __forceinline__ float luma(uint32_t r, uint32_t g, uint32_t b) {
  const int lum = (int)(g * 38470u + r * 19595u) + (int)(b * 7471u);
  return __fmul_rn((float)lum, 1.0f / 65536.0f);
}

// the luma of 4 pixels from their 12 bytes (RGB RGB RGB RGB) in 3 words
__device__ __forceinline__ float4 quad_luma(uint32_t r0, uint32_t r1, uint32_t r2) {
  return make_float4(luma(r0 & 255u, (r0 >> 8) & 255u, (r0 >> 16) & 255u),
                     luma(r0 >> 24, r1 & 255u, (r1 >> 8) & 255u),
                     luma((r1 >> 16) & 255u, r1 >> 24, r2 & 255u),
                     luma((r2 >> 8) & 255u, (r2 >> 16) & 255u, r2 >> 24));
}

struct Args {
  const uint8_t* x;
  float* s1;  // f32 [n, h, w]: row launch out, column launch in
  uint8_t* out;
  const float* taps;
  const int* k1;
  const float* f1;
  const int* k2;
  const float* f2;
  int stride_h, stride_w;  // per-image table strides (0: one set for the batch)
  int n, h, w, p;
  float fill;
  int rows;          // band rows of this launch
  int seg_w;         // output columns a unit
  int win;           // columns a window buffer holds
  int threads;       // threads a group
  int groups;        // groups a block
  int bands, segs;
  long long units;        // n * bands * segs
  long long unit_blocks;  // ceil(units / groups)
  int lw;            // floats of one staged luma row (row launch)
  int slot;          // bytes of a staged source row (row launch) or an output row
  int group_floats;  // floats of a group's part of shared memory
};

// One unit: image, band rows [y0, y0 + rows), output columns [x0, x1).
struct Unit {
  int img, y0, rows, x0, x1;
};

__device__ __forceinline__ Unit unit_of(const Args& a, long long u) {
  const int seg = (int)(u % a.segs);
  const long long t = u / a.segs;
  const int band = (int)(t % a.bands);
  Unit un;
  un.img = (int)(t / a.bands);
  un.y0 = band * a.rows;
  un.rows = min(a.rows, a.h - un.y0);
  un.x0 = seg * a.seg_w;
  un.x1 = min(un.x0 + a.seg_w, a.w);
  return un;
}

// Sub-band [ya, yb) of a band and the window [c0, c1] of B (S2) columns
// that the row shifts k1 of its rows read for output columns [x0, x1):
// [x0 + min k1, x1 + max k1] clamped to [-1, w], -1 and w standing for
// fill. yb is the largest row whose window still fits `win` columns; one
// row always fits (x1 - x0 + 1 <= win).
struct Window {
  int ya, yb, c0, c1;
};

__device__ __forceinline__ Window next_window(const int* k1s, int ya, int rows, int x0, int x1,
                                              int w, int win) {
  int kmin = k1s[ya], kmax = kmin;
  Window wd{ya, ya + 1, clampi(x0 + kmin, -1, w), clampi(x1 + kmax, -1, w)};
  for (int y = ya + 1; y < rows; ++y) {
    const int k = k1s[y];
    const int lo = min(kmin, k), hi = max(kmax, k);
    const int c0 = clampi(x0 + lo, -1, w), c1 = clampi(x1 + hi, -1, w);
    if (c1 - c0 + 1 > win) break;
    kmin = lo;
    kmax = hi;
    wd.yb = y + 1;
    wd.c0 = c0;
    wd.c1 = c1;
  }
  return wd;
}

// cp.async: 16-byte copies from device to shared memory that complete in
// the background, in groups; wait_group<N> waits until at most N of this
// thread's groups are still in flight.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
#else
  memcpy(dst, src, 16);
#endif
}

// a hint: bring the 128-byte line of `p` into L2
__device__ __forceinline__ void prefetch_l2(const void* p) {
#if defined(__CUDA_ARCH__)
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::);
#endif
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
#endif
}

// The thread-block cluster of the resident kernel: this block's rank, a
// barrier of all its threads (release / acquire: shared-memory writes before
// it are seen by every block after it), and another block's shared memory.
__device__ __forceinline__ int cluster_rank() {
  return (int)cooperative_groups::this_cluster().block_rank();
}

__device__ __forceinline__ void cluster_sync() { cooperative_groups::this_cluster().sync(); }

__device__ __forceinline__ const float* cluster_map(float* p, int rank) {
  return cooperative_groups::this_cluster().map_shared_rank(p, (unsigned)rank);
}

// A staged source row: the bytes of columns [sl, sh] of one row, held in a
// byte slot from the 16-byte boundary at or below their first byte, so the
// slot and the row share their alignment.
struct RowSpan {
  const uint8_t* start;  // first byte of column sl
  uintptr_t a0;          // the 16-byte boundary at or below it
  int nbytes;            // 3 * (sh - sl + 1)
};

__device__ __forceinline__ RowSpan row_span(const uint8_t* row, int sl, int sh) {
  RowSpan r;
  r.start = row + 3 * sl;
  r.a0 = reinterpret_cast<uintptr_t>(r.start) & ~(uintptr_t)15;
  r.nbytes = 3 * (sh - sl + 1);
  return r;
}

// Issue the copy of a row span into `slot`: whole 16-byte words inside the
// span's row (the row starts at `row`, `rowbytes` long) by cp.async, the
// bytes of the span in a word that crosses the row's ends one by one.
__device__ __forceinline__ void issue_row(uint8_t* slot, const RowSpan& r, const uint8_t* row,
                                          int rowbytes, int i, int T) {
  const uintptr_t lo = reinterpret_cast<uintptr_t>(row), hi = lo + rowbytes;
  const uintptr_t b0 = reinterpret_cast<uintptr_t>(r.start), b1 = b0 + r.nbytes;
  const int words = (int)((b1 - r.a0 + 15) >> 4);
  for (int q = i; q < words; q += T) {
    const uintptr_t g = r.a0 + 16 * (uintptr_t)q;
    if (g >= lo && g + 16 <= hi) {
      cp_async16(slot + 16 * q, reinterpret_cast<const void*>(g));
    } else {
      for (uintptr_t b = g > b0 ? g : b0; b < g + 16 && b < b1; ++b)
        slot[b - r.a0] = *reinterpret_cast<const uint8_t*>(b);
    }
  }
}

// Luma of a staged row (the slot of `r`, its columns [sl, sh]) into dst[s - lo],
// s in [lo, hi]: four columns at a time (12 bytes from 4 aligned words);
// each column whose reflect-101 mirror lies in [lo, -1] or [w, hi] writes
// it too, so no tap is reflected later. Threads i of T.
__device__ __forceinline__ void stage_luma(const uint8_t* slot, const RowSpan& r, float* dst,
                                           int lo, int hi, int sl, int sh, int w, int p, int i,
                                           int T) {
  const int off = (int)(reinterpret_cast<uintptr_t>(r.start) - r.a0);  // byte of column sl
  auto put = [&](int c, float v) {
    dst[c - lo] = v;
    if (c >= 1 && -c >= lo) dst[-c - lo] = v;
    if (c <= w - 2 && 2 * (w - 1) - c <= hi) dst[2 * (w - 1) - c - lo] = v;
  };
  const bool mirrors = lo < 0 || hi >= w;
  for (int q = (sl - lo) / 4 + i; lo + 4 * q <= sh; q += T) {  // columns lo + 4q .. + 3
    const int s0 = lo + 4 * q;
    if (s0 >= sl && s0 + 3 <= sh) {
      const int b = off + 3 * (s0 - sl);
      const uint32_t* wd = reinterpret_cast<const uint32_t*>(slot + (b & ~3));
      const uint32_t sft = 8u * (uint32_t)(b & 3);
      const uint32_t w0 = wd[0], w1 = wd[1], w2 = wd[2], w3 = wd[3];
      const float4 v = quad_luma(__funnelshift_r(w0, w1, sft), __funnelshift_r(w1, w2, sft),
                                 __funnelshift_r(w2, w3, sft));
      *reinterpret_cast<float4*>(dst + (s0 - lo)) = v;
      if (mirrors && (s0 <= p || s0 + 3 >= w - 1 - p)) {
        for (int m = 0; m < 4; ++m) put(s0 + m, m == 0 ? v.x : m == 1 ? v.y : m == 2 ? v.z : v.w);
      }
    } else {  // the ends of [sl, sh]
      for (int c = max(s0, sl); c <= s0 + 3 && c <= sh; ++c) {
        const uint8_t* px = slot + off + 3 * (c - sl);
        put(c, luma(px[0], px[1], px[2]));
      }
    }
  }
}

// The X pass of 4 columns from the 4 + 2p luma values L[0 ..] (16-byte
// aligned): column m from L[m .. m + 2p].
template <int P>
__device__ __forceinline__ void x_quad(const float* tr, int p, const float* L, float o[4]) {
  if constexpr (P >= 0) {
    float v[4 + 2 * P];
    static_assert(P % 2 == 0, "the X pass loads float4 / float2 words");
#pragma unroll
    for (int k = 0; k + 4 <= 4 + 2 * P; k += 4) {
      const float4 q = *reinterpret_cast<const float4*>(L + k);
      v[k] = q.x;
      v[k + 1] = q.y;
      v[k + 2] = q.z;
      v[k + 3] = q.w;
    }
    if constexpr ((2 * P) % 4 != 0) {
      const float2 q = *reinterpret_cast<const float2*>(L + 2 + 2 * P);
      v[2 + 2 * P] = q.x;
      v[3 + 2 * P] = q.y;
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) o[m] = tap_sum<P>(tr, p, [&](int t) { return v[m + t]; });
  } else {
#pragma unroll
    for (int m = 0; m < 4; ++m) o[m] = tap_sum<P>(tr, p, [&](int t) { return L[m + t]; });
  }
}

// A row's bytes out of a byte slot that holds them at the destination's
// offset modulo 16: whole 16-byte words, the bytes of the end words one by
// one. Threads i of T.
__device__ __forceinline__ void store_row(uint8_t* dst, const uint8_t* src, size_t nbytes, int i,
                                          int T) {
  const uintptr_t b0 = reinterpret_cast<uintptr_t>(dst), a0 = b0 & ~(uintptr_t)15;
  const uintptr_t b1 = b0 + nbytes;
  const int words = (int)((b1 - a0 + 15) >> 4);
#pragma unroll 2
  for (int q = i; q < words; q += T) {
    const uintptr_t d = a0 + 16 * (uintptr_t)q;
    if (d >= b0 && d + 16 <= b1) {
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(src + 16 * q);
    } else {
      for (uintptr_t b = d > b0 ? d : b0; b < d + 16 && b < b1; ++b)
        *reinterpret_cast<uint8_t*>(b) = src[b - a0];
    }
  }
}

// Row launch: luma, blur X then Y, pass 1, S1 out. P >= 0: p as a constant
// (register window); P < 0: any p (ring of X rows in shared memory).
template <int P>
__global__ void __launch_bounds__(kMaxThreads) luma_rows_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int p = P >= 0 ? P : a.p;
  const int K = 2 * p + 1;
  const int T = a.threads, w = a.w, h = a.h;
  const int g = threadIdx.x / T, i = threadIdx.x - g * T;
  const int wp = up4(a.win + 4);
  float* tp = smem;
  float* gs = smem + up4(K) + (size_t)g * a.group_floats;
  int* k1s = reinterpret_cast<int*>(gs);
  float* f1s = gs + up4(a.rows);
  float* lbuf = f1s + up4(a.rows);  // [2][lw]: luma of staged rows, lbuf[s - lo]
  float* bbuf = lbuf + 2 * a.lw;    // [2][wp]: B rows, column c at c - bc0 + 4
  uint8_t* ring = reinterpret_cast<uint8_t*>(bbuf + 2 * wp);  // [kStage + 1][slot] bytes
  float* xring = bbuf + 2 * wp + (kStage + 1) * a.slot / 4;  // [K][wp]: X rows (P < 0)
  for (int t = threadIdx.x; t < K; t += blockDim.x) tp[t] = a.taps[t];
  __syncthreads();
  float tr[P >= 0 ? 2 * P + 1 : 1];
  float xw[kCols][P >= 0 ? 2 * P + 1 : 1];  // the last 2p + 1 X rows of each column
  if constexpr (P >= 0) {
#pragma unroll
    for (int t = 0; t < K; ++t) tr[t] = tp[t];
  }
  const bool multi = a.groups > 1;  // then every group's band is one sub-band
  const int rowbytes = 3 * w;
  for (long long ub = blockIdx.x; ub < a.unit_blocks; ub += gridDim.x) {
    const long long u = ub * a.groups + g;
    Unit un{0, 0, 0, 0, 0};
    if (u < a.units) un = unit_of(a, u);
    const uint8_t* xi = a.x + (size_t)un.img * h * rowbytes;
    float* s1i = a.s1 + (size_t)un.img * h * w;
    __syncthreads();  // the previous unit's tables and buffers are consumed
    for (int j = i; j < un.rows; j += T) {
      k1s[j] = a.k1[(size_t)un.img * a.stride_h + un.y0 + j];
      f1s[j] = a.f1[(size_t)un.img * a.stride_h + un.y0 + j];
    }
    __syncthreads();
    int ya = 0;
    do {
      const Window wd = un.rows > 0 ? next_window(k1s, ya, un.rows, un.x0, un.x1, w, a.win)
                                    : Window{0, 0, 0, -1};
      const int nr = wd.yb - wd.ya;
      const int bc0 = max(wd.c0, 0), bc1 = min(wd.c1, w - 1);
      const int nb = bc1 - bc0 + 1;                      // blur columns (<= 0: all fill)
      const int nx = nr > 0 && nb > 0 ? nr + 2 * p : 0;  // X rows to stream
      const int lo = bc0 - p, hi = bc1 + p;  // staged columns, reflected into [sl, sh]
      const int sl = max(lo, 0), sh = min(hi, w - 1);
      const int ysrc = un.y0 + wd.ya - p;    // source row of X row 0
      auto row_of = [&](int rx) { return xi + (size_t)reflect101(ysrc + rx, h) * rowbytes; };
      auto slot_of = [&](int rx) { return ring + (rx & kStage) * a.slot; };
      auto issue = [&](int rx) {
        if (rx < nx) issue_row(slot_of(rx), row_span(row_of(rx), sl, sh), row_of(rx), rowbytes, i, T);
        cp_async_commit();
      };
      auto convert = [&](int rx, float* dst) {
        stage_luma(slot_of(rx), row_span(row_of(rx), sl, sh), dst, lo, hi, sl, sh, w, p, i, T);
      };
      if (i == 0 && nr > 0) {
        if (wd.c0 < 0) bbuf[3] = bbuf[wp + 3] = a.fill;
        if (wd.c1 >= w) bbuf[wd.c1 - bc0 + 4] = bbuf[wp + wd.c1 - bc0 + 4] = a.fill;
      }
      for (int rx = 0; rx <= kStage; ++rx) issue(rx);
      cp_async_wait<kStage>();
      __syncthreads();
      if (nx > 0) convert(0, lbuf);
      cp_async_wait<kStage - 1>();
      __syncthreads();
      const int iters = (multi ? a.rows : nr) + 2 * p + 2;
      const bool mine = i * kCols < nb;  // this thread owns blur columns
      // Iteration r: the Y pass of B row r - 2p - 1 (X rows up to r - 1),
      // then the X pass of row r into the slot that row r - 2p - 1 left, and
      // pass 1 of B row r - 2p - 2: three independent streams. P >= 0: K
      // iterations unrolled, so X row r sits in slot r % K = u of the
      // register window and no value moves.
      constexpr int kU = P >= 0 ? 2 * P + 1 : 1;
      for (int r0 = 0; r0 < iters; r0 += kU) {
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const int r = r0 + u;
        if (r >= iters) break;
        if (r + 1 < nx) convert(r + 1, lbuf + ((r + 1) & 1) * a.lw);
        const int jb = r - 2 * p - 1;  // B row whose X rows are all in
        if (mine && jb >= 0 && jb < nr) {
          float o[kCols];
          if constexpr (P >= 0) {  // X row jb + t is in slot (u + t) % K
#pragma unroll
            for (int m = 0; m < kCols; ++m)
              o[m] = tap_sum<P>(tr, p, [&](int t) { return xw[m][(u + t) % kU]; });
          } else {
            const float* rc = xring + i * kCols;  // xring[slot * wp + column - bc0]
            const int s0 = jb % K;  // slot of X row jb (row jb - p of B's window)
#pragma unroll
            for (int m = 0; m < kCols; ++m)
              o[m] = tap_sum<P>(tp, p, [&](int t) {
                const int sl = s0 + t < K ? s0 + t : s0 + t - K;
                return rc[sl * wp + m];
              });
          }
          float* bd = bbuf + (jb & 1) * wp + 4 + i * kCols;
          if (i * kCols + kCols <= nb) {
            *reinterpret_cast<float4*>(bd) = make_float4(o[0], o[1], o[2], o[3]);
          } else {
#pragma unroll
            for (int m = 0; m < kCols; ++m)
              if (i * kCols + m < nb) bd[m] = o[m];
          }
        }
        if (mine && r < nx) {  // X row r at columns bc0 + i*kCols + m
          const float* L = lbuf + (r & 1) * a.lw + i * kCols;
          float o[kCols];
          static_assert(kCols == 4, "the X pass takes 4 columns a thread");
          x_quad<P>(P >= 0 ? tr : tp, p, L, o);
          if constexpr (P >= 0) {
#pragma unroll
            for (int m = 0; m < kCols; ++m) xw[m][u] = o[m];
          } else {
            float* rc = xring + (r % K) * wp + i * kCols;
#pragma unroll
            for (int m = 0; m < kCols; ++m) rc[m] = o[m];
          }
        }
        const int jp = r - 2 * p - 2;  // B row completed one iteration ago: pass 1
        if (jp >= 0 && jp < nr) {
          const int yl = wd.ya + jp;
          const int k = k1s[yl];
          const float f = f1s[yl];
          const float* bs = bbuf + (jp & 1) * wp + 4 - bc0;  // bs[column], column in [c0, c1]
          float* dst = s1i + (size_t)(un.y0 + yl) * w;
#pragma unroll 4
          for (int xo = un.x0 + i; xo < un.x1; xo += T) {
            const int xs = xo + k;
            dst[xo] = lerp_rn(bs[clampi(xs, -1, w)], bs[clampi(xs + 1, -1, w)], f);
          }
        }
        issue(r + 1 + kStage);
        cp_async_wait<kStage - 1>();  // row r + 2 has landed
        __syncthreads();
      }
      }
      ya = wd.yb;
    } while (!multi && ya < un.rows);
  }
}

// Column launch: pass 2 from S1 into a shared S2 band, pass 3, quantize
// into a shared byte band, then out as 16-byte words.
__global__ void __launch_bounds__(kMaxThreads) luma_cols_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int T = a.threads, w = a.w, h = a.h;
  const int g = threadIdx.x / T, i = threadIdx.x - g * T;
  const int wp = up4(a.win);
  float* gs = smem + (size_t)g * a.group_floats;
  int* k1s = reinterpret_cast<int*>(gs);
  float* f1s = gs + up4(a.rows);
  float* s2 = f1s + up4(a.rows);  // [rows][wp]: S2 rows, column c at c - c0
  uint8_t* ob = reinterpret_cast<uint8_t*>(s2 + a.rows * wp);  // [rows][slot]: output bytes
  const bool multi = a.groups > 1;
  for (long long ub = blockIdx.x; ub < a.unit_blocks; ub += gridDim.x) {
    const long long u = ub * a.groups + g;
    Unit un{0, 0, 0, 0, 0};
    if (u < a.units) un = unit_of(a, u);
    const float* s1i = a.s1 + (size_t)un.img * h * w;
    const int* k2 = a.k2 + (size_t)un.img * a.stride_w;
    const float* f2 = a.f2 + (size_t)un.img * a.stride_w;
    __syncthreads();
    for (int j = i; j < un.rows; j += T) {
      k1s[j] = a.k1[(size_t)un.img * a.stride_h + un.y0 + j];
      f1s[j] = a.f1[(size_t)un.img * a.stride_h + un.y0 + j];
    }
    __syncthreads();
    int ya = 0;
    do {
      const Window wd = un.rows > 0 ? next_window(k1s, ya, un.rows, un.x0, un.x1, w, a.win)
                                    : Window{0, 0, 0, -1};
      const int nr = wd.yb - wd.ya;
      const int nc = nr > 0 ? wd.c1 - wd.c0 + 1 : 0;
      for (int cc = i; cc < nc; cc += T) {  // pass 2, a column down the sub-band
        const int c = wd.c0 + cc;
        float* col = s2 + cc;
        if (c < 0 || c >= w) {
          for (int j = 0; j < nr; ++j) col[j * wp] = a.fill;
          continue;
        }
        const int kc = k2[c];
        const float fc = f2[c];
        const float* sc = s1i + c;
        // kPass2 rows at a time: their kPass2 + 1 taps are loaded first
        // (through the read-only path, so no shared store waits for them)
        for (int j0 = 0; j0 < nr; j0 += kPass2) {
          const int ys = un.y0 + wd.ya + j0 + kc;  // S1 row of row j0's first tap
          float v[kPass2 + 1];
#pragma unroll
          for (int t = 0; t <= kPass2; ++t) {
            const int y = ys + t;
            v[t] = y >= 0 && y < h && j0 + t <= nr ? __ldg(sc + (size_t)y * w) : a.fill;
          }
#pragma unroll
          for (int t = 0; t < kPass2; ++t)
            if (j0 + t < nr) col[(j0 + t) * wp] = lerp_rn(v[t], v[t + 1], fc);
        }
      }
      __syncthreads();
      // pass 3 and the quantization, a pixel a thread a row: its 3 bytes go
      // to the row's byte slot at the same offset modulo 16 as in the output
      const int nx = un.x1 - un.x0;
      for (int j = 0; j < nr; ++j) {
        const int yl = wd.ya + j;
        const int k = k1s[yl];
        const float f = f1s[yl];
        const float* row = s2 + j * wp - wd.c0;  // row[column], column in [c0, c1]
        const uint8_t* dst = a.out + (((size_t)un.img * h + un.y0 + yl) * w + un.x0) * 3;
        uint8_t* ob_row = ob + j * a.slot + (reinterpret_cast<uintptr_t>(dst) & 15);
#pragma unroll 4
        for (int xo = i; xo < nx; xo += T) {
          const int xs = un.x0 + xo + k;
          const float v = lerp_rn(row[clampi(xs, -1, w)], row[clampi(xs + 1, -1, w)], f);
          const uint8_t q = (uint8_t)quantize(v);
          ob_row[3 * xo] = ob_row[3 * xo + 1] = ob_row[3 * xo + 2] = q;
        }
      }
      __syncthreads();
      for (int j = 0; j < nr; ++j)  // out: whole 16-byte words, bytes at the ends
        store_row(a.out + (((size_t)un.img * h + un.y0 + wd.ya + j) * w + un.x0) * 3,
                  ob + j * a.slot, 3 * (size_t)nx, i, T);
      __syncthreads();
      ya = wd.yb;
    } while (!multi && ya < un.rows);
  }
}

// Resident kernel: one launch, a cluster of C blocks an image. Block r owns
// S1 rows [r*slab, (r+1)*slab) in its shared memory.
struct Resident {
  const uint8_t* x;
  uint8_t* out;
  const float* taps;
  const int* k1;
  const float* f1;
  const int* k2;
  const float* f2;
  int stride_h, stride_w;  // per-image table strides (0: one set for the batch)
  int n, h, w, p;
  float fill;
  int cluster;  // blocks a cluster: one image a cluster
  int slab;     // S1 rows a block owns: ceil(h / cluster)
  int pw;       // floats of a row of the plane (luma and X rows, then S1 rows)
  int off_t;    // float offsets: the tables, the row pointers, the plane
  int off_r;
  int off_p;
};

// A lane's column quads of a source row: the 12 bytes of columns 4m .. 4m+3,
// m = lane + 32i, as 3 words: from a 4-byte aligned row of whole quads by
// word loads (clamped to the last quad, so all are issued before any is
// used), else byte by byte.
__device__ __forceinline__ void load_quads(const uint8_t* row, int w, int lane,
                                           uint32_t (&v)[kQuads][3]) {
  const int nq = (w + 3) >> 2;
  if ((reinterpret_cast<uintptr_t>(row) & 3) == 0 && (w & 3) == 0) {
#pragma unroll
    for (int i = 0; i < kQuads; ++i) {
      if (32 * i < nq) {
        const uint32_t* q = reinterpret_cast<const uint32_t*>(row) + 3 * min(lane + 32 * i, nq - 1);
        v[i][0] = __ldg(q);
        v[i][1] = __ldg(q + 1);
        v[i][2] = __ldg(q + 2);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kQuads; ++i) {
      const int m = lane + 32 * i;
      if (4 * m < w) {
        uint32_t b[3] = {0u, 0u, 0u};
#pragma unroll
        for (int k = 0; k < 12; ++k)
          if (4 * m + k / 3 < w) b[k >> 2] |= (uint32_t)__ldg(row + 12 * m + k) << (8 * (k & 3));
        v[i][0] = b[0];
        v[i][1] = b[1];
        v[i][2] = b[2];
      }
    }
  }
}

// The whole slab lives in shared memory, and each pass is one wide stage
// over it. Two regions: the plane (pw floats a row: the X rows, then the S1
// rows) and the bands (w + 2 floats a row, fill at columns -1 and w: the B
// rows, then the S2 rows).
// A0: the slab's X rows xr in [0, rows + 2p), source rows y0 - p + xr
//    reflected at the image's rows, requested into L2 all at once.
// A1 (a warp a row): the row's bytes (a lane 4 columns at a time, from
//    L2), its luma (and the reflect-101 mirrors) at columns [-p, w + p)
//    into plane row xr, then the X pass over it in place.
// A2 (a thread a column and a segment of its rows): the Y pass down the
//    column into the B rows.
// A3 (a warp a row): pass 1, B rows shifted into the plane's S1 rows.
// B1 (a warp 32 columns and a segment of rows), after a cluster barrier:
//    pass 2, S2 row j from S1 rows y + k2[c] and the next, read from
//    whichever block of the cluster owns them (distributed shared memory, a
//    table of row pointers; rows off the canvas point at a row of fill).
// B2 (a warp a row): pass 3 and the quantization, 32 columns a step, each
//    step's 96 bytes out as 32-bit words.
template <int P>
__global__ void __launch_bounds__(kMaxThreads, 2) luma_resident_kernel(const Resident a) {
  extern __shared__ __align__(16) float smem[];
  const int p = P >= 0 ? P : a.p;
  const int K = 2 * p + 1;
  const int w = a.w, h = a.h, T = blockDim.x, W = T >> 5, pw = a.pw;
  const int lane = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int rank = cluster_rank();
  const int y0 = rank * a.slab;
  const int rows = max(0, min(a.slab, h - y0));
  const float fill = a.fill;
  const int bw = w + 2;
  float* bands = smem + 1;  // B (then S2) row j, column c at bands[j * bw + c], c in [-1, w]
  int* k1s = reinterpret_cast<int*>(smem + a.off_t);
  float* f1s = smem + a.off_t + up4(a.slab);
  float* tp = f1s + up4(a.slab);
  int* k2s = reinterpret_cast<int*>(tp + up4(K));
  float* f2s = tp + up4(K) + up4(w);
  float* fills = f2s + up4(w);  // a row of fill: S1 rows -1 and h
  const float** rowp = reinterpret_cast<const float**>(smem + a.off_r);  // S1 row y at [y + 1]
  float* plane = smem + a.off_p;  // X row xr at plane[xr * pw], then S1 row j at plane[j * pw]
  const int nxr = rows > 0 ? rows + 2 * p : 0;  // X rows of the slab
  const int img = blockIdx.x / a.cluster;
  auto src_row = [&](int xr) {
    return a.x + ((size_t)img * h + reflect101(y0 - p + xr, h)) * 3 * w;
  };
  // A0: the slab's source rows into L2, all requested at once
  const int lines = (3 * w + 127) >> 7;  // a row's bytes at every 128 from its first, and its last
  for (int t = threadIdx.x; t < nxr * (lines + 1); t += T) {
    const int xr = t / (lines + 1), l = t - xr * (lines + 1);
    prefetch_l2(src_row(xr) + min(128 * l, 3 * w - 1));
  }
  for (int j = threadIdx.x; j < rows; j += T) {
    k1s[j] = a.k1[(size_t)img * a.stride_h + y0 + j];
    f1s[j] = a.f1[(size_t)img * a.stride_h + y0 + j];
  }
  for (int c = threadIdx.x; c < w; c += T) {
    k2s[c] = a.k2[(size_t)img * a.stride_w + c];
    f2s[c] = a.f2[(size_t)img * a.stride_w + c];
    fills[c] = fill;
  }
  for (int t = threadIdx.x; t < K; t += T) tp[t] = a.taps[t];
  for (int j = threadIdx.x; j < rows; j += T) bands[j * bw - 1] = bands[j * bw + w] = fill;
  for (int y = threadIdx.x; y < h + 2; y += T) {
    const int yy = y - 1, o = yy / a.slab;
    rowp[y] = yy < 0 || yy >= h ? fills : cluster_map(plane, o) + (size_t)(yy - o * a.slab) * pw;
  }
  __syncthreads();
  float tr[P >= 0 ? 2 * P + 1 : 1];
  if constexpr (P >= 0) {
#pragma unroll
    for (int t = 0; t < K; ++t) tr[t] = tp[t];
  }

  // ---- A1: luma and the X pass, a warp a row
  const int nq = (w + 3) >> 2;  // column quads of a row
  for (int xr = g; xr < nxr; xr += W) {
    float* lrow = plane + xr * pw;  // luma column c at c + p, then X column c at c
    uint32_t qw[kQuads][3];
    load_quads(src_row(xr), w, lane, qw);
#pragma unroll
    for (int i = 0; i < kQuads; ++i) {
      const int m = lane + 32 * i;
      if (4 * m >= w) continue;
      const float4 v = quad_luma(qw[i][0], qw[i][1], qw[i][2]);
      const float vs[4] = {v.x, v.y, v.z, v.w};
      if (p % 4 == 0 && 4 * m + 3 < w && 4 * m > p && 4 * m + 3 < w - 1 - p) {
        *reinterpret_cast<float4*>(lrow + 4 * m + p) = v;
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int c = 4 * m + t;
          if (c < w) {
            lrow[c + p] = vs[t];
            if (c >= 1 && c <= p) lrow[p - c] = vs[t];
            if (c <= w - 2 && c >= w - 1 - p) lrow[2 * (w - 1) - c + p] = vs[t];
          }
        }
      }
    }
    __syncwarp();
    // X over the luma in place, 32 quads at a time: quad q reads luma at
    // [4q, 4q + 4 + 2p) and writes X at [4q, 4q + 4), which only the quads
    // of this pass and the passes before read
    for (int q0 = 0; q0 < nq; q0 += 32) {
      const int q = q0 + lane;
      float o[4];
      if (q < nq) {
        if constexpr (P >= 0) {
          x_quad<P>(tr, p, lrow + 4 * q, o);
        } else {
          x_quad<P>(tp, p, lrow + 4 * q, o);
        }
      }
      __syncwarp();
      if (q < nq) *reinterpret_cast<float4*>(lrow + 4 * q) = make_float4(o[0], o[1], o[2], o[3]);
    }
  }
  __syncthreads();

  // ---- A2: the Y pass down the columns into the B rows, each column's rows
  // cut into segments so that every thread works
  {
    const int segs = rows > 0 ? max(1, min(T / w, rows)) : 0;
    for (int it = threadIdx.x; it < segs * w; it += T) {
      const int seg = it / w, c = it - seg * w;
      const int jb = seg * rows / segs, je = (seg + 1) * rows / segs;
      const float* col = plane + c;  // X row r at col[r * pw]
      float* dst = bands + c;        // B row j at dst[j * bw]
      if constexpr (P >= 0) {
        constexpr int K2 = 2 * P + 1;
        float xw[K2];  // X row jb + i in slot i % K2
#pragma unroll
        for (int t = 0; t < 2 * P; ++t) xw[t] = col[(jb + t) * pw];
        const float* __restrict__ xn = col + (jb + 2 * P) * pw;  // the next X row to load
        float* __restrict__ bd = dst + jb * bw;
        int j = jb;  // row j + u takes X rows j + u + t from slot (u + t) % K2
        for (; j + K2 <= je; j += K2, xn += K2 * pw, bd += K2 * bw) {
          float nx[K2];  // the group's loads, all issued first
#pragma unroll
          for (int u = 0; u < K2; ++u) nx[u] = xn[u * pw];
#pragma unroll
          for (int u = 0; u < K2; ++u) {
            xw[(u + 2 * P) % K2] = nx[u];
            bd[u * bw] = tap_sum<P>(tr, p, [&](int t) { return xw[(u + t) % K2]; });
          }
        }
#pragma unroll
        for (int u = 0; u < K2 - 1; ++u) {
          if (j + u < je) {
            xw[(u + 2 * P) % K2] = xn[u * pw];
            bd[u * bw] = tap_sum<P>(tr, p, [&](int t) { return xw[(u + t) % K2]; });
          }
        }
      } else {
        for (int j = jb; j < je; ++j)
          dst[j * bw] = tap_sum<P>(tp, p, [&](int t) { return col[(j + t) * pw]; });
      }
    }
  }
  __syncthreads();

  // ---- A3: pass 1, a warp a row: S1 row j from B row j
  for (int j = g; j < rows; j += W) {
    const int k = k1s[j];
    const float f = f1s[j];
    const float* __restrict__ brow = bands + j * bw;
    float* __restrict__ dst = plane + j * pw;
    for (int x0 = lane; x0 < w; x0 += 4 * 32) {
      float va[4], vb[4];  // 4 columns' taps, all loaded first
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int xs = x0 + 32 * i + k;
        va[i] = brow[clampi(xs, -1, w)];
        vb[i] = brow[clampi(xs + 1, -1, w)];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (x0 + 32 * i < w) dst[x0 + 32 * i] = lerp_rn(va[i], vb[i], f);
    }
  }
  cluster_sync();  // every slab of the cluster is written

  // ---- B1: pass 2, a warp 32 columns and a segment of rows, into the S2
  // rows (over the B rows). The warp walks the S1 rows its columns' taps
  // span, one row a step for all lanes (a coalesced read of the owner's
  // row); lane c finishes S2 row r - 1 - k2[c] - y0 from S1 rows r - 1, r.
  const int groups = (w + 31) >> 5, bsegs = rows > 0 ? max(1, min(W / groups, rows)) : 0;
  for (int it = g; it < groups * bsegs; it += W) {
    const int seg = it / groups, c = ((it - seg * groups) << 5) + lane, cc = min(c, w - 1);
    const int jb = seg * rows / bsegs, je = (seg + 1) * rows / bsegs;
    const int kc = k2s[cc];
    const float fc = f2s[cc];
    const int kmin = __reduce_min_sync(0xffffffffu, kc), kmax = __reduce_max_sync(0xffffffffu, kc);
    // lane c's rows: S2 row r - 1 - kc - y0 for r in [ra, rb)
    const int ra = c < w ? y0 + jb + kc + 1 : 0x7fffffff, rb = y0 + je + kc + 1;
    const int r1 = y0 + je + kmax;  // the last S1 row a tap of the segment reads
    int r = y0 + jb + kmin;
    float prev = rowp[clampi(r, -1, h) + 1][cc];
    float* __restrict__ sd = bands + (r - kc - y0) * bw + c;  // S2 row r - kc - y0 at step r + 1
    for (++r; r <= r1; r += 8, sd += 8 * bw) {
      float v[8];  // S1 rows r .. r + 7, all loaded first
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = rowp[clampi(r + i, -1, h) + 1][cc];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (r + i >= ra && r + i < rb && r + i <= r1) sd[i * bw] = lerp_rn(prev, v[i], fc);
        prev = v[i];
      }
    }
  }
  __syncthreads();

  // ---- B2: pass 3 and the quantization, a warp a row, 32 columns a step
  for (int j = g; j < rows; j += W) {
    const int k = k1s[j];
    const float f = f1s[j];
    const float* srow = bands + j * bw;
    uint8_t* orow = a.out + ((size_t)img * h + y0 + j) * 3 * w;
    const bool aligned = (reinterpret_cast<uintptr_t>(orow) & 3) == 0;
    // word i of a step's 96 bytes: bytes 4i .. 4i+3, of pixels (4i)/3 and (4i+3)/3
    const int pa = (4 * lane) / 3, pb = ((4 * lane + 3) / 3) & 31, r3 = lane % 3;
    const uint32_t ma = r3 == 0 ? 0x00010101u : r3 == 1 ? 0x00000101u : 0x00000001u;
    for (int x0 = 0; x0 < w; x0 += 4 * 32) {
      uint32_t q[4];  // 4 steps' pixels, their taps all loaded first
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int xs = x0 + 32 * i + lane + k;
        q[i] = quantize(lerp_rn(srow[clampi(xs, -1, w)], srow[clampi(xs + 1, -1, w)], f));
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c0 = x0 + 32 * i;
        uint8_t* dst = orow + 3 * c0;
        if (aligned && c0 + 32 <= w) {
          const uint32_t qa = __shfl_sync(0xffffffffu, q[i], pa);
          const uint32_t qb = __shfl_sync(0xffffffffu, q[i], pb);
          if (lane < 24) reinterpret_cast<uint32_t*>(dst)[lane] = qa * ma + qb * (0x01010101u - ma);
        } else if (c0 + lane < w) {
          dst[3 * lane] = dst[3 * lane + 1] = dst[3 * lane + 2] = (uint8_t)q[i];
        }
      }
    }
  }
  cluster_sync();  // no block leaves while another reads its S1 rows
}

template <typename Kern>
cudaError_t launch(Kern kernel, Args a, int rows, cudaStream_t st, bool ring) {
  const int K = 2 * a.p + 1;
  a.rows = rows < a.h ? rows : a.h;
  rows = a.rows;
  a.bands = (a.h + rows - 1) / rows;
  a.segs = (a.w + a.seg_w - 1) / a.seg_w;
  a.units = (long long)a.n * a.bands * a.segs;
  a.unit_blocks = (a.units + a.groups - 1) / a.groups;
  size_t floats;
  if (a.lw > 0) {  // row launch: taps, then per group k1s, f1s, lbuf, bbuf, byte ring[, X ring]
    const int wp = up4(a.win + 4);
    a.slot = (3 * (a.threads * kCols + 2 * a.p) + 32 + 15) & ~15;
    a.group_floats = 2 * up4(rows) + 2 * a.lw + 2 * wp + (kStage + 1) * a.slot / 4 +
                     (ring ? K * wp : 0);
    floats = up4(K) + (size_t)a.groups * a.group_floats;
  } else {  // column launch: per group k1s, f1s, the S2 band, the byte band
    a.slot = (3 * a.seg_w + 16 + 15) & ~15;
    a.group_floats = 2 * up4(rows) + rows * up4(a.win) + rows * a.slot / 4;
    floats = (size_t)a.groups * a.group_floats;
  }
  const size_t smem = floats * sizeof(float);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long blocks = a.unit_blocks < kMaxBlocks ? a.unit_blocks : kMaxBlocks;
  kernel<<<(unsigned)blocks, a.groups * a.threads, smem, st>>>(a);
  return cudaGetLastError();
}

// The resident kernel's shared memory (bytes): the bands (slab rows of w + 2
// floats, from the second float on), the tables (k1, f1 of its rows, the
// taps, k2, f2, a row of fill), the row pointers, then the plane of
// slab + 2p rows of pw floats. Fills the layout fields of `a`.
size_t resident_layout(Resident& a) {
  const int w = a.w, h = a.h, p = a.p, K = 2 * p + 1;
  a.slab = (h + a.cluster - 1) / a.cluster;
  a.pw = up4(w) + up4(2 * p);
  a.off_t = up4(a.slab * (w + 2) + 1);
  a.off_r = a.off_t + 2 * up4(a.slab) + up4(K) + 3 * up4(w);
  a.off_p = a.off_r + 2 * up4(h + 2);
  return ((size_t)a.off_p + (size_t)(a.slab + 2 * p) * a.pw) * sizeof(float);
}

}  // namespace

// x: u8 [n, h, w, 3]; s1: f32 [n, h, w] (the plane between the launches);
// out: u8 [n, h, w, 3]; taps: f32 [2p + 1]; k1/f1: [h] and k2/f2: [w] per
// image, images stride_h / stride_w elements apart (0: one set for all).
// Geometry (megakernel._luma_geometry): band rows of the row and column
// launches, output columns a unit (w: whole rows), window columns a buffer
// holds (w + 2 with whole rows), threads a group (with kCols, at least the
// window's columns on the canvas), groups a block (> 1 only with whole
// rows). Launches on `stream`; returns a CUDA error code (0 on success).
extern "C" int luma_blur_rotate(const void* x, void* s1, void* out, const void* taps, int p,
                                const void* k1, const void* f1, const void* k2, const void* f2,
                                int stride_h, int stride_w, int n, int h, int w, int fill,
                                int rows_a, int rows_b, int seg_w, int win, int threads,
                                int groups, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0) return cudaSuccess;
  const bool whole = seg_w >= w;
  if (p < 0 || p > h - 1 || p > w - 1 || rows_a < 1 || rows_b < 1 || seg_w < 1 ||
      threads < 1 || groups < 1 || groups * threads > kMaxThreads ||
      win < (whole ? w + 2 : seg_w + 1) || threads * kCols < (win < w ? win : w) ||
      (groups > 1 && !whole))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{};
  a.x = static_cast<const uint8_t*>(x);
  a.s1 = static_cast<float*>(s1);
  a.out = static_cast<uint8_t*>(out);
  a.taps = static_cast<const float*>(taps);
  a.k1 = static_cast<const int*>(k1);
  a.f1 = static_cast<const float*>(f1);
  a.k2 = static_cast<const int*>(k2);
  a.f2 = static_cast<const float*>(f2);
  a.stride_h = stride_h;
  a.stride_w = stride_w;
  a.n = n;
  a.h = h;
  a.w = w;
  a.p = p;
  a.fill = static_cast<float>(fill);
  a.seg_w = seg_w < w ? seg_w : w;
  a.win = win;
  a.threads = threads;
  a.groups = groups;
  a.lw = up4(threads * kCols + 2 * p);
  cudaError_t err = p == 4 ? launch(luma_rows_kernel<4>, a, rows_a, st, false)
                           : launch(luma_rows_kernel<-1>, a, rows_a, st, true);
  if (err != cudaSuccess) return err;
  a.lw = 0;
  return launch(luma_cols_kernel, a, rows_b, st, false);
}

// The resident route: one launch, one image a cluster of `cluster` blocks of
// kMaxThreads threads, S1 in the cluster's shared memory (no S1 plane in
// device memory). Arguments as luma_blur_rotate's; w <= 128 * kQuads. The
// host picks the cluster from (h, w, p) alone (megakernel._resident_geometry).
extern "C" int luma_blur_rotate_resident(const void* x, void* out, const void* taps, int p,
                                         const void* k1, const void* f1, const void* k2,
                                         const void* f2, int stride_h, int stride_w, int n, int h,
                                         int w, int fill, int cluster, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0) return cudaSuccess;
  if (p < 0 || p > h - 1 || p > w - 1 || w > 128 * kQuads || cluster < 1 ||
      cluster > kMaxCluster || (long long)n * cluster > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  Resident a{};
  a.x = static_cast<const uint8_t*>(x);
  a.out = static_cast<uint8_t*>(out);
  a.taps = static_cast<const float*>(taps);
  a.k1 = static_cast<const int*>(k1);
  a.f1 = static_cast<const float*>(f1);
  a.k2 = static_cast<const int*>(k2);
  a.f2 = static_cast<const float*>(f2);
  a.stride_h = stride_h;
  a.stride_w = stride_w;
  a.n = n;
  a.h = h;
  a.w = w;
  a.p = p;
  a.fill = static_cast<float>(fill);
  a.cluster = cluster;
  const size_t smem = resident_layout(a);
  if (smem > (size_t)kMaxSmem) return cudaErrorInvalidValue;
  void (*kernel)(const Resident) = p == 4 ? luma_resident_kernel<4> : luma_resident_kernel<-1>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  if (cluster > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3((unsigned)(n * cluster), 1, 1);
  cfg.blockDim = dim3((unsigned)kMaxThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
