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
// All compute one function; here it is one pair of launches whose geometry
// (band rows, column segments, images a block) the host picks
// (megakernel._luma_geometry). The output does not depend on the geometry.
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
//
// Bound on the H100 (3.35 TB/s): the function reads n*h*w*3 u8 and writes
// as many: ~15 us at 32x512x512x3. Its ~3*(2p+1)+20 unfused operations a
// pixel take ~12 us at 33.5e12 a second with p = 4, so bytes bound it.
//
// Design. Every pass but the column shear S2 works within a row, so the
// plane is cut into bands of whole rows, and one f32 plane (S1) lies between
// two streaming launches:
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
// Measured on an NVIDIA H100 80GB HBM3 at 700 W: PERF.md sections 5 and 6
// (tools/time_rgb_blur_rotate.py, chip_smoke.py) give the times beside the
// earlier design's (a tiled blur into f32 scratch, then a gather of 8
// scratch values an output pixel) and the bound; the row launch takes the
// larger part. Both launches issue at a fraction of the SM's rate: the row
// launch holds 128 registers a thread (4 blocks of 4 warps an SM) and
// capping them spills; without its barrier, or with its Y pass independent
// of the X pass in an iteration, it takes the same time; its luma staging
// costs the most of its phases.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 4;            // blur columns a thread of the row launch owns
constexpr int kMaxThreads = 512;    // threads a block, at most (the launch bound)
constexpr int kMaxBlocks = 1 << 20; // blocks loop over the units beyond this
constexpr int kMaxSmem = 232448;    // shared bytes a block may have on the H100
constexpr int kStage = 7;           // source rows the row launch has in flight (a ring of 8)
static_assert(((kStage + 1) & kStage) == 0, "the byte ring's slots are a power of two");
constexpr int kPass2 = 8;           // rows of a column the column launch loads at once

__host__ __device__ __forceinline__ int up4(int v) { return (v + 3) & ~3; }

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ float lerp_rn(float a, float b, float f) {
  return __fadd_rn(a, __fmul_rn(f, __fsub_rn(b, a)));
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
      // luma of staged row rx into dst[s - lo], s in [lo, hi]: the row's
      // columns [sl, sh] four at a time (12 bytes from 4 aligned words); each
      // column whose mirror lies in [lo, -1] or [w, hi] writes it too, so no
      // tap is reflected later
      auto convert = [&](int rx, float* dst) {
        const RowSpan r = row_span(row_of(rx), sl, sh);
        const uint8_t* slot = slot_of(rx);
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
            const uint32_t r0 = __funnelshift_r(w0, w1, sft), r1 = __funnelshift_r(w1, w2, sft),
                           r2 = __funnelshift_r(w2, w3, sft);
            const float4 v = make_float4(luma(r0 & 255u, (r0 >> 8) & 255u, (r0 >> 16) & 255u),
                                         luma(r0 >> 24, r1 & 255u, (r1 >> 8) & 255u),
                                         luma((r1 >> 16) & 255u, r1 >> 24, r2 & 255u),
                                         luma((r2 >> 8) & 255u, (r2 >> 16) & 255u, r2 >> 24));
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
            for (int m = 0; m < kCols; ++m) {
              float acc = __fmul_rn(tr[P], xw[m][(u + P) % kU]);
#pragma unroll
              for (int t = 0; t < P; ++t)
                acc = __fadd_rn(acc, __fmul_rn(tr[t], __fadd_rn(xw[m][(u + t) % kU],
                                                               xw[m][(u + 2 * P - t) % kU])));
              o[m] = acc;
            }
          } else {
            const float* rc = xring + i * kCols;  // xring[slot * wp + column - bc0]
            const int s0 = jb % K;  // slot of X row jb (row jb - p of B's window)
            const int sc = s0 + p < K ? s0 + p : s0 + p - K;
#pragma unroll
            for (int m = 0; m < kCols; ++m) {
              float acc = __fmul_rn(tp[p], rc[sc * wp + m]);
              int sa = s0, sb = s0 + 2 * p < K ? s0 + 2 * p : s0 + 2 * p - K;
              for (int t = 0; t < p; ++t) {
                acc = __fadd_rn(acc, __fmul_rn(tp[t], __fadd_rn(rc[sa * wp + m], rc[sb * wp + m])));
                sa = sa + 1 == K ? 0 : sa + 1;
                sb = sb == 0 ? K - 1 : sb - 1;
              }
              o[m] = acc;
            }
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
          if constexpr (P >= 0) {
            float v[kCols + 2 * P];
            static_assert(kCols % 4 == 0 && P % 2 == 0, "X pass loads float4 / float2 words");
#pragma unroll
            for (int k = 0; k + 4 <= kCols + 2 * P; k += 4) {
              const float4 q = *reinterpret_cast<const float4*>(L + k);
              v[k] = q.x;
              v[k + 1] = q.y;
              v[k + 2] = q.z;
              v[k + 3] = q.w;
            }
            if constexpr ((kCols + 2 * P) % 4 != 0) {
              const float2 q = *reinterpret_cast<const float2*>(L + kCols + 2 * P - 2);
              v[kCols + 2 * P - 2] = q.x;
              v[kCols + 2 * P - 1] = q.y;
            }
#pragma unroll
            for (int m = 0; m < kCols; ++m) {
              float acc = __fmul_rn(tr[P], v[m + P]);
#pragma unroll
              for (int t = 0; t < P; ++t)
                acc = __fadd_rn(acc, __fmul_rn(tr[t], __fadd_rn(v[m + t], v[m + 2 * P - t])));
              xw[m][u] = acc;
            }
          } else {
            float* rc = xring + (r % K) * wp + i * kCols;
#pragma unroll
            for (int m = 0; m < kCols; ++m) {
              float acc = __fmul_rn(tp[p], L[m + p]);
              for (int t = 0; t < p; ++t)
                acc = __fadd_rn(acc, __fmul_rn(tp[t], __fadd_rn(L[m + t], L[m + 2 * p - t])));
              rc[m] = acc;
            }
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
          const int q = clampi((int)__fadd_rn(v, 0.5f), 0, 255);  // floor(v + 0.5), v >= -0.5
          ob_row[3 * xo] = ob_row[3 * xo + 1] = ob_row[3 * xo + 2] = (uint8_t)q;
        }
      }
      __syncthreads();
      for (int j = 0; j < nr; ++j) {  // out: whole 16-byte words, bytes at the ends
        uint8_t* dst = a.out + (((size_t)un.img * h + un.y0 + wd.ya + j) * w + un.x0) * 3;
        const uintptr_t b0 = reinterpret_cast<uintptr_t>(dst), a0 = b0 & ~(uintptr_t)15;
        const uintptr_t b1 = b0 + 3 * (size_t)nx;
        const uint8_t* src = ob + j * a.slot;
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
      __syncthreads();
      ya = wd.yb;
    } while (!multi && ya < un.rows);
  }
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
