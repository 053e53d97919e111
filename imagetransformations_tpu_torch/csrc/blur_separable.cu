// cv2 GaussianBlur on NHWC u8 batches: u8 in, u8 out, any h, w and channel
// count, with one tap row for the batch or one an image, in cv2's own 8U
// integer arithmetic.
//
// Replaces: imagetransformations_tpu/ops/pallas/blur.py:36 `_blur_kernel`,
// the body of blur_separable (launched at :126) and blur_to_sheared_rows
// (:175). It also carries apply_all's per-image blur, which the JAX package
// leaves to XLA (ops/stencil.py `_blur_batched`). The JAX kernel computes
// the blur in f32 and differs from cv2 by 1 LSB on a few percent of values;
// this kernel computes cv2's fixed-point rule, which equals
// cv2.GaussianBlur bit for bit (plain versions: ops/stencil.py
// gaussian_blur_plain and blur_batched_plain), per channel:
//   taps: int32 with 8 fraction bits summing to 256 (stencil.cv2_taps_q8:
//         cv2's f64 Gaussian rounded by error diffusion)
//   vertical pass   v[y] = sum_t in[reflect(y + t - p)] * taps[t]   (<= 65280)
//   horizontal pass o[x] = sum_t v[reflect(x + t - p)] * taps[t]    (< 2^24)
//   out = (o + 2^15) >> 16                                          (<= 255)
// Integer sums are exact, so their order and the order of the passes do
// not matter. The border is reflect-101 (numpy "reflect"), reflected again
// as often as p needs, so images narrower than the window blur too.
//
// Tap rows. Image i reads the row at taps + i * tap_stride (stride 0: one
// row for the batch) of tap_width values. A row may carry zeros at both
// ends (the per-image rows are zero-padded to 31 around a centred window,
// and cv2's outer taps may round to 0 at large radii): the kernel finds
// image i's first nonzero tap q and sums only the K_i = tap_width - 2q taps
// between, which gives the same sums (a zero tap adds 0), and the window
// shifted by q leaves every reflect-101 index the same. Nothing is read
// back to the host.
//
// Bound on the H100: the function reads n*h*w*c u8 and writes as many:
// ~15 us at 32x512x512x3 over 3.35 TB/s. Its arithmetic, 2K multiply-adds
// a value and the shift, is ~14 us at K = 9 at the f32 FMA rate (every
// partial sum is an integer below 2^24, so an FMA could carry it); an
// integer multiply-add (IMAD) issues at half that rate. The design spends
// little beyond those 2K and halves the vertical pass's IMADs:
// - Vertical pass: a register sliding window. A block owns a tile of tw
//   output values (x * c + channel) and a strip of rows of one image; each
//   thread owns two adjacent staged columns of the tile and its 2pc halo
//   values, packs their bytes of a row into the two 16-bit lanes of a word
//   (a lane's sum is at most 255 * 256 < 2^16, so one IMAD a tap sums both
//   columns), and walks down the strip, keeping the last K packed rows in
//   registers. Each input byte is loaded once per strip (the K-row body is
//   unrolled so the window rotates by renaming, not by moves). Row offsets,
//   reflected, come from a table in shared memory made once a block, so
//   the body has no branch and its loads run ahead of the sums. The block
//   has one thread a staged pair rounded up to a warp, so no warp runs a
//   second pass while the others wait at the barrier.
// - The vertical sums of a chunk of R rows (R a multiple of K, at least 16)
//   go to a shared u16 buffer, a word a pair; one barrier; the horizontal
//   pass gives each thread M = 5 consecutive pixels of one channel, u32
//   sums, streaming the M + K - 1 values they need once from shared memory
//   (M is odd so the lanes' strides of 5c values spread over the banks).
//   Bytes are rounded by an add and a shift, and staged in shared memory.
// - One more barrier, and the chunk's rows leave as 16-byte words when the
//   row, the tile and its start are multiples of 16 bytes (bytes otherwise).
// - The body is a template on K (odd, 1..31). A call with one tap row
//   launches the instance of its K alone (its registers are what that K
//   needs); a call with per-image rows launches the kernel that switches,
//   block-uniformly, over every K up to 31. K above 31 (radius > 5), or a
//   halo too wide for one thread a pair, takes a runtime-K body that reads
//   the vertical taps from device memory (L1) column by column, in u32.
// - Small images: a tile spans min(w*c, ~512 - 2pc) values, so a 32x32x3
//   image is one block of 64 threads (K = 9) that walks all its rows.
// Shared memory: R * stride * 2 + R * tw bytes and the row table, <= 45 KB
// for 31 taps; grid z strides over the images beyond 65535.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md; tools/time_blur.py):
// the first design (a u8 tile in shared memory, one conversion a tap, 128
// threads over 128 + 2pc staged columns, f32) took 0.337 / 0.933 ms at
// 32x512x512x3, r 1.5 / 5, and 0.194 ms at 4096x32x32x3, r 1.5; this
// design in f32 0.128 / 0.240 and 0.051 ms, and 0.22 ms with the blur
// grid's radii one an image; in integers, one column a thread, 0.152 /
// 0.187 and 0.045 ms, 0.174 with the grid's radii; with the 16-bit lanes
// 0.090 / 0.140 and 0.035 ms, 0.121 with the grid's radii (0.206 at
// 4096x32x32x3, against 0.193 one column a thread: half the threads a
// block hide less latency on 32x32 images).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxWindow = 31;   // largest K with a templated body
constexpr int kGroup = 5;        // horizontal outputs a thread (M)
constexpr int kAnyRows = 8;      // rows a chunk of the runtime-K body
constexpr int kMaxGridZ = 65535; // grid.z cap: blocks stride over the images
constexpr int kAnyThreads = 256; // runtime-K body's block when a pair a thread does not fit
// Launch shape: staged columns a block aims at (the tile width follows from
// it and the halo; a thread stages two) and output rows a block walks. 256
// or 1024 columns, or 32 or 128 rows, moved the times of r 1.5 and 5 and of
// 4096x32x32 by -8% to +12%, with no shape best for all (tools/time_blur.py
// on the H100, one column a thread).
constexpr int kTargetSpan = 512;
constexpr int kStripRows = 64;
constexpr size_t kSmemMax = 227 * 1024;  // the H100's per-block maximum

// rows of a chunk of the K body: a multiple of K, at least 16
__host__ __device__ constexpr int chunk_rows(int k) { return k * ((15 + k) / k); }

// numpy mode="reflect" (cv2 BORDER_REFLECT_101) source index of position i
// of a size-n axis, for any i: reflects again as often as needed.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i >= n ? period - i : i;
}

// reflect101 for a row index: one reflection by selects, the loop of
// reflect101 only for images shorter than the window
__device__ __forceinline__ int row_of(int y, int h) {
  int r = y < 0 ? -y : (y >= h ? 2 * h - 2 - y : y);
  if ((unsigned)r >= (unsigned)h) r = reflect101(y, h);
  return r;
}

// the byte of a 16-fraction-bit sum (< 2^24): cv2's (v + 2^15) >> 16
__device__ __forceinline__ uint8_t to_u8(uint32_t v) { return (uint8_t)((v + 0x8000u) >> 16); }

// u / d by a multiply, exact for u * d < 2^32: m = ceil(2^32 / d) (m = 0
// stands for d = 1)
struct FastDiv {
  uint32_t m;
  __device__ __forceinline__ uint32_t div(uint32_t u) const { return m ? __umulhi(u, m) : u; }
};

__host__ __device__ __forceinline__ FastDiv make_div(uint32_t d) {
  return {d == 1 ? 0u : (uint32_t)(((1ull << 32) + d - 1) / d)};
}

// Shared memory, in 16-byte-aligned parts: the vertical sums [rmax][stride]
// (u16 for the K bodies, with the horizontal pass's over-read of a group
// past the last row; u32 for a launch of the runtime-K body alone, whose
// kAnyRows rows of u32 also fit the K bodies' >= 16 rows of u16), the
// output bytes [rmax][tw], and the row table [tsize] int.
__host__ __device__ __forceinline__ size_t out_offset(int rmax, int stride, int c, bool wide) {
  const size_t bytes = ((size_t)rmax * stride + (kGroup - 1) * c) * (wide ? 4 : 2);
  return (bytes + 15) / 16 * 4;  // words
}

__host__ __device__ __forceinline__ size_t table_offset(int rmax, int stride, int c, int tw,
                                                        bool wide) {
  return out_offset(rmax, stride, c, wide) + ((size_t)rmax * tw + 15) / 16 * 4;  // words
}

struct Args {
  const uint8_t* x;
  uint8_t* out;
  const int32_t* taps;
  int tap_stride, tap_width;  // image i's taps: taps[i * tap_stride + 0..tap_width)
  int n, h, w, c;
  int tw;          // values a tile spans (a multiple of c; the last tile may be ragged)
  int strip;       // output rows a block walks
  int stride;      // words a row of the vertical-sum buffer holds (>= every span)
  int rmax;        // rows of the vertical-sum and output buffers
  bool wide;       // u32 vertical sums: a launch of the runtime-K body alone
  int tsize;       // entries of the row table: input rows y0 - pmax .. of a strip
  FastDiv div_c;
};

// Per block: the tile, its strip and the image, after the tap trim.
struct Tile {
  const uint8_t* src;  // image
  uint8_t* dst;
  const int32_t* taps;  // K taps, the outer two nonzero
  int v0, tw, y0, rows;
};

__device__ __forceinline__ uint8_t* out_buf(const Args& a, uint32_t* smem) {
  return reinterpret_cast<uint8_t*>(smem + out_offset(a.rmax, a.stride, a.c, a.wide));
}

// rowoff[i]: offset in the image of input row y0 - pmax + i, reflected
__device__ __forceinline__ int* row_table(const Args& a, uint32_t* smem) {
  return reinterpret_cast<int*>(smem + table_offset(a.rmax, a.stride, a.c, a.tw, a.wide));
}

// Source offset within a row of staged column j (value v0 + j - halo).
__device__ __forceinline__ int column_source(const Args& a, int v0, int j, int halo) {
  const int v = v0 + j - halo;
  const int px = v >= 0 ? (int)a.div_c.div(v) : -(int)a.div_c.div(-v + a.c - 1);
  return reflect101(px, a.w) * a.c + (v - px * a.c);
}

// Rows r0 .. r0 + nr of the tile from the output buffer to the image.
__device__ __forceinline__ void store_rows(const Args& a, const Tile& t, const uint8_t* obuf,
                                           int r0, int nr) {
  const int wc = a.w * a.c;
  uint8_t* dst = t.dst + (size_t)(t.y0 + r0) * wc + t.v0;
  if (((wc | t.v0 | t.tw | a.tw) & 15) == 0) {
    const int words = t.tw >> 4;
    for (int i = threadIdx.x; i < nr * words; i += blockDim.x) {
      const int r = i / words, k = i - r * words;
      *reinterpret_cast<uint4*>(dst + (size_t)r * wc + 16 * k) =
          *reinterpret_cast<const uint4*>(obuf + r * a.tw + 16 * k);
    }
  } else {
    for (int i = threadIdx.x; i < nr * t.tw; i += blockDim.x) {
      const int r = i / t.tw, v = i - r * t.tw;
      dst[(size_t)r * wc + v] = obuf[r * a.tw + v];
    }
  }
}

// two bytes as the 16-bit lanes of a word: b0 in bits 0..7, b1 in 16..23
__device__ __forceinline__ uint32_t pack2(uint32_t b0, uint32_t b1) {
  return __byte_perm(b0, b1, 0x5410);
}

template <int K>
__device__ __forceinline__ void blur_tile(const Args& a, const Tile& t, uint32_t* smem) {
  constexpr int P = K / 2;
  constexpr int R = chunk_rows(K);
  const int c = a.c;
  const int halo = P * c;
  const int span = t.tw + 2 * halo;
  const int j = threadIdx.x;  // staged columns 2j and 2j + 1
  uint8_t* obuf = out_buf(a, smem);
  // input row y0 - P + i of the strip at rows[i]
  const int* rows = row_table(a, smem) + (a.tap_width - 1) / 2 - P;
  uint32_t tp[K];
#pragma unroll
  for (int i = 0; i < K; ++i) tp[i] = (uint32_t)__ldg(t.taps + i);

  // Threads whose pair starts past the span (in the last warp) load column
  // 0 and store nothing, so the vertical body has no branch and its loads
  // run ahead; a pair's second column past the span loads its first.
  const bool active = 2 * j < span;
  const uint8_t* s0 = t.src + (active ? column_source(a, t.v0, 2 * j, halo) : 0);
  const uint8_t* s1 = t.src + (2 * j + 1 < span ? column_source(a, t.v0, 2 * j + 1, halo)
                                                : s0 - t.src);
  // the window: slot i % K holds input row y0 - P + i of the pair, a byte
  // in each 16-bit lane; a lane's sum is at most 255 * 256, so the two
  // columns' vertical sums share one multiply-add a tap
  uint32_t win[K];
#pragma unroll
  for (int i = 0; i < K - 1; ++i) win[i] = pack2(__ldg(s0 + rows[i]), __ldg(s1 + rows[i]));

  uint16_t* mid = reinterpret_cast<uint16_t*>(smem);  // the vertical sums
  const int npx = t.tw / c;
  const uint32_t gc = (npx + kGroup - 1) / kGroup * c;  // units a row: pixel groups x channels
  const FastDiv div_gc = make_div(gc);
  for (int r0 = 0; r0 < t.rows; r0 += R) {
    const int nr = min(R, t.rows - r0);
    // all R rows of the chunk (past the strip's end: reflected rows, whose
    // sums are not stored), the newest input of output row r at
    // rows[r0 + r + 2P]. (Leaving the last chunk early, K rows at a time,
    // cost K = 9 a quarter: 0.163 against 0.129 ms, the branch holding the
    // next rows' loads back.)
#pragma unroll
    for (int kb = 0; kb < R; kb += K) {
#pragma unroll
      for (int u = 0; u < K; ++u) {
        const int r = kb + u;
        const int off = rows[r0 + r + 2 * P];
        win[(u + K - 1) % K] = pack2(__ldg(s0 + off), __ldg(s1 + off));
        uint32_t acc = win[u % K] * tp[0];
#pragma unroll
        for (int i = 1; i < K; ++i) acc += win[(u + i) % K] * tp[i];
        // the low lane is column 2j, the high one 2j + 1
        if (active && r < nr) reinterpret_cast<uint32_t*>(mid + r * a.stride)[j] = acc;
      }
    }
    __syncthreads();
    // horizontal pass: unit (row, pixel group, channel), kGroup outputs each
    for (uint32_t unit = j; unit < nr * gc; unit += blockDim.x) {
      const uint32_t r = div_gc.div(unit);
      const uint32_t rem = unit - r * gc;
      const uint32_t g = a.div_c.div(rem);
      const int ch = rem - g * c;
      const int px0 = g * kGroup;
      const auto* m = mid + r * a.stride + px0 * c + ch;
      uint8_t* ob = obuf + r * a.tw + px0 * c + ch;
      uint32_t acc[kGroup];
#pragma unroll
      for (int q = 0; q < kGroup + K - 1; ++q) {
        const uint32_t val = m[q * c];
#pragma unroll
        for (int o = 0; o < kGroup; ++o) {
          const int i = q - o;
          if (i >= 0 && i < K) acc[o] = i == 0 ? val * tp[i] : acc[o] + val * tp[i];
        }
      }
#pragma unroll
      for (int o = 0; o < kGroup; ++o)
        if (px0 + o < npx) ob[o * c] = to_u8(acc[o]);
    }
    __syncthreads();
    store_rows(a, t, obuf, r0, nr);
  }
}

// Any K: each vertical sum reads its K bytes from device memory (L1).
__device__ void blur_tile_any(const Args& a, const Tile& t, int k, uint32_t* smem) {
  const int p = k / 2;
  const int c = a.c, h = a.h, wc = a.w * a.c;
  const int halo = p * c;
  const int span = t.tw + 2 * halo;
  uint32_t* mid = smem;
  uint8_t* obuf = out_buf(a, smem);
  for (int r0 = 0; r0 < t.rows; r0 += kAnyRows) {
    const int nr = min(kAnyRows, t.rows - r0);
    for (int j = threadIdx.x; j < span; j += blockDim.x) {
      const uint8_t* s = t.src + column_source(a, t.v0, j, halo);
      for (int r = 0; r < nr; ++r) {
        const int y = t.y0 + r0 + r - p;
        uint32_t acc = 0;
        for (int i = 0; i < k; ++i)
          acc += (uint32_t)__ldg(s + (size_t)row_of(y + i, h) * wc) * (uint32_t)t.taps[i];
        mid[r * a.stride + j] = acc;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nr * t.tw; i += blockDim.x) {
      const int r = i / t.tw, v = i - r * t.tw;
      const uint32_t* m = mid + r * a.stride + v;
      uint32_t acc = 0;
      for (int q = 0; q < k; ++q) acc += m[q * c] * (uint32_t)t.taps[q];
      obuf[r * a.tw + v] = to_u8(acc);
    }
    __syncthreads();
    store_rows(a, t, obuf, r0, nr);
  }
}

// KSET: K for a launch with one tap row of K taps (that K's body, and the
// runtime-K body should the row carry zeros); 0 for the runtime-K body
// alone; -1 to switch per image over every odd K <= 31 (the runtime-K body
// above).
template <int KSET>
__device__ __forceinline__ void blur_blocks(const Args& a) {
  extern __shared__ uint32_t smem[];
  const int wc = a.w * a.c;
  const int v0 = blockIdx.x * a.tw;
  const int y0 = blockIdx.y * a.strip;
  const int half = (a.tap_width - 1) / 2;
  int* rows = row_table(a, smem);
  for (int i = threadIdx.x; i < a.tsize; i += blockDim.x) rows[i] = row_of(y0 - half + i, a.h) * wc;
  __syncthreads();
  for (int img = blockIdx.z; img < a.n; img += gridDim.z) {
    const int32_t* row = a.taps + (size_t)img * a.tap_stride;
    // K: the row's centred window of nonzero taps, from its first nonzero
    // q. (A loop of loads: a block vote over the row took 0.164 ms against
    // 0.129 at r 1.5, 32x512x512x3, with the same body.)
    int q = 0;
    while (q < half && row[q] == 0) ++q;
    const int k = a.tap_width - 2 * q;
    const Tile t = {a.x + (size_t)img * a.h * wc, a.out + (size_t)img * a.h * wc, row + q,
                    v0, min(a.tw, wc - v0), y0, min(a.strip, a.h - y0)};
    if constexpr (KSET > 0) {
      if (k == KSET) blur_tile<KSET>(a, t, smem);
      else blur_tile_any(a, t, k, smem);
    } else if constexpr (KSET == 0) {
      blur_tile_any(a, t, k, smem);
    } else {
      switch (k) {
        case 1: blur_tile<1>(a, t, smem); break;
        case 3: blur_tile<3>(a, t, smem); break;
        case 5: blur_tile<5>(a, t, smem); break;
        case 7: blur_tile<7>(a, t, smem); break;
        case 9: blur_tile<9>(a, t, smem); break;
        case 11: blur_tile<11>(a, t, smem); break;
        case 13: blur_tile<13>(a, t, smem); break;
        case 15: blur_tile<15>(a, t, smem); break;
        case 17: blur_tile<17>(a, t, smem); break;
        case 19: blur_tile<19>(a, t, smem); break;
        case 21: blur_tile<21>(a, t, smem); break;
        case 23: blur_tile<23>(a, t, smem); break;
        case 25: blur_tile<25>(a, t, smem); break;
        case 27: blur_tile<27>(a, t, smem); break;
        case 29: blur_tile<29>(a, t, smem); break;
        case 31: blur_tile<31>(a, t, smem); break;
        default: blur_tile_any(a, t, k, smem); break;
      }
    }
  }
}

template <int KSET>
__global__ void blur_separable_kernel(const Args a) {
  blur_blocks<KSET>(a);
}

// The same, held to 64 registers (two blocks of 512 threads an SM), for
// K >= 17 and the switch: at K = 31 that took 0.24 ms against 0.34 with the
// 95 registers the body takes on its own, and the switch 0.21 against 0.44
// with 160 (32x512x512x3; tools/time_blur.py). K <= 15 runs faster
// unbounded (0.129 against 0.175 ms at K = 9).
template <int KSET>
__global__ void __launch_bounds__(512, 2) blur_separable_kernel_capped(const Args a) {
  blur_blocks<KSET>(a);
}

using KernelFn = void (*)(const Args);

KernelFn kernel_for(int kset) {
  switch (kset) {
    case -1: return blur_separable_kernel_capped<-1>;
    case 1: return blur_separable_kernel<1>;
    case 3: return blur_separable_kernel<3>;
    case 5: return blur_separable_kernel<5>;
    case 7: return blur_separable_kernel<7>;
    case 9: return blur_separable_kernel<9>;
    case 11: return blur_separable_kernel<11>;
    case 13: return blur_separable_kernel<13>;
    case 15: return blur_separable_kernel<15>;
    case 17: return blur_separable_kernel_capped<17>;
    case 19: return blur_separable_kernel_capped<19>;
    case 21: return blur_separable_kernel_capped<21>;
    case 23: return blur_separable_kernel_capped<23>;
    case 25: return blur_separable_kernel_capped<25>;
    case 27: return blur_separable_kernel_capped<27>;
    case 29: return blur_separable_kernel_capped<29>;
    case 31: return blur_separable_kernel_capped<31>;
    default: return blur_separable_kernel<0>;
  }
}

int gcd(int a, int b) { return b ? gcd(b, a % b) : a; }

}  // namespace

// x: u8 [n, h, w, c]; out: u8 [n, h, w, c]; taps: int32 rows of tap_width
// (odd) values, image i's at taps + i * tap_stride (0: one row for the
// batch), each a centred window of taps in [0, 256] with 8 fraction bits
// summing to 256, zero-padded alike at both ends. Launches on `stream`;
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue when
// the shape does not fit a launch (shared memory, grid).
extern "C" int blur_separable(const void* x, void* out, const void* taps, int tap_stride,
                              int tap_width, int n, int h, int w, int c, void* stream) {
  if (tap_width < 1 || tap_width % 2 == 0 || c < 1) return cudaErrorInvalidValue;
  const int pmax = (tap_width - 1) / 2;
  const int wc = w * c;
  const int halo2 = 2 * pmax * c;
  const int align = 16 / gcd(16, c) * c;  // lcm(16, c): tiles start on pixels and 16 bytes
  // one tap row with K <= 31: that K's instance; per-image rows: the switch;
  // the runtime-K body for wider windows, or when one thread a staged
  // pair does not fit the kernel's registers
  int kset = tap_width > kMaxWindow ? 0 : tap_stride == 0 ? tap_width : -1;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel_for(kset));
  if (err != cudaSuccess) return err;
  const int max_threads = attr.maxThreadsPerBlock / 32 * 32;
  const int target_span = kTargetSpan < 2 * max_threads ? kTargetSpan : 2 * max_threads;
  int tw = (target_span - halo2) / align * align;
  if (tw < align) tw = align;
  const int tiles = (wc + tw - 1) / tw;
  tw = ((wc + tiles - 1) / tiles + align - 1) / align * align;
  int threads = ((tw + halo2 + 1) / 2 + 31) / 32 * 32;  // two staged columns a thread
  if (threads > max_threads) {
    kset = 0;
    threads = kAnyThreads;
  }
  int rmax = kAnyRows;
  if (kset != 0)
    for (int k = 1; k <= tap_width; k += 2)
      if (kset < 0 || k == kset) rmax = rmax > chunk_rows(k) ? rmax : chunk_rows(k);
  const int strip = kset > 0 ? (kStripRows + rmax - 1) / rmax * rmax  // whole chunks
                             : kStripRows;
  Args a = {static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out),
            static_cast<const int32_t*>(taps), tap_stride, tap_width, n, h, w, c, tw, strip,
            2 * threads > tw + halo2 ? 2 * threads : tw + halo2, rmax, kset == 0,
            strip + rmax + 2 * pmax, make_div(c)};
  const size_t smem = sizeof(uint32_t) * table_offset(rmax, a.stride, c, tw, a.wide)
                      + sizeof(int) * (size_t)a.tsize;
  // FastDiv's domain: every value index (with its halo) times c below 2^32;
  // row offsets in int
  if (smem > kSmemMax || (size_t)(wc + halo2) * c >= (1ull << 32)
      || (size_t)h * wc >= (1ull << 31) || (size_t)n * h * wc == 0)
    return cudaErrorInvalidValue;
  const KernelFn fn = kernel_for(kset);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((wc + tw - 1) / tw, (h + strip - 1) / strip, n < kMaxGridZ ? n : kMaxGridZ);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  fn<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}
