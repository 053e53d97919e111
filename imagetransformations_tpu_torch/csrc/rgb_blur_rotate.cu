// Per-channel blur -> 3-shear rotation (-> PIL grayscale), NHWC u8 in and
// out, any channel count (grayscale needs 3). One launch a call.
//
// Replaces two Pallas kernels of imagetransformations_tpu/ops/pallas/
// megakernel.py: :192 _mega_kernel (one angle for the batch) and :920
// _mega_traced_kernel (one angle an image: the shifts come per image,
// stride h / w, and so does the identity flag, stride 1). Modes:
//   stream=True : f32 throughout, one final quantization: trunc after a
//                 rotation, rint for an identity image, PIL L24 floor with
//                 grayscale (oracle: oracle/fast_warp.fused_stream_chain);
//   stream=False: the reference's per-op u8 semantics: rint after the blur,
//                 trunc after every shear, then PIL L24 grayscale
//                 (oracle: gaussian_blur -> fast_warp.rotate_3shear ->
//                 grayscale_rgb);
//   identity    : an image at angle 0 skips its shears and takes rint. The
//                 traced Pallas kernel shears it anyway; a shear at angle 0
//                 (k = 0, f = 0) is exact, v + 0*(nbr - v) == v, so the bits
//                 are the same.
// The plain version is megakernel.rgb_blur_rotate_plain: the blur runs the
// Y pass, then the X pass, per channel, reflect-101 at the image border,
// taps centre first and then the mirrored pairs t = 0..p-1; then
//   S1[y,x] = lerp(B [y, x+k1[y]],  B [y, x+k1[y]+1],  f1[y])
//   S2[y,x] = lerp(S1[y+k2[x], x],  S1[y+k2[x]+1, x],  f2[x])
//   S3[y,x] = lerp(S2[y, x+k1[y]],  S2[y, x+k1[y]+1],  f1[y])
// with lerp(a, b, f) = a + f*(b - a) and `fill` for any index off the
// h x w canvas at that pass. Every add and multiply below is rounded on its
// own (_rn intrinsics, and the build passes -fmad=false): 0 LSB against the
// plain version.
//
// Bound on the H100: the function must read n*h*w*c u8 and write as many,
// 2*n*h*w*c bytes: ~15 us at 32x512x512x3 over 3.35 TB/s. Its arithmetic
// (chip_smoke.py's ops_rgb: a conversion, two blur passes of 1 + 3p
// operations, rint, three lerps and truncs, the quantization, a value)
// issues at most 33.5e12 unfused operations a second: ~33 us at
// 32x512x512x3 with p = 4, ~8 us at p = 0. So operations bound the blurred
// call by about 2x, bytes the call at radius 0.
//
// Design against that bound. The Pallas kernel keeps a whole image in VMEM
// from the blur to the last shear; a 512x512 f32 plane is 1 MB, and a block
// here has 227 KB of shared memory. So a block takes one output tile of
// one image (ty rows x tx columns, all channels; grid x the tiles, grid y
// the images, blocks looping past 65535 images), stages in shared memory
// the part of the source that the tile needs, and runs the blur and the
// three shears there. Nothing but the u8 source and the u8 output crosses
// device memory: no f32 scratch, one launch.
// - Footprint. For tile rows [y0, y1] and columns [x0, x1] (cut to the
//   canvas):
//     pass 3 reads S2 columns C2 = [x0 + min k1[y0..y1], x1 + max k1 + 1],
//     pass 2 reads S1 rows    R1 = [y0 + min k2[C2], y1 + max k2[C2] + 1],
//     pass 1 reads B columns  C1 = [min C2 + min k1[R1], max C2 + max k1[R1] + 1],
//   each clamped to [-1, w] or [-1, h]: what lies off the canvas reads fill,
//   so a buffer holds fill at -1 and w (or h) and every read index is
//   clamped there, with no test a tap. Only C2 and R1 on the canvas are
//   computed; the blur reads source rows R1 +- p and columns C1 +- p,
//   reflect-101 at the image border. A warp takes the minima and maxima
//   from an image's shift tables (shuffle reductions), so any table is
//   right, not only a monotone Paeth one; a block takes the footprints of
//   a batch of up to 8 images at once, a warp each, so their global
//   latencies overlap. R1 is cut into chunks of chunk_rows rows,
//   each with its own C1: pass 1 of a row needs only its own columns, so a
//   one-row chunk stays |C2| + 1 wide even near 180 degrees, where k1
//   changes by up to w + 1 a row. One chunk is the rule; the host takes
//   more only where one does not fit.
// - Stage. A chunk's source window, all channels interleaved as in memory
//   (rows reflected, then columns off the canvas reflected, or fill at
//   p = 0), arrives as aligned 16-byte words by cp.async; byte copies only
//   for words that straddle a row's ends, and for rows aligned unlike the
//   chunk's first (a row of w*c bytes not a multiple of 16).
// - Channels go through each phase together, so a phase's index arithmetic
//   serves all c values of a pixel (B, S1 and S2 keep them interleaved, as
//   the stage does) and a tile takes a dozen barriers: per channel the Y
//   pass (stage -> mid, u8 read as (2^23 | b) - 2^23) and the X pass (mid
//   -> B) [rint if strict]; then for all channels pass 1 (B or, at p = 0,
//   the stage itself -> S1), pass 2 (-> S2, over B's space; a warp down a
//   column, so its reads of S1 at the row offset k2[x] stride an odd pitch:
//   no bank conflicts) and pass 3 (-> the output tile). Each pass takes __restrict__ pointers, so a pixel's loads
//   of all channels issue ahead of the stores before them, and flat loops
//   split their index by a multiply-high. With p a template constant (0
//   and 4: apply_all's rotation and the default chain's r 1.5) the Y pass
//   keeps a register window of 8 + 2p rows and the X pass reads 16-byte
//   words, the taps in registers; c = 3 is a constant too; other radii and
//   channel counts take the generic body. 80 registers a thread (64 at
//   p = 0): three blocks an SM (four) where the layout allows; the output
//   tile shares S1's space, dead by pass 3.
// - Quantization: trunc / rint / clip through the add of 2^23 in the
//   rounding mode wanted, no conversion instruction; grayscale forms L24
//   from the pixel's three values in pass 3.
// - Store: the tile's rows leave as aligned 16-byte words of interleaved
//   NHWC bytes (byte stores only at a row's ragged ends).
// - Identity images (a flag an image, a block-uniform branch) stage only
//   the tile plus the blur halo and quantize B.
// The host (megakernel._tiling) sizes the layout from a bound on the shift
// slopes, |k1| and |k2| spreads of at most |tan(a/2)| and |sin(a)| a pixel
// (+1 for the device's f32 tan and sin), with no read from the device; it
// picks the tile and chunk sizes that fit and cost least. The kernel checks
// each footprint against the layout it was given and traps if it does not
// fit.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// registers for three blocks an SM (80 a thread), four at p = 0 (64)
template <int P>
constexpr int kMinBlocks = P == 0 ? 4 : 3;
constexpr int kWarps = kThreads / 32;
constexpr int kYRows = 8;         // Y-pass outputs a thread computes down a column
constexpr int kMaxGridY = 65535;  // grid y cap: blocks stride over the images
constexpr int kMeta = 5;          // footprint header ints before the chunk table
constexpr int kMaxBatch = 8;      // images whose footprints a block takes at once (a warp each)
constexpr float kTwo23 = 8388608.0f;

__host__ __device__ inline int round_up(int v, int m) { return (v + m - 1) / m * m; }
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__device__ __forceinline__ int clampi(int v, int lo, int hi) { return imin(imax(v, lo), hi); }

// Shared-memory layout of one block; megakernel._smem_bytes mirrors it.
struct Layout {
  int p, c, ty_log2, tx_log2, rc, max_r1, max_c2, max_c1, max_chunks;
  int sp;   // stage row pitch, bytes
  int fp;   // mid row pitch, floats (a multiple of 4)
  int bp;   // B row pitch, floats: channels interleaved, as in S1 and S2
  int s1p;  // S1 row pitch, floats (odd)
  int s2p;  // S2 row pitch, floats (odd)
  int op;   // output tile row pitch, bytes
  int o_stage, o_out, o_b, o_mid, o_s1, o_taps, o_meta, total;  // byte offsets
};

__host__ __device__ inline Layout make_layout(int p, int c, int ty_log2, int tx_log2, int rc,
                                              int max_r1, int max_c2, int max_c1) {
  Layout L;
  L.p = p;
  L.c = c;
  L.ty_log2 = ty_log2;
  L.tx_log2 = tx_log2;
  L.rc = rc;
  L.max_r1 = max_r1;
  L.max_c2 = max_c2;
  L.max_c1 = max_c1;
  L.max_chunks = (max_r1 + rc - 1) / rc;
  L.sp = round_up(46 + (max_c1 + 2 * p) * c, 16);
  L.fp = round_up(max_c1 + 2 * p, 4);
  L.bp = max_c1 * c;
  L.s1p = (max_c2 * c) | 1;
  L.s2p = (max_c2 * c) | 1;
  L.op = round_up(46 + (1 << tx_log2) * c, 16);
  const int ty = 1 << ty_log2;
  int off = 0;
  L.o_stage = off;
  off += round_up((rc + 2 * p) * L.sp, 16);
  L.o_b = off;  // B [rc][bp] (p > 0), then S2 [ty][s2p]
  off += round_up(4 * imax(p > 0 ? rc * L.bp : 0, ty * L.s2p), 16);
  L.o_mid = off;  // one channel's Y pass [rc][fp], 8 floats of slack for 16-byte reads
  off += p > 0 ? round_up(4 * (rc * L.fp + 8), 16) : 0;
  L.o_s1 = off;  // S1 [max_r1][s1p]; after pass 2 (or for an identity image) the output tile
  L.o_out = off;
  off += round_up(imax(4 * max_r1 * L.s1p, ty * L.op), 16);
  L.o_taps = off;
  off += round_up(4 * (2 * p + 1), 16);
  L.o_meta = off;  // a footprint an image of the batch
  off += round_up(4 * kMaxBatch * (kMeta + 2 * L.max_chunks), 16);
  L.total = off;
  return L;
}

// cv2 BORDER_REFLECT_101; exact for i in [-(n-1), 2n-2], which the host
// guarantees (p <= n - 1); clamped beyond, so no read leaves the image.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return clampi(i, 0, n - 1);
}

__device__ __forceinline__ float lerp_rn(float a, float b, float f) {
  return __fadd_rn(a, __fmul_rn(f, __fsub_rn(b, a)));
}

// u8 -> f32 as (2^23 | b) - 2^23: exact, no conversion instruction.
__device__ __forceinline__ float u8f(uint32_t b) {
  return __fsub_rn(__uint_as_float(0x4B000000u | b), kTwo23);
}

// trunc of a pass value in strict mode: v lies in [0, 255] (a lerp of two
// values in [0, 255]), so trunc is floor, the add of 2^23 rounding down.
__device__ __forceinline__ float floor_u8(float v) {
  return __fsub_rn(__fadd_rd(v, kTwo23), kTwo23);
}

// rint (half to even) of 0 <= v < 2^22.
__device__ __forceinline__ float rint_pos(float v) {
  return __fsub_rn(__fadd_rn(v, kTwo23), kTwo23);
}

// The u8 of clip(trunc(v)) and of clip(rint(v)) for v >= 0: the low byte
// of 2^23 + q.
__device__ __forceinline__ uint8_t trunc_byte(float v) {
  return (uint8_t)__float_as_uint(fminf(__fadd_rd(fmaxf(v, 0.0f), kTwo23), kTwo23 + 255.0f));
}
__device__ __forceinline__ uint8_t rint_byte(float v) {
  return (uint8_t)__float_as_uint(fminf(__fadd_rn(fmaxf(v, 0.0f), kTwo23), kTwo23 + 255.0f));
}

// PIL convert('L'): L24 fixed point on f32 values, floored by the int cast.
__device__ __forceinline__ uint8_t l24(float r, float g, float b) {
  const float sum3 = __fadd_rn(__fadd_rn(__fmul_rn(g, 38470.0f), __fmul_rn(r, 19595.0f)),
                               __fmul_rn(b, 7471.0f));
  int q = (int)__fadd_rn(__fmul_rn(sum3, 1.0f / 65536.0f), 0.5f);
  q = q < 0 ? 0 : (q > 255 ? 255 : q);
  return (uint8_t)q;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// n / d for the flat loops of a phase: a multiply-high by ceil(2^32 / d),
// exact while n * d < 2^32 (checked once a phase) and d > 1; else a
// division.
struct Div {
  unsigned d, m;
  bool fast;
  __device__ Div(int d_, int n_max) : d((unsigned)d_) {
    m = (unsigned)((0x100000000ull + d - 1) / d);
    fast = d > 1 && (unsigned long long)n_max * d < 0x100000000ull;
  }
  __device__ __forceinline__ int operator()(int n) const {
    return fast ? (int)__umulhi((unsigned)n, m) : (int)((unsigned)n / d);
  }
};

// min and max over the lanes of a warp.
__device__ __forceinline__ void warp_minmax(int& lo, int& hi) {
  for (int o = 16; o > 0; o >>= 1) {
    lo = imin(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = imax(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
}

// One warp: an image's footprint of the tile into meta (see the header):
// C2 and R1 with their fill positions (-1, w / -1, h), the chunks of R1 on
// the canvas and each chunk's B columns C1 (with -1, w). Traps when a
// footprint exceeds the layout.
__device__ void footprint(const int* k1, const int* k2, int y0, int y1, int x0, int x1, int h,
                          int w, bool ident, const Layout& L, int* meta) {
  const int lane = threadIdx.x & 31;
  int c2lo = 0, c2hi = -1, r1lo, r1hi;
  if (ident) {
    r1lo = y0;
    r1hi = y1;
  } else {
    int lo = INT_MAX, hi = INT_MIN;
    for (int y = y0 + lane; y <= y1; y += 32) {
      lo = imin(lo, k1[y]);
      hi = imax(hi, k1[y]);
    }
    warp_minmax(lo, hi);
    c2lo = clampi(x0 + lo, -1, w);
    c2hi = clampi(x1 + hi + 1, -1, w);  // x1 + max k1 + 1
    const int cl = imax(c2lo, 0), ch = imin(c2hi, w - 1);
    lo = INT_MAX;
    hi = INT_MIN;
    for (int x = cl + lane; x <= ch; x += 32) {
      lo = imin(lo, k2[x]);
      hi = imax(hi, k2[x]);
    }
    warp_minmax(lo, hi);
    if (cl <= ch) {
      r1lo = clampi(y0 + lo, -1, h);
      r1hi = clampi(y1 + hi + 1, -1, h);  // y1 + max k2 + 1
    } else {
      r1lo = 0;
      r1hi = -1;
    }
  }
  const int ra0 = imax(r1lo, 0), rb0 = imin(r1hi, h - 1);
  const int nch = rb0 >= ra0 ? (rb0 - ra0 + L.rc) / L.rc : 0;
  bool bad = c2hi - c2lo + 1 > L.max_c2 || r1hi - r1lo + 1 > L.max_r1 || nch > L.max_chunks;
  const int cl = imax(c2lo, 0), ch = imin(c2hi, w - 1);
  for (int q = 0; q < nch; ++q) {
    const int ra = ra0 + q * L.rc, rb = imin(ra + L.rc - 1, rb0);
    int lo, hi;
    if (ident) {
      lo = x0;
      hi = x1;
    } else {
      lo = INT_MAX;
      hi = INT_MIN;
      for (int r = ra + lane; r <= rb; r += 32) {
        lo = imin(lo, k1[r]);
        hi = imax(hi, k1[r]);
      }
      warp_minmax(lo, hi);
      if (cl <= ch) {
        lo = clampi(cl + lo, -1, w);
        hi = clampi(ch + hi + 1, -1, w);
      } else {
        lo = 0;
        hi = -1;
      }
    }
    bad = bad || hi - lo + 1 > L.max_c1;
    if (lane == 0 && !bad) {
      meta[kMeta + 2 * q] = lo;
      meta[kMeta + 2 * q + 1] = hi;
    }
  }
  if (bad) __trap();
  if (lane == 0) {
    meta[0] = c2lo;
    meta[1] = c2hi;
    meta[2] = r1lo;
    meta[3] = r1hi;
    meta[4] = nch;
  }
}

template <int P>
struct Taps {
  float t[P > 0 ? 2 * P + 1 : 1];
};

// The blur's Y pass of one channel: mid[i][j] = the taps over stage rows
// i..i+2p of staged column j, rows i < nr, columns j < ns; s8 is the
// channel's byte of staged column 0, row 0 (columns c bytes apart, rows sp).
// With P a constant a thread computes kYRows rows of a column from a
// register window. Taps centre first, then the mirrored pairs.
template <int P>
__device__ __forceinline__ void y_pass(const uint8_t* __restrict__ s8, float* __restrict__ mid,
                                       const Taps<P>& tp, const float* __restrict__ tps, int p,
                                       int c, int nr, int ns, int sp, int fp, const Div& div_ns) {
  const int rows = nr + 2 * p, groups = (nr + kYRows - 1) / kYRows;
  for (int it = threadIdx.x; it < groups * ns; it += kThreads) {
    const int g = div_ns(it), j = it - g * ns, i0 = g * kYRows;
    const uint8_t* s = s8 + j * c;
    if constexpr (P > 0) {
      float win[kYRows + 2 * P];
#pragma unroll
      for (int q = 0; q < kYRows + 2 * P; ++q) {
        win[q] = i0 + q < rows ? u8f(s[(i0 + q) * sp]) : 0.0f;
      }
#pragma unroll
      for (int v = 0; v < kYRows; ++v) {
        float acc = __fmul_rn(tp.t[P], win[v + P]);
#pragma unroll
        for (int t = 0; t < P; ++t) {
          acc = __fadd_rn(acc, __fmul_rn(tp.t[t], __fadd_rn(win[v + t], win[v + 2 * P - t])));
        }
        if (i0 + v < nr) mid[(i0 + v) * fp + j] = acc;
      }
    } else {
      for (int v = 0; v < kYRows && i0 + v < nr; ++v) {
        const uint8_t* sv = s + (i0 + v) * sp;
        float acc = __fmul_rn(tps[p], u8f(sv[p * sp]));
        for (int t = 0; t < p; ++t) {
          acc = __fadd_rn(acc,
                          __fmul_rn(tps[t], __fadd_rn(u8f(sv[t * sp]), u8f(sv[(2 * p - t) * sp]))));
        }
        mid[(i0 + v) * fp + j] = acc;
      }
    }
  }
}

// The blur's X pass of one channel: B[i][j * c] = the taps over mid
// columns j..j+2p of row i, rows i < nr (B rows bp apart), columns j < nc1
// [rint if strict]. A thread computes 4 columns; with P a constant, from
// 16-byte reads.
template <int P>
__device__ __forceinline__ void x_pass(const float* __restrict__ mid, float* __restrict__ b,
                                       const Taps<P>& tp, const float* __restrict__ tps, int p,
                                       int c, int nr, int nc1, int groups4, int fp, int bp,
                                       const Div& div_g4, bool strict) {
  for (int it = threadIdx.x; it < nr * groups4; it += kThreads) {
    const int i = div_g4(it), j0 = (it - i * groups4) * 4;
    const float* row = mid + i * fp + j0;
    float* brow = b + i * bp + j0 * c;
    if constexpr (P > 0) {
      constexpr int kWords = (4 + 2 * P + 3) / 4;
      float win[4 * kWords];
#pragma unroll
      for (int q = 0; q < kWords; ++q) {
        const float4 v = reinterpret_cast<const float4*>(row)[q];
        win[4 * q] = v.x;
        win[4 * q + 1] = v.y;
        win[4 * q + 2] = v.z;
        win[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float acc = __fmul_rn(tp.t[P], win[u + P]);
#pragma unroll
        for (int t = 0; t < P; ++t) {
          acc = __fadd_rn(acc, __fmul_rn(tp.t[t], __fadd_rn(win[u + t], win[u + 2 * P - t])));
        }
        if (j0 + u < nc1) brow[u * c] = strict ? rint_pos(acc) : acc;
      }
    } else {
      for (int u = 0; u < 4 && j0 + u < nc1; ++u) {
        const float* sv = row + u;
        float acc = __fmul_rn(tps[p], sv[p]);
        for (int t = 0; t < p; ++t) {
          acc = __fadd_rn(acc, __fmul_rn(tps[t], __fadd_rn(sv[t], sv[2 * p - t])));
        }
        brow[u * c] = strict ? rint_pos(acc) : acc;
      }
    }
  }
}

// The passes below take __restrict__ pointers to the shared regions they
// read and write (distinct, by the layout), so the compiler may issue a
// pixel's loads, of all channels, ahead of the stores before them: a
// pass's chain of shared-memory latencies no longer runs one value at a
// time. C: the channel count as a constant (-1: runtime, c).

// B, S1 and S2 hold f32 values with the channels interleaved: pixel col's
// channel ch at col * c + ch of its row, so a pixel's address serves its c
// values (constant offsets where C is).

// Pass 1, x by row: S1[ra + i - r1lo][j] for rows i < nr of a chunk and
// S1's columns j < nc2c (C2 on the canvas from c2clo), from the chunk's B
// (columns from c1lo) or, at p = 0, its stage (u8 at byte i * sp + col *
// c + ch of s8). A warp a row.
template <int C, bool U8>
__device__ __forceinline__ void pass1(const float* __restrict__ b, const uint8_t* __restrict__ s8,
                                      float* __restrict__ s1, const int* __restrict__ k1,
                                      const float* __restrict__ f1, int ra, int nr, int r1lo,
                                      int c2clo, int nc2c, int c1lo, int w, int c, int bp, int sp,
                                      int s1p, bool strict) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  c = C > 0 ? C : c;
  for (int i = warp; i < nr; i += kWarps) {
    const int r = ra + i, xb = c2clo + k1[r];
    const float f = f1[r];
    float* drow = s1 + (r - r1lo) * s1p;
    const float* brow = b + i * bp - c1lo * c;
    const uint8_t* srow = s8 + i * sp;
#pragma unroll 2
    for (int j = lane; j < nc2c; j += 32) {
      const int ia = clampi(xb + j, -1, w) * c, ib = clampi(xb + j + 1, -1, w) * c;
      float* d = drow + j * c;
#pragma unroll
      for (int ch = 0; ch < (C > 0 ? C : c); ++ch) {
        const float va = U8 ? u8f(srow[ia + ch]) : brow[ia + ch];
        const float vb = U8 ? u8f(srow[ib + ch]) : brow[ib + ch];
        const float v = lerp_rn(va, vb, f);
        d[ch] = strict ? floor_u8(v) : v;
      }
    }
  }
}

// Pass 2, y by column: S2[row][j] for tile rows row < nty and S2's columns
// j < nc2 (C2 from c2lo, fill at -1 and w), a warp down a column.
template <int C>
__device__ __forceinline__ void pass2(const float* __restrict__ s1, float* __restrict__ s2,
                                      const int* __restrict__ k2, const float* __restrict__ f2,
                                      int y0, int nty, int ty_log2, int r1lo, int c2lo, int nc2,
                                      int c2clo, int h, int w, int c, float fill, int s1p, int s2p,
                                      bool strict) {
  c = C > 0 ? C : c;
  const int ty = 1 << ty_log2;
#pragma unroll 2
  for (int e = threadIdx.x; e < (nc2 << ty_log2); e += kThreads) {
    const int row = e & (ty - 1), j = e >> ty_log2, xc = c2lo + j;
    if (row >= nty) continue;
    float* d = s2 + row * s2p + j * c;
    if (xc < 0 || xc >= w) {
#pragma unroll
      for (int ch = 0; ch < (C > 0 ? C : c); ++ch) d[ch] = fill;
      continue;
    }
    const int ya = y0 + row + k2[xc];
    const float f = f2[xc];
    const float* sc = s1 + (xc - c2clo) * c - r1lo * s1p;
    const float* sa = sc + clampi(ya, -1, h) * s1p;
    const float* sb = sc + clampi(ya + 1, -1, h) * s1p;
#pragma unroll
    for (int ch = 0; ch < (C > 0 ? C : c); ++ch) {
      const float v = lerp_rn(sa[ch], sb[ch], f);
      d[ch] = strict ? floor_u8(v) : v;
    }
  }
}

// Pass 3, x by row, and the quantization: the tile's pixels into the
// output tile (byte row * op + col * c + ch of o8).
template <int C, bool GRAY>
__device__ __forceinline__ void pass3(const float* __restrict__ s2, uint8_t* __restrict__ o8,
                                      const int* __restrict__ k1, const float* __restrict__ f1,
                                      int y0, int x0, int nty, int ntx, int tx_log2, int c2lo,
                                      int w, int c, int s2p, int op, bool strict) {
  c = C > 0 ? C : c;
  const int tx = 1 << tx_log2;
#pragma unroll 2
  for (int e = threadIdx.x; e < (nty << tx_log2); e += kThreads) {
    const int row = e >> tx_log2, col = e & (tx - 1);
    if (col >= ntx) continue;
    const int y = y0 + row, xa = x0 + col + k1[y];
    const float f = f1[y];
    const float* sr = s2 + row * s2p - c2lo * c;
    const float* sa = sr + clampi(xa, -1, w) * c;
    const float* sb = sr + clampi(xa + 1, -1, w) * c;
    uint8_t* o = o8 + row * op + col * c;
    float v[GRAY ? 3 : 1];
#pragma unroll
    for (int ch = 0; ch < (C > 0 ? C : c); ++ch) {
      const float t = lerp_rn(sa[ch], sb[ch], f);
      if (GRAY) {
        v[ch] = strict ? floor_u8(t) : t;
      } else {
        o[ch] = trunc_byte(t);  // strict's trunc included
      }
    }
    if (GRAY) o[0] = o[1] = o[2] = l24(v[0], v[1], v[2]);
  }
}

// An identity image: a chunk's rows [ra, ra + nr) of the tile, quantized
// from its B (columns from x0) or, at p = 0, its stage.
template <int C, bool GRAY, bool U8>
__device__ __forceinline__ void quantize_identity(const float* __restrict__ b,
                                                  const uint8_t* __restrict__ s8,
                                                  uint8_t* __restrict__ o8, int ra, int nr, int y0,
                                                  int x0, int ntx, int tx_log2, int c, int bp,
                                                  int sp, int op) {
  c = C > 0 ? C : c;
  const int tx = 1 << tx_log2;
  for (int e = threadIdx.x; e < (nr << tx_log2); e += kThreads) {
    const int i = e >> tx_log2, col = e & (tx - 1);
    if (col >= ntx) continue;
    uint8_t* o = o8 + (ra + i - y0) * op + col * c;
    const float* bv = b + i * bp + col * c;
    const uint8_t* sv = s8 + i * sp + (x0 + col) * c;
    float v[GRAY ? 3 : 1];
#pragma unroll
    for (int ch = 0; ch < (C > 0 ? C : c); ++ch) {
      const float t = U8 ? u8f(sv[ch]) : bv[ch];
      if (GRAY) {
        v[ch] = t;
      } else {
        o[ch] = rint_byte(t);
      }
    }
    if (GRAY) o[0] = o[1] = o[2] = l24(v[0], v[1], v[2]);
  }
}

// One block: one output tile of 2^ty_log2 x 2^tx_log2 pixels, all
// channels, image after image. P: the blur half-width as a constant (-1:
// the generic body reads it from the layout). C: the channel count as a
// constant (-1: from the layout). GRAY: PIL grayscale of 3 channels.
template <int P, int C, bool GRAY>
__global__ void __launch_bounds__(kThreads, kMinBlocks<P>)
rgb_tile_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                const float* __restrict__ taps, const int* __restrict__ k1g,
                const float* __restrict__ f1g, const int* __restrict__ k2g,
                const float* __restrict__ f2g, int shift_stride_h, int shift_stride_w, int n,
                int h, int w, int fill, bool strict, const int* __restrict__ identity,
                int identity_stride, int batch, Layout L) {
  extern __shared__ uint4 smem_words[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(smem_words);
  uint8_t* stage = smem + L.o_stage;
  uint8_t* otile = smem + L.o_out;
  float* B = reinterpret_cast<float*>(smem + L.o_b);  // B, then S2
  float* S2 = B;
  float* mid = reinterpret_cast<float*>(smem + L.o_mid);
  float* S1 = reinterpret_cast<float*>(smem + L.o_s1);
  float* tps = reinterpret_cast<float*>(smem + L.o_taps);
  int* meta_all = reinterpret_cast<int*>(smem + L.o_meta);

  const int p = P >= 0 ? P : L.p;
  const int c = C > 0 ? C : L.c;
  const float fillf = (float)fill;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < 2 * p + 1; i += kThreads) tps[i] = taps[i];
  Taps<P> tp;  // P constant: the taps in registers
#pragma unroll
  for (int t = 0; t < (P > 0 ? 2 * P + 1 : 0); ++t) tp.t[t] = taps[t];

  const int ty = 1 << L.ty_log2, tx = 1 << L.tx_log2;
  const int tiles_x = (w + tx - 1) >> L.tx_log2;
  const int y0 = (int)(blockIdx.x / tiles_x) * ty, x0 = (int)(blockIdx.x % tiles_x) * tx;
  const int nty = imin(ty, h - y0), ntx = imin(tx, w - x0);
  const int y1 = y0 + nty - 1, x1 = x0 + ntx - 1;
  const size_t row_bytes = (size_t)w * c;

  // Images in batches of `batch` (grid y strides over the batches): warp j
  // takes the footprint of the batch's image j, so their global latencies
  // overlap, then the images run one after another.
  const int meta_stride = kMeta + 2 * L.max_chunks;
  for (int first = blockIdx.y * batch; first < n; first += gridDim.y * batch) {
    const int nb = imin(batch, n - first);
    __syncthreads();  // the previous batch's tiles and footprints are consumed
    if (warp < nb) {
      const int img = first + warp;
      footprint(k1g + (size_t)img * shift_stride_h, k2g + (size_t)img * shift_stride_w, y0, y1,
                x0, x1, h, w, identity[(size_t)img * identity_stride] != 0, L,
                meta_all + warp * meta_stride);
    }
    __syncthreads();
    for (int img = first; img < first + nb; ++img) {
      const int* k1 = k1g + (size_t)img * shift_stride_h;
      const float* f1 = f1g + (size_t)img * shift_stride_h;
      const int* k2 = k2g + (size_t)img * shift_stride_w;
      const float* f2 = f2g + (size_t)img * shift_stride_w;
      const bool ident = identity[(size_t)img * identity_stride] != 0;  // block-uniform
      const uint8_t* xi = x + (size_t)img * h * row_bytes;
      uint8_t* oi = out + (size_t)img * h * row_bytes;
      const int* meta = meta_all + (img - first) * meta_stride;
      __syncthreads();  // the previous image's tiles are consumed
      const int c2lo = meta[0], c2hi = meta[1], r1lo = meta[2], r1hi = meta[3], nch = meta[4];
      const int c2clo = imax(c2lo, 0), nc2c = imax(imin(c2hi, w - 1) - c2clo + 1, 0);
      const int r1clo = imax(r1lo, 0), r1chi = imin(r1hi, h - 1);
      // the output tile's bytes: row r, column col, channel ch at
      // r * op + obase + col * c + ch, 16-byte aligned as the first row's
      // global address
      const int obase = 16 + (int)(((uintptr_t)oi + ((size_t)y0 * w + x0) * c) & 15);

      if (!ident) {  // S1's fill rows (-1, h) where R1 reaches them
        for (int r = -1; r <= h; r += h + 1) {
          if (r < r1lo || r > r1hi) continue;
          for (int ch = 0; ch < c; ++ch) {
            for (int j = tid; j < nc2c; j += kThreads) {
              S1[(r - r1lo) * L.s1p + j * c + ch] = fillf;
            }
          }
        }
      }
      for (int q = 0; q < nch; ++q) {
        const int ra = r1clo + q * L.rc, nr = imin(L.rc, r1chi - ra + 1);
        const int c1lo = meta[kMeta + 2 * q], c1hi = meta[kMeta + 2 * q + 1];
        const int cclo = imax(c1lo, 0), cchi = imin(c1hi, w - 1);  // C1 on the canvas
        // staged columns: C1 with its fill positions (p = 0), else C1 on the
        // canvas +- p, reflected
        const int lo_s = p == 0 ? c1lo : cclo - p, hi_s = p == 0 ? c1hi : cchi + p;
        const int col0 = imax(lo_s, 0), col1 = imin(hi_s, w - 1);
        const int rows = nr + 2 * p;
        // stage byte of (row i, column col, channel ch): i * sp + base + col * c + ch
        const uintptr_t g00 =
            (uintptr_t)xi + (size_t)reflect101(ra - p, h) * row_bytes + (size_t)col0 * c;
        const int base = 16 + (int)((g00 - (uintptr_t)((col0 - lo_s) * c)) & 15) - lo_s * c;
        const bool staged = p == 0 ? c1lo <= c1hi : cclo <= cchi;  // block-uniform
        __syncthreads();  // the previous chunk's stage and B are consumed
        if (P != 0) {  // fill at B's columns -1 and w
          for (int ch = 0; ch < c; ++ch) {
            for (int i = tid; i < nr; i += kThreads) {
              float* brow = B + i * L.bp + ch;
              if (c1lo < 0) brow[0] = fillf;
              if (c1hi >= w) brow[(w - c1lo) * c] = fillf;
            }
          }
        }
        if (staged && col0 <= col1) {
          for (int i = warp; i < rows; i += kWarps) {
            const uint8_t* row = xi + (size_t)reflect101(ra - p + i, h) * row_bytes;
            const uintptr_t rs = (uintptr_t)row, re = rs + row_bytes;
            const uintptr_t gs = rs + (size_t)col0 * c, ge = rs + (size_t)(col1 + 1) * c;
            uint8_t* dst = stage + i * L.sp + base + col0 * c;  // where gs lands
            if (((gs ^ (uintptr_t)(base + col0 * c)) & 15) == 0) {  // sp % 16 == 0
              const uintptr_t a0 = gs & ~(uintptr_t)15;
              const int nw = (int)((ge - a0 + 15) >> 4);
              for (int k = lane; k < nw; k += 32) {
                const uintptr_t g = a0 + 16 * (uintptr_t)k;
                uint8_t* d = dst - (int)(gs - g);
                if (g >= rs && g + 16 <= re) {
                  cp_async16(d, reinterpret_cast<const void*>(g));
                } else {
                  for (int b = 0; b < 16; ++b) {
                    if (g + b >= gs && g + b < ge) d[b] = *reinterpret_cast<const uint8_t*>(g + b);
                  }
                }
              }
            } else {  // a row aligned unlike the first (odd row bytes): byte copies
              for (int b = lane; b < (int)(ge - gs); b += 32) {
                dst[b] = *reinterpret_cast<const uint8_t*>(gs + b);
              }
            }
          }
          cp_async_wait_all();
        }
        __syncthreads();
        // off-canvas staged columns: fill, or reflected
        if (staged && (lo_s < 0 || hi_s > w - 1)) {
          const int left = imax(imin(-1, hi_s) - lo_s + 1, 0);
          const int right = imax(hi_s - imax(w, lo_s) + 1, 0);
          const int per_row = (left + right) * c;
          for (int e = tid; e < rows * per_row; e += kThreads) {
            const int i = e / per_row, r = e - i * per_row, k = r / c, ch = r - k * c;
            const int col = k < left ? lo_s + k : imax(w, lo_s) + (k - left);
            uint8_t* srow = stage + i * L.sp + base + ch;
            srow[col * c] = p == 0 ? (uint8_t)fill : srow[reflect101(col, w) * c];
          }
          __syncthreads();
        }
        const uint8_t* src8 = stage + base;  // p == 0: B is the stage
        if (P != 0 && staged) {
          const int ns = hi_s - lo_s + 1, nc1 = cchi - cclo + 1, bofs = cclo - c1lo;
          const int groups = (nr + kYRows - 1) / kYRows, groups4 = (imax(nc1, 0) + 3) >> 2;
          const Div div_ns(imax(ns, 1), groups * ns), div_g4(imax(groups4, 1), nr * groups4);
          for (int ch = 0; ch < c; ++ch) {
            y_pass<P>(stage + base + lo_s * c + ch, mid, tp, tps, p, c, nr, ns, L.sp, L.fp, div_ns);
            __syncthreads();
            x_pass<P>(mid, B + bofs * c + ch, tp, tps, p, c, nr, nc1, groups4, L.fp, L.bp, div_g4,
                      strict);
            __syncthreads();
          }
        }
        if (ident) {  // B's columns are the tile's
          quantize_identity<C, GRAY, P == 0>(B, src8, otile + obase, ra, nr, y0, x0, ntx, L.tx_log2,
                                             c, L.bp, L.sp, L.op);
        } else {
          pass1<C, P == 0>(B, src8, S1, k1, f1, ra, nr, r1lo, c2clo, nc2c, c1lo, w, c, L.bp,
                           L.sp, L.s1p, strict);
        }
      }
      __syncthreads();  // S1 is complete (and the identity tile quantized)
      if (!ident) {
        pass2<C>(S1, S2, k2, f2, y0, nty, L.ty_log2, r1lo, c2lo, c2hi - c2lo + 1, c2clo, h, w, c,
                 fillf, L.s1p, L.s2p, strict);
        __syncthreads();
        pass3<C, GRAY>(S2, otile + obase, k1, f1, y0, x0, nty, ntx, L.tx_log2, c2lo, w, c, L.s2p,
                       L.op, strict);
        __syncthreads();
      }

      // ---- store the tile's rows as aligned 16-byte words
      for (int row = warp; row < nty; row += kWarps) {
        const uintptr_t gs = (uintptr_t)oi + ((size_t)(y0 + row) * w + x0) * c;
        const uintptr_t ge = gs + (size_t)ntx * c;
        const uint8_t* src = otile + row * L.op + obase;  // where gs's byte is
        if (((gs ^ (uintptr_t)obase) & 15) == 0) {
          const uintptr_t a0 = gs & ~(uintptr_t)15;
          const int nw = (int)((ge - a0 + 15) >> 4);
          for (int k = lane; k < nw; k += 32) {
            const uintptr_t g = a0 + 16 * (uintptr_t)k;
            const uint8_t* sw = src - (int)(gs - g);
            if (g >= gs && g + 16 <= ge) {
              *reinterpret_cast<uint4*>(g) = *reinterpret_cast<const uint4*>(sw);
            } else {
              for (int b = 0; b < 16; ++b) {
                if (g + b >= gs && g + b < ge) *reinterpret_cast<uint8_t*>(g + b) = sw[b];
              }
            }
          }
        } else {  // a row aligned unlike the first: byte stores
          for (int b = lane; b < (int)(ge - gs); b += 32) {
            *reinterpret_cast<uint8_t*>(gs + b) = src[b];
          }
        }
      }
    }
  }
}

struct Args {
  const void *x, *taps, *k1, *f1, *k2, *f2, *identity;
  void* out;
  int shift_stride_h, shift_stride_w, n, h, w, fill, identity_stride, batch;
  bool strict;
};

template <int P, int C, bool GRAY>
cudaError_t launch(const Args& a, const Layout& L, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(rgb_tile_kernel<P, C, GRAY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (err != cudaSuccess) return err;
  const int tiles = ((a.h + (1 << L.ty_log2) - 1) >> L.ty_log2) *
                    ((a.w + (1 << L.tx_log2) - 1) >> L.tx_log2);
  const int batches = (a.n + a.batch - 1) / a.batch;
  const dim3 grid(tiles, batches < kMaxGridY ? batches : kMaxGridY);
  rgb_tile_kernel<P, C, GRAY><<<grid, kThreads, L.total, st>>>(
      static_cast<const uint8_t*>(a.x), static_cast<uint8_t*>(a.out),
      static_cast<const float*>(a.taps), static_cast<const int*>(a.k1),
      static_cast<const float*>(a.f1), static_cast<const int*>(a.k2),
      static_cast<const float*>(a.f2), a.shift_stride_h, a.shift_stride_w, a.n, a.h, a.w, a.fill,
      a.strict, static_cast<const int*>(a.identity), a.identity_stride, a.batch, L);
  return cudaGetLastError();
}

// The instances: p 0 and 4 as constants (apply_all's rotation, the default
// chain's r 1.5), c 3 as a constant, generic bodies for the rest.
template <int P>
cudaError_t launch_c(const Args& a, bool gray, const Layout& L, cudaStream_t st) {
  if (gray) return launch<P, 3, true>(a, L, st);
  return L.c == 3 ? launch<P, 3, false>(a, L, st) : launch<P, -1, false>(a, L, st);
}

cudaError_t launch_p(const Args& a, bool gray, const Layout& L, cudaStream_t st) {
  switch (L.p) {
    case 0:
      return launch_c<0>(a, gray, L, st);
    case 4:
      return launch_c<4>(a, gray, L, st);
    default:
      return launch_c<-1>(a, gray, L, st);
  }
}

}  // namespace

// x, out: u8 [n, h, w, c]; taps: f32 [2p + 1], p <= min(h, w) - 1;
// k1/f1: [h] and k2/f2: [w] per image, images shift_stride_h /
// shift_stride_w elements apart (0: one set for all). strict: per-op u8
// quantization (stream=False); grayscale needs c == 3; identity: i32 flags,
// 1 for an image at angle 0 (no shears, rint), identity_stride apart (0:
// one flag for all). The tiling (megakernel._tiling): tiles of
// 2^tile_rows_log2 x 2^tile_cols_log2 pixels, R1 cut into
// chunks of chunk_rows, footprints of at most max_r1 rows, max_c2 columns
// of S2 and max_c1 columns of B a chunk; smem_bytes, the shared memory the
// host computed for it, must equal the layout's; batch: images whose
// footprints a block takes at once (1..8). Launches on `stream`;
// returns a CUDA error code (0 on success; cudaErrorInvalidValue for
// arguments the kernel does not take).
extern "C" int rgb_blur_rotate(const void* x, void* out, const void* taps, int p, const void* k1,
                               const void* f1, const void* k2, const void* f2,
                               int shift_stride_h, int shift_stride_w, int n, int h, int w,
                               int c, int fill, int strict, int grayscale,
                               const void* identity, int identity_stride, int tile_rows_log2,
                               int tile_cols_log2, int chunk_rows, int max_r1, int max_c2,
                               int max_c1, int smem_bytes, int batch, void* stream) {
  if (n <= 0 || h <= 0 || w <= 0 || c <= 0 || p < 0 || p > h - 1 || p > w - 1 ||
      (grayscale && c != 3) || tile_rows_log2 < 0 || tile_rows_log2 > 10 ||
      tile_cols_log2 < 0 || tile_cols_log2 > 10 || chunk_rows < 1 ||
      max_r1 < 1 || max_c2 < 0 || max_c1 < 1 || batch < 1 || batch > kMaxBatch) {
    return cudaErrorInvalidValue;
  }
  const Layout L = make_layout(p, c, tile_rows_log2, tile_cols_log2, chunk_rows, max_r1, max_c2,
                               max_c1);
  if (L.total != smem_bytes) return cudaErrorInvalidValue;
  const Args a{x,    taps, k1, f1, k2, f2, identity, out, shift_stride_h, shift_stride_w, n, h,
               w,    fill, identity_stride, batch, strict != 0};
  return launch_p(a, grayscale != 0, L, static_cast<cudaStream_t>(stream));
}
