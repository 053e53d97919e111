// Fractional row and column shifts: NHWC u8 in and out, any channel count.
// One library for three Pallas kernels, which all compute the same
// bounds-checked two-tap gather along a row, plus its column counterpart:
//
//   imagetransformations_tpu/ops/pallas/shear.py:446 `kernel`, the body of
//     shear_rows_logrouted (launched at :471): one shift per (image, row),
//     saturation at +-b_px; the fast (non-PIL) shear of apply_all.
//   shear.py:67 `_shear_kernel`, reached through _shear_core (:146) from
//     shear_rows, rotate_3shear and blur_rotate_fused: one shift per row
//     shared by the batch (shift stride 0), optionally followed by PIL L24
//     grayscale replicated to 3 channels.
//   shear.py:182 `_shear_kernel_per_image`, reached through
//     shear_rows_per_image (:252): one shift per (image, row), saturated at
//     +-pad_px.
//
// Per (image n, row y), in f32 with every op rounded on its own:
//   k = floor(s), f = s - k, ki = clamp(k, -b_px, b_px)   (saturation)
//   a = in[x+ki] if 0 <= x+ki < w else fill
//   b = in[x+ki+1] if 0 <= x+ki+1 < w else fill
//   out = trunc(a + f*(b - a)) where -1 <= x+ki <= w-1, else fill.
// x+ki == -1 and x+ki == w-1 lerp against fill (the border fill-lerps). The
// Pallas kernels get there by lane rolls over a fill-padded 128-lane slab
// (a dynamic roll by the biased shift, or log-routed static rolls); worked
// through, that is exactly the bounds-checked gather above. With grayscale
// the three truncated channel values r, g, b of a pixel become
// (g*38470 + r*19595 + b*7471 + 32768) >> 16 in each channel, the integer
// form of the Pallas post-op's exact f32 floor((sum3 + 32768) / 65536).
//
// The column pass (shear_cols) is the same function along y: column x of
// every image shifts by sy[x] (one f32 [w] vector for the batch), with h in
// the place of w. It equals transposing h and w, shear_rows, transposing
// back, byte for byte. The Pallas rotate_3shear runs its middle shear that
// way (a row shift of the transposed slab, ops/pallas/shear.py:388,392), a
// TPU lane-layout need; here the column pass reads the columns in place.
//
// Two facts make the window test unnecessary. Where j = x+ki < -1 or
// j > w-1 both taps are fill, and fill + f*(fill - fill) == fill exactly;
// so a stage holding fill outside [0, w) gives every output, border lerps
// included. And clamping ki further to [-(w+1), w] changes nothing (all
// such rows are fill already), so the source span of a row never depends on
// b_px, which can be as large as w + 2.
//
// Bound on the H100: the function must read the source values its taps
// touch (at most n*h*w*c u8) and the f32 shifts and write n*h*w*c u8: at
// most ~15 us at 32x512x512x3 over 3.35 TB/s (~7.6 us at 4096x32x32x3). Its
// arithmetic, ~7 operations a value (two u8->f32 conversions, the lerp, the
// trunc and its conversion) and five a row, none fused, issues in ~6 us at
// 33.5e12 a second. So bytes bound it.
//
// Design against that bound. The first version of this kernel ran one
// thread a byte, with a division by c, two bounds-checked byte loads with
// branches and a byte store per value: 0.124 ms at 32x512x512x3, 8x the
// bound, paced by its per-thread instructions. Now:
// - Row pass. A row is cut into segments of at most ~4 KB (a whole row up
//   to 4096 bytes). A team of threads (a power of two, 1 to 256, sized so
//   each thread has about two 16-byte words) owns a segment; a 256-thread
//   block holds 256/team segments, so 4096x32x32x3's 96-byte rows go 64 to
//   a block. Blocks stride over the segments: no grid cap bounds the batch.
// - Stage. Each team takes (ki, f) once from one broadcast load of its
//   row's shift, then copies its segment's source span, bytes
//   [b0 + ki*c, b1 + (ki+1)*c), into shared memory as the aligned 16-byte
//   words that cover it: 16-byte loads where a word lies inside the row,
//   fill words outside it, byte loads only for the words that straddle its
//   ends. The stage is indexed by global address modulo the words, so
//   unaligned rows and odd base pointers need nothing else. A team's region
//   is 64 bytes past a multiple of 128 (gray: 32 past 64), so the teams of
//   a quarter warp read other banks (the gray pass ran 1.7x slower at
//   4096x32x32 without it).
// - Compute. Output byte i of a row reads staged bytes i + ki*c and
//   i + (ki+1)*c, since a pixel's channels share the shift: no division by
//   c is left in the per-value path, and c is a template constant for 1, 3
//   and 4 (a generic body takes the rest). A thread makes one aligned
//   16-byte output word at a time from 10 aligned 4-byte shared loads and 8
//   funnel shifts. A tap becomes f32 as 2^23 | b (a byte permute) minus
//   2^23, and trunc(v) (v >= 0) is the low byte of v + 2^23 added rounding
//   down: no conversion instruction (those issue at a fraction of the add
//   rate). Whole words leave as 16-byte stores, the words at a segment's
//   ends byte by byte.
// - Gray (c == 3): the shifted bytes go to a shared output buffer, then one
//   thread a pixel writes the L24 luma to its three bytes, then the words
//   leave as above.
// - Column pass. A block owns a tile of 128 bytes of columns (32 threads of
//   4 bytes) and up to 48 output rows, takes each column's (ki, f) once
//   (the tile's kmin and kmax through a 32-entry shared table, not
//   same-address atomics), and loops over images (grid z is sized to twice
//   the blocks the card holds). Where rows start 4-aligned it stages source
//   rows [y0 + kmin, y0 + rows + kmax] of its columns (coalesced 4-byte row
//   segments, eight loads in flight a thread, fill outside [0, h)); where
//   the span fits one batch of
//   loads (64 rows: so the 48-row band, which beat 64 and 128 rows), the
//   next image's rows load while this image is computed. Each thread lerps its 4 bytes down its rows, with one 4-byte
//   shared load a tap where its 4 columns share ki. For Paeth shifts
//   kmax - kmin is at most ~44 on a 43-pixel tile. A tile whose span exceeds
//   the stage (arbitrary shift vectors), or whose rows are not 4-aligned
//   (w*c % 4 != 0, an odd base pointer), reads its taps from device memory
//   with the bounds checks.
// Every launch is sized from the kernel's own limits (cudaFuncGetAttributes,
// and the occupancy the column pass's grid z is sized from).
//
// Measured (NVIDIA H100 80GB HBM3, 700 W, tools/time_shear.py, device time
// by torch.profiler; PERF.md has the runs): at 32x512x512x3 the row pass
// 0.026-0.028 ms (0.035 with the gray flag), the column pass 0.042 ms,
// rotate_3shear 0.10 ms (0.56 with the one-thread-a-byte kernel and two
// transposes).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSegBytes = 4096;  // longest row segment a team owns
constexpr long long kMaxBlocks = 1 << 20;  // row pass: blocks loop beyond this
constexpr int kMaxGridZ = 65535;
constexpr int kColBytes = 128;  // column-pass tile width: 32 threads x 4 bytes
constexpr int kColRows = 48;    // output rows of a column-pass tile
constexpr int kColSpare = 96;   // stage rows beyond the tile's rows + 1
constexpr int kStageBatch = 8;  // column-pass staging loads in flight a thread
constexpr int kColWaves = 2;    // column-pass blocks: twice what the card holds at once
constexpr float kTwo23 = 8388608.0f;

// 16 staged bytes from shared byte offset p (any alignment), as 4 words.
__device__ __forceinline__ void load16(const uint8_t* s, int p, uint32_t r[4]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(s + (p & ~3));
  const uint32_t sh = (uint32_t)(p & 3) * 8u;
  const uint32_t v0 = w[0], v1 = w[1], v2 = w[2], v3 = w[3], v4 = w[4];
  r[0] = __funnelshift_r(v0, v1, sh);
  r[1] = __funnelshift_r(v1, v2, sh);
  r[2] = __funnelshift_r(v2, v3, sh);
  r[3] = __funnelshift_r(v3, v4, sh);
}

// trunc(a + f*(b - a)) for the four byte pairs of words l (a) and r (b),
// with f[t] for byte t, every op rounded on its own. a + f*(b - a) lies
// between a and b, both in [0, 255]: no clip, and trunc is floor.
__device__ __forceinline__ uint32_t lerp4(uint32_t l, uint32_t r, const float f[4]) {
  uint32_t q[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float ap = __uint_as_float(__byte_perm(l, 0x4B000000u, 0x7440 + t));  // 2^23 + a
    const float bp = __uint_as_float(__byte_perm(r, 0x4B000000u, 0x7440 + t));  // 2^23 + b
    const float a = __fsub_rn(ap, kTwo23);
    const float v = __fadd_rn(a, __fmul_rn(f[t], __fsub_rn(bp, ap)));
    q[t] = __float_as_uint(__fadd_rd(v, kTwo23));  // 2^23 + floor(v): floor(v) in the low byte
  }
  return __byte_perm(__byte_perm(q[0], q[1], 0x0040), __byte_perm(q[2], q[3], 0x0040), 0x5410);
}

// (ki, f) of shift s: floor, the saturation at +-b_px, then [lo, hi].
__device__ __forceinline__ void shift_of(float s, float lo, float hi, int& ki, float& f) {
  const float k = floorf(s);
  f = __fsub_rn(s, k);
  ki = (int)fminf(fmaxf(k, lo), hi);
}

__device__ __forceinline__ uint32_t luma3(uint32_t r, uint32_t g, uint32_t b) {
  return (g * 38470u + r * 19595u + b * 7471u + 32768u) >> 16;
}

// Row pass. Segment sg of nsegs: row sg / nseg, bytes [b0, b1) of it. Each
// team's shared region: a stage of `stg` bytes (then, with GRAY, an output
// buffer of as many). Stage byte 16 + (g - a0) holds the source byte at
// global address g; a0 is the aligned start of the segment's span.
template <int C, bool GRAY>
__global__ void __launch_bounds__(kThreads)
shear_rows_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                  const float* __restrict__ shifts, int shift_stride, long long nsegs, int h,
                  int w, int cc, int fill, int b_px, int seg, int nseg, int tpr_log2, int stg) {
  extern __shared__ uint4 smem_words[];
  const int c = C > 0 ? C : cc;
  const long long wc = (long long)w * c;
  const int tpr = 1 << tpr_log2;
  const int team = threadIdx.x >> tpr_log2, lane = threadIdx.x & (tpr - 1);
  const int teams = blockDim.x >> tpr_log2;
  uint8_t* st = reinterpret_cast<uint8_t*>(smem_words) + (size_t)team * stg * (GRAY ? 2 : 1);
  uint8_t* ob = st + stg;
  const uint32_t fill4 = (uint32_t)fill * 0x01010101u;
  const int blo = b_px < w + 1 ? b_px : w + 1, bhi = b_px < w ? b_px : w;
  const float lo = (float)-blo, hi = (float)bhi;

  for (long long base = (long long)blockIdx.x * teams; base < nsegs;
       base += (long long)gridDim.x * teams) {
    const long long sg = base + team;
    const bool active = sg < nsegs;
    long long row = 0, b0 = 0, b1 = 0, gx = 0, go = 0, a0 = 0, ow0 = 0;
    int ki = 0, nwords = 0;
    float f = 0.0f;
    if (active) {
      long long img;
      if (nsegs <= UINT_MAX) {  // 32-bit divisions (a 64-bit one is a long call)
        const unsigned su = (unsigned)sg, ru = su / (unsigned)nseg;
        row = ru;
        b0 = (long long)(su - ru * (unsigned)nseg) * seg;
        img = ru / (unsigned)h;
      } else {
        row = sg / nseg;
        b0 = (sg - row * nseg) * seg;
        img = row / h;
      }
      b1 = b0 + seg < wc ? b0 + seg : wc;
      const long long y = row - img * h;
      shift_of(shifts[img * shift_stride + y], lo, hi, ki, f);
      gx = (long long)(uintptr_t)(x + row * wc);
      go = (long long)(uintptr_t)(out + row * wc);
      a0 = (gx + b0 + (long long)ki * c) & ~15LL;
      const long long gend = gx + b1 + (long long)(ki + 1) * c;
      const int nin = (int)((gend - a0 + 15) >> 4);
      for (int k = lane; k < nin; k += tpr) {
        const long long rel = a0 + 16LL * k - gx;  // row byte of the word's first byte
        uint4 v;
        if (rel >= 0 && rel + 16 <= wc) {
          v = *reinterpret_cast<const uint4*>(x + row * wc + rel);
        } else if (rel + 16 <= 0 || rel >= wc) {
          v = make_uint4(fill4, fill4, fill4, fill4);
        } else {
          uint32_t q[4];
#pragma unroll
          for (int t = 0; t < 16; t += 4) {
            uint32_t word = 0;
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const long long j = rel + t + u;
              const uint32_t b = (j >= 0 && j < wc) ? x[row * wc + j] : (uint32_t)fill;
              word |= b << (8 * u);
            }
            q[t / 4] = word;
          }
          v = make_uint4(q[0], q[1], q[2], q[3]);
        }
        *reinterpret_cast<uint4*>(st + 16 + 16 * k) = v;
      }
      ow0 = (go + b0) & ~15LL;
      nwords = (int)((go + b1 - ow0 + 15) >> 4);
    }
    __syncthreads();
    // stage offset of the left tap of output word k: 16 + (gx + i0 + ki*c - a0)
    const long long sbase = 16 + gx + (long long)ki * c - a0 + (ow0 - go);
    const float ff[4] = {f, f, f, f};
    for (int k = lane; k < nwords; k += tpr) {
      const int p = (int)(sbase + 16LL * k);
      uint32_t L[4], R[4], o[4];
      load16(st, p, L);
      load16(st, p + c, R);
#pragma unroll
      for (int t = 0; t < 4; ++t) o[t] = lerp4(L[t], R[t], ff);
      if (GRAY) {
        *reinterpret_cast<uint4*>(ob + 16 * k) = make_uint4(o[0], o[1], o[2], o[3]);
        continue;
      }
      const long long ow = ow0 + 16LL * k, i0 = ow - go;
      uint8_t* dst = reinterpret_cast<uint8_t*>((uintptr_t)ow);
      if (i0 >= b0 && i0 + 16 <= b1) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(o[0], o[1], o[2], o[3]);
      } else {
#pragma unroll
        for (int t = 0; t < 16; ++t) {
          if (i0 + t >= b0 && i0 + t < b1) dst[t] = (uint8_t)(o[t >> 2] >> (8 * (t & 3)));
        }
      }
    }
    if (GRAY) {
      __syncthreads();
      const int npix = (int)((b1 - b0) / 3);  // b0, b1 are multiples of 3
      const int pix0 = (int)(go + b0 - ow0);
      for (int q = lane; q < npix; q += tpr) {
        uint8_t* px = ob + pix0 + 3 * q;
        const uint8_t l = (uint8_t)luma3(px[0], px[1], px[2]);
        px[0] = px[1] = px[2] = l;
      }
      __syncthreads();
      for (int k = lane; k < nwords; k += tpr) {
        const long long ow = ow0 + 16LL * k, i0 = ow - go;
        uint8_t* dst = reinterpret_cast<uint8_t*>((uintptr_t)ow);
        if (i0 >= b0 && i0 + 16 <= b1) {
          *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(ob + 16 * k);
        } else {
          for (int t = 0; t < 16; ++t) {
            if (i0 + t >= b0 && i0 + t < b1) dst[t] = ob[16 * k + t];
          }
        }
      }
    }
    __syncthreads();  // the stage is rewritten next round
  }
}

// Column pass. Block (tile of kColBytes columns, band of `band` output rows),
// images strided over grid z. Stage row r holds source row y0 + kmin + r of
// the tile's columns (fill outside [0, h)), kColBytes bytes a row.
template <int C>
__global__ void __launch_bounds__(kThreads)
shear_cols_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                  const float* __restrict__ shifts, int n, int h, int w, int cc, int fill,
                  int b_px, int band, int cap) {
  extern __shared__ uint4 smem_words[];
  uint8_t* st = reinterpret_cast<uint8_t*>(smem_words);
  __shared__ int kred[2][32];  // per-lane kmin, kmax of warp 0
  const int c = C > 0 ? C : cc;
  const long long wc = (long long)w * c;
  const int g = threadIdx.x & 31, rl = threadIdx.x >> 5, nrl = blockDim.x >> 5;
  const long long col = (long long)blockIdx.x * kColBytes + 4 * g;  // first of 4 byte columns
  const int y0 = blockIdx.y * band;
  const int rows = band < h - y0 ? band : h - y0;
  const uint32_t fill4 = (uint32_t)fill * 0x01010101u;
  const int blo = b_px < h + 1 ? b_px : h + 1, bhi = b_px < h ? b_px : h;
  const float lo = (float)-blo, hi = (float)bhi;

  int ki[4];
  float f[4];
  int kmin = INT_MAX, kmax = INT_MIN;  // this thread's columns, then the tile's
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    ki[t] = 0;
    f[t] = 0.0f;
    if (col + t < wc) {
      shift_of(shifts[(col + t) / c], lo, hi, ki[t], f[t]);
      kmin = min(kmin, ki[t]);
      kmax = max(kmax, ki[t]);
    }
  }
  if (rl == 0) {
    kred[0][g] = kmin;
    kred[1][g] = kmax;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 1; i < 32; ++i) {
      kred[0][0] = min(kred[0][0], kred[0][i]);
      kred[1][0] = max(kred[1][0], kred[1][i]);
    }
  }
  __syncthreads();
  kmin = kred[0][0];
  kmax = kred[1][0];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (col + t >= wc) ki[t] = kmin;  // not stored; keeps the stage index in range
  }
  const int span = rows + 1 + (kmax - kmin);  // staged source rows
  // staged: the span fits and rows start 4-aligned (else direct taps)
  const bool in4 = ((uintptr_t)x % 4 == 0) && (wc % 4 == 0);
  const bool staged = span <= cap && in4;
  const bool same_k = ki[0] == ki[1] && ki[1] == ki[2] && ki[2] == ki[3];
  const bool full = col + 4 <= wc;
  const bool out4 = ((uintptr_t)out % 4 == 0) && (wc % 4 == 0);

  // the stage rows this thread loads: r = rl + u * nrl; when they cover the
  // span, the next image's rows load while this image is computed
  const bool ahead = staged && span <= kStageBatch * nrl;
  uint32_t v[kStageBatch];
  auto load_rows = [&](long long img, int r0) {
    const uint8_t* xi = x + img * h * wc;
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int r = r0 + u * nrl;
      const long long j = (long long)y0 + kmin + r;
      // wc % 4 == 0 here, so a thread's 4 columns are all in or all out
      v[u] = (img < n && r < span && j >= 0 && j < h && full)
                 ? __ldg(reinterpret_cast<const uint32_t*>(xi + j * wc + col))
                 : fill4;
    }
  };
  auto store_rows = [&](int r0) {
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int r = r0 + u * nrl;
      if (r < span) *reinterpret_cast<uint32_t*>(st + r * kColBytes + 4 * g) = v[u];
    }
  };
  if (ahead) load_rows(blockIdx.z, rl);

  for (long long img = blockIdx.z; img < n; img += gridDim.z) {
    const uint8_t* xi = x + img * h * wc;
    uint8_t* oi = out + img * h * wc;
    if (ahead) {
      store_rows(rl);
      __syncthreads();
      load_rows(img + gridDim.z, rl);
    } else if (staged) {  // 4-byte loads, kStageBatch in flight a thread
      for (int r0 = rl; r0 < span; r0 += nrl * kStageBatch) {
        load_rows(img, r0);
        store_rows(r0);
      }
      __syncthreads();
    }
    for (int yy = rl; yy < rows; yy += nrl) {
      uint32_t A = 0, B = 0;
      if (staged && same_k) {
        const uint8_t* s = st + (yy + ki[0] - kmin) * kColBytes + 4 * g;
        A = *reinterpret_cast<const uint32_t*>(s);
        B = *reinterpret_cast<const uint32_t*>(s + kColBytes);
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          uint32_t a, b;
          if (staged) {
            const uint8_t* s = st + (yy + ki[t] - kmin) * kColBytes + 4 * g + t;
            a = s[0];
            b = s[kColBytes];
          } else {
            const long long j = (long long)y0 + yy + ki[t];
            const bool ok = col + t < wc;
            a = (ok && j >= 0 && j < h) ? xi[j * wc + col + t] : (uint32_t)fill;
            b = (ok && j + 1 >= 0 && j + 1 < h) ? xi[(j + 1) * wc + col + t] : (uint32_t)fill;
          }
          A |= a << (8 * t);
          B |= b << (8 * t);
        }
      }
      const uint32_t o = lerp4(A, B, f);
      uint8_t* dst = oi + (long long)(y0 + yy) * wc + col;
      if (out4 && full) {
        *reinterpret_cast<uint32_t*>(dst) = o;
      } else {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (col + t < wc) dst[t] = (uint8_t)(o >> (8 * t));
        }
      }
    }
    if (staged) __syncthreads();  // the stage is rewritten for the next image
  }
}

template <typename K>
cudaError_t threads_for(K kernel, int* threads, int* max_smem) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int t = attr.maxThreadsPerBlock < kThreads ? attr.maxThreadsPerBlock : kThreads;
  *threads = t;
  *max_smem = attr.maxDynamicSharedSizeBytes;
  return cudaSuccess;
}

// Blocks of `kernel` (threads, smem) the card holds at once, times kColWaves:
// the column pass launches no more and its blocks loop over the images, so a
// block's loads for its next image overlap this image's arithmetic.
template <typename K>
cudaError_t resident_blocks(K kernel, int threads, size_t smem, long long* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  }
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;  // the block does not fit an SM
  *blocks = (long long)kColWaves * sms * per_sm;
  return cudaSuccess;
}

template <int C, bool GRAY>
cudaError_t launch_rows(const uint8_t* x, uint8_t* out, const float* s, int stride, int n, int h,
                        int w, int c, int fill, int b_px, cudaStream_t st) {
  const auto kernel = shear_rows_kernel<C, GRAY>;
  int max_threads, max_smem;
  cudaError_t err = threads_for(kernel, &max_threads, &max_smem);
  if (err != cudaSuccess) return err;
  const long long wc = (long long)w * c;
  // segments: a whole row up to kSegBytes, else whole pixels up to it
  long long seg = wc <= kSegBytes ? wc : (kSegBytes / c) * (long long)c;
  if (seg < c) seg = c;
  const long long nseg = (wc + seg - 1) / seg;
  const long long nsegs = (long long)n * h * nseg;
  // a team: about two 16-byte output words a thread
  const long long words = seg / 16 + 2;
  int tpr_log2 = 0;
  while ((1LL << tpr_log2) * 2 < words && (1 << tpr_log2) < kThreads) ++tpr_log2;
  while ((1 << tpr_log2) > 1 && (1 << tpr_log2) > max_threads) --tpr_log2;
  // a team's stage: a 16-byte front margin, the span's words, 32 bytes of
  // overread; its length is 64 mod 128 (32 mod 64 with the output buffer)
  // so that the teams of a quarter warp use other banks
  int stg = (int)(16 + (seg + c + 30 + 15) / 16 * 16 + 32);
  const int phase = GRAY ? 32 : 64, period = GRAY ? 64 : 128;
  stg += ((phase - stg % period) + period) % period;
  int teams = max_threads >> tpr_log2;
  const int per_team = stg * (GRAY ? 2 : 1);
  while (teams > 1 && (long long)teams * per_team > max_smem) teams >>= 1;
  if ((long long)teams * per_team > max_smem) return cudaErrorInvalidValue;
  long long blocks = (nsegs + teams - 1) / teams;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  kernel<<<(unsigned)blocks, teams << tpr_log2, teams * per_team, st>>>(
      x, out, s, stride, nsegs, h, w, c, fill, b_px, (int)seg, (int)nseg, tpr_log2, stg);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_cols(const uint8_t* x, uint8_t* out, const float* s, int n, int h, int w,
                        int c, int fill, int b_px, cudaStream_t st) {
  const auto kernel = shear_cols_kernel<C>;
  int max_threads, max_smem;
  cudaError_t err = threads_for(kernel, &max_threads, &max_smem);
  if (err != cudaSuccess) return err;
  const int threads = max_threads / 32 * 32;
  if (threads < 32) return cudaErrorInvalidConfiguration;
  const int band = h < kColRows ? h : kColRows;
  // the stage: the band, its extra row, and room for kmax - kmin; no more
  // than any shift vector can need (ki in [-(h+1), h])
  long long cap = (long long)band + 1 + kColSpare;
  if (cap > (long long)band + 2 * h + 2) cap = (long long)band + 2 * h + 2;
  while (cap * kColBytes > max_smem && cap > band + 1) cap = (cap + band + 1) / 2;
  const long long wc = (long long)w * c;
  const long long tiles = (wc + kColBytes - 1) / kColBytes;
  const long long bands = (h + band - 1) / band;
  if (tiles > INT_MAX || bands > 65535) return cudaErrorInvalidValue;
  long long most = 0;
  err = resident_blocks(kernel, threads, (size_t)cap * kColBytes, &most);
  if (err != cudaSuccess) return err;
  long long z = (most + tiles * bands - 1) / (tiles * bands);  // images in flight
  if (z > n) z = n;
  if (z > kMaxGridZ) z = kMaxGridZ;
  dim3 grid((unsigned)tiles, (unsigned)bands, (unsigned)z);
  kernel<<<grid, threads, (size_t)cap * kColBytes, st>>>(x, out, s, n, h, w, c, fill, b_px,
                                                         band, (int)cap);
  return cudaGetLastError();
}

}  // namespace

// x: u8 [n, h, w, c]; out: u8 [n, h, w, c]; shifts: f32, image i's row y at
// i * shift_stride + y (shift_stride 0: one [h] vector for the batch, h:
// [n, h]); fill in [0, 255]; b_px >= 0 the saturation bound; grayscale
// (c == 3): PIL L24 luma of the shifted pixel in all three channels.
// Launches on `stream`; returns a CUDA error code (0 on success).
extern "C" int shear_rows(const void* x, void* out, const void* shifts, int shift_stride,
                          int n, int h, int w, int c, int fill, int b_px, int grayscale,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* xi = static_cast<const uint8_t*>(x);
  uint8_t* o = static_cast<uint8_t*>(out);
  const float* s = static_cast<const float*>(shifts);
  if (grayscale) {
    if (c != 3) return cudaErrorInvalidValue;
    return launch_rows<3, true>(xi, o, s, shift_stride, n, h, w, c, fill, b_px, st);
  }
  switch (c) {
    case 1: return launch_rows<1, false>(xi, o, s, shift_stride, n, h, w, c, fill, b_px, st);
    case 3: return launch_rows<3, false>(xi, o, s, shift_stride, n, h, w, c, fill, b_px, st);
    case 4: return launch_rows<4, false>(xi, o, s, shift_stride, n, h, w, c, fill, b_px, st);
    default: return launch_rows<0, false>(xi, o, s, shift_stride, n, h, w, c, fill, b_px, st);
  }
}

// The column pass: column x of every image of x (u8 [n, h, w, c]) shifted
// along y by shifts[x] (f32 [w], one vector for the batch), the row pass's
// lerp, trunc, fill, saturation at +-b_px and border fill-lerps with h in
// the place of w. Launches on `stream`; returns a CUDA error code.
extern "C" int shear_cols(const void* x, void* out, const void* shifts, int n, int h, int w,
                          int c, int fill, int b_px, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* xi = static_cast<const uint8_t*>(x);
  uint8_t* o = static_cast<uint8_t*>(out);
  const float* s = static_cast<const float*>(shifts);
  switch (c) {
    case 1: return launch_cols<1>(xi, o, s, n, h, w, c, fill, b_px, st);
    case 3: return launch_cols<3>(xi, o, s, n, h, w, c, fill, b_px, st);
    case 4: return launch_cols<4>(xi, o, s, n, h, w, c, fill, b_px, st);
    default: return launch_cols<0>(xi, o, s, n, h, w, c, fill, b_px, st);
  }
}
