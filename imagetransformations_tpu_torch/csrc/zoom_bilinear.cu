// Centre zoom by bilinear sampling, one factor an image: NHWC u8 in and
// out, any channel count, zero fill; random_zoom and the fast scale of
// apply_all.
//
// Replaces: imagetransformations_tpu/ops/pallas/resample.py:86
// _hpass_kernel and :96 _vpass_kernel (zoom_bilinear_batched, launched at
// :155 and :175). One kernel does both passes for each output pixel and
// gives the same bits: the two row lerps of the H pass are recomputed
// here, so no f32 intermediate goes through HBM. Per axis of size dim, in
// f32 with every op rounded on its own (resample.py:70-83 _coords):
//   inv = 1/f (IEEE division), half = dim/2, m = half - inv*half,
//   src = inv*(pos + 0.5) + m, sin = src - 0.5, s0 = floor(sin),
//   frac = sin - s0, taps at clamp(s0, 0, dim-1) and clamp(s0+1, 0, dim-1),
//   valid = 0 <= src < dim.
// H pass: top/bottom = lerp along x of source rows y0 and y1, 0 where x is
// not valid. V pass: lerp along y of those two, clip(trunc(.), 0, 255), 0
// where y is not valid. Both lerps stay between their u8 ends, so the
// clip never binds and trunc is the only rounding to u8. The roll budgets
// of the Pallas kernels (drange) exist only for the TPU's lane rolls.
//
// Bound on the H100 (chip_smoke.py bound_zoom): the function must read the
// source values its taps touch (all of them for f <= 1, ~1/f^2 of them
// above) and write n*h*w*c u8; its arithmetic is one u8 -> f32 conversion
// a source value read, three lerps a value, and the axis terms once a
// column and once a row of each image.
//
// Design against that bound. The first version ran one thread a pixel in
// blocks of a row rounded up to whole warps (one-warp blocks at w = 32),
// each thread computing both axes' terms (~40 operations a pixel) and
// loading 4 u8 taps a channel through L1, each followed by an I2F; 0.0775
// ms at 32x512x512x3. Now:
// - Units. A unit is (image, band of R output rows); a team of R x gw
//   threads owns it, one thread a group of 16 consecutive pixels of a row
//   (gw threads a row, each looping over the row's groups). The host picks
//   R from the shapes: at 512x512 R = 8 (a team is the 256-thread block);
//   where a whole image fits a team (R = h, CIFAR: 64 threads), a block
//   holds several images. Blocks stride over the units: no cap on n or h.
// - Tables. Each unit finds its image's valid columns [xa, xe) and its
//   band's valid rows [ya, ye) (src is monotone in pos; resample::first_true
//   checks a guess at two points), then writes one table entry a valid
//   column into shared memory: the stage offsets of its two taps (16 bits
//   each) and its fraction, 8 bytes, with a spare entry every 16 so that
//   lanes 16 columns apart read distinct banks (16-byte entries 256 bytes
//   apart conflicted 8-way: 0.099 ms at 512x512, slower than the first
//   version). A row's terms are computed once by each of its threads.
// - Stage. The band's source rows [min i0(y), max i1(y)] at columns
//   [min i0(x), max i1(x)] are copied into shared memory as f32, each value
//   converted once (resample::stage_words: aligned 16-byte loads, four in
//   flight a thread, byte loads at row ends, 2^23 | b minus 2^23; a spare
//   word every 16 columns).
//   About R/f + 2 rows: the host's stage holds R + 3 (f >= ~0.85 at R = 8,
//   the sweep's range) or the whole image; a band whose rows need more is
//   cut into sub-bands of halves until each fits (zooms out below ~0.85).
//   Rows that are all fill stage nothing.
// - Compute. Per pixel one 8-byte table load; per value 4 shared loads
//   and the three lerps; trunc is the low byte of v + 2^23 added rounding
//   toward zero (no F2I). Byte permutes pack 4 values a word, and a
//   group's 16c bytes leave as c 16-byte stores where the row is 16-byte
//   aligned, byte by byte at row ends and on unaligned rows. c is a
//   template constant for 1, 3 and 4, with a generic body for the rest.
// - Rows too wide for a stage of two rows and the table in shared memory
//   (w*c above ~27000) run a direct route: the same groups, each pixel's
//   terms computed in the thread and its taps read from device memory.
// - Sizing: the launch reads the kernel's thread and shared-memory limits;
//   3 blocks an SM (at 512x512x3 a block's stage and table take 73 KB).
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; tools/time_resample.py, device
// time by torch.profiler, in turns with the first version in one call):
// 0.0595 ms at 32x512x512x3 on the scale grid 0.9..1.4 (0.0771-0.0777
// before; bound 0.0134, bytes), 0.036 at 4096x32x32x3 (0.081); at factor
// 0.5 for every image 0.060 (0.060-0.062), at 4.0 0.048-0.049 (0.074-0.075).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "resample_common.cuh"

namespace {

using namespace resample;

constexpr int kSpareRows = 3;  // stage rows beyond R: the span of R rows for inv <= ~1.17
constexpr int kStageBatch = 4;  // staging loads in flight a thread
constexpr int kMinBlocks = 3;   // blocks an SM: as many as the 512x512 stages fit

// Column table entries for w columns: entry e at e + (e >> 4), so the 16
// columns apart that neighbouring lanes read lie 17 entries (odd) apart,
// on distinct banks. An entry is (off0 | off1 << 16, fraction): the stage
// offsets of the two taps in a row, below 2^16 on the staged route.
__host__ __device__ __forceinline__ int tab_entries(int w) { return w + (w >> 4) + 1; }

// One axis of one image: src(pos) = inv*(pos + 0.5) + m.
struct Axis {
  float inv, m;
  int dim;
  __device__ __forceinline__ float src(int pos) const {
    return __fadd_rn(__fmul_rn(inv, __fadd_rn((float)pos, 0.5f)), m);
  }
  // clamped taps i0, i1 and the fraction at pos
  __device__ __forceinline__ void taps(int pos, int& i0, int& i1, float& frac) const {
    const float sm = __fsub_rn(src(pos), 0.5f);
    const float s0 = floorf(sm);
    const float last = (float)(dim - 1);
    frac = __fsub_rn(sm, s0);
    // clamped in f32 before the conversion: no int overflow for any factor
    i0 = (int)fminf(fmaxf(s0, 0.0f), last);
    i1 = (int)fminf(fmaxf(__fadd_rn(s0, 1.0f), 0.0f), last);
  }
  // the valid positions [a, e) within [lo, hi): one run, src being monotone
  __device__ __forceinline__ void valid_run(int lo, int hi, int& a, int& e) const {
    const float d = (float)dim;
    const float z0 = __fdividef(-m, inv) - 0.5f;  // src = 0 (a guess: any rounding will do)
    const float zd = __fdividef(d - m, inv) - 0.5f;  // src = dim
    if (inv >= 0.0f) {
      a = first_true(lo, hi, ceilf(z0), [&](int p) { return src(p) >= 0.0f; });
      e = first_true(a, hi, ceilf(zd), [&](int p) { return !(src(p) < d); });
    } else {  // src decreasing (or NaN: nothing valid)
      a = first_true(lo, hi, ceilf(zd), [&](int p) { return src(p) < d; });
      e = first_true(a, hi, ceilf(z0), [&](int p) { return !(src(p) >= 0.0f); });
    }
  }
};

__device__ __forceinline__ Axis axis_of(float inv, int dim) {
  const float half = __fmul_rn((float)dim, 0.5f);  // dim/2, exact
  return {inv, __fsub_rn(half, __fmul_rn(inv, half)), dim};
}

__device__ __forceinline__ float lerp_f32(float a, float b, float f) {
  return __fadd_rn(a, __fmul_rn(f, __fsub_rn(b, a)));
}

__device__ __forceinline__ float u8_f32(uint8_t b) {
  return __fsub_rn(__uint_as_float(0x4B000000u | b), kTwo23);
}

// Unit (image, band) = divmod(unit, nbands); band rows [band*R, +R). A team
// is R rows of gw threads. Its shared region (tstride floats): the column
// table (tab_entries(w) entries of 2 words), then `cap` stage rows, each
// row as long as its unit's column span needs. DIRECT: no table or stage.
template <int C, bool DIRECT>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
zoom_bilinear_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                     const float* __restrict__ factors, long long units, int h, int w, int cc,
                     int R, int nbands, int gw, int cap, int tstride) {
  extern __shared__ float smem_f32[];
  const int c = C > 0 ? C : cc;
  const long long wc = (long long)w * c;
  const int tsize = R * gw;
  const int team = threadIdx.x / tsize, tt = threadIdx.x - team * tsize;
  const int teams = blockDim.x / tsize;
  const int r = tt / gw, gl = tt - r * gw;
  const int ngroups = (w + 15) / 16;
  int2* tab = reinterpret_cast<int2*>(smem_f32 + (size_t)team * tstride);
  float* stage = smem_f32 + (size_t)team * tstride + 2 * (size_t)tab_entries(w);

  for (long long b = (long long)blockIdx.x * teams; b < units;
       b += (long long)gridDim.x * teams) {
    const long long u = b + team;
    const bool active = u < units;
    long long img = 0;
    int yb0 = 0, yb1 = 0, xa = 0, xe = 0, ya = 0, ye = 0, c0 = 0, pitch = 0;
    Axis ax{0.0f, 0.0f, w}, ay{0.0f, 0.0f, h};
    if (active) {
      int band;
      if (units <= UINT_MAX) {
        const unsigned uu = (unsigned)u, q = uu / (unsigned)nbands;
        img = q;
        band = (int)(uu - q * (unsigned)nbands);
      } else {
        img = u / nbands;
        band = (int)(u - img * nbands);
      }
      yb0 = band * R;
      yb1 = yb0 + R < h ? yb0 + R : h;
      const float inv = __fdiv_rn(1.0f, factors[img]);
      ax = axis_of(inv, w);
      ay = axis_of(inv, h);
      ax.valid_run(0, w, xa, xe);
      ay.valid_run(yb0, yb1, ya, ye);
      if (!DIRECT && xa < xe) {
        int i0a, i1a, i0b, i1b;
        float fr;
        ax.taps(xa, i0a, i1a, fr);
        ax.taps(xe - 1, i0b, i1b, fr);
        c0 = min(i0a, i0b);
        const int ncols = max(i1a, i1b) - c0 + 1;
        pitch = slot_off(ncols, c);
        for (int xi = xa + tt; xi < xe; xi += tsize) {
          int i0, i1;
          float fx;
          ax.taps(xi, i0, i1, fx);
          const int e = xi - xa;
          tab[e + (e >> 4)] = make_int2(slot_off(i0 - c0, c) | slot_off(i1 - c0, c) << 16,
                                        __float_as_int(fx));
        }
      }
    }
    const uint8_t* xi_img = x + img * h * wc;
    uint8_t* oi_img = out + img * h * wc;

    // sub-bands of the valid rows [ya, ye) whose source rows fit the stage;
    // one pass when the whole band fits (always with several teams a block:
    // their stage holds the whole image)
    int y = ya;
    bool first = true;
    do {
      int S = ye - y, r0 = 0;
      if (!DIRECT && S > 0) {
        int r1;
        for (;;) {
          int i0a, i1a, i0b, i1b;
          float fr;
          ay.taps(y, i0a, i1a, fr);
          ay.taps(y + S - 1, i0b, i1b, fr);
          r0 = min(i0a, i0b);
          r1 = max(i1a, i1b);
          if (r1 - r0 + 1 <= cap || S == 1) break;
          S = (S + 1) >> 1;
        }
        if (xa < xe) {
          int i0a, i1a, i0b, i1b;
          float fr;
          ax.taps(xa, i0a, i1a, fr);
          ax.taps(xe - 1, i0b, i1b, fr);
          const long long b0 = (long long)c0 * c;
          const long long b1 = (long long)(max(i1a, i1b) + 1) * c;
          const int wpr = (int)((b1 - b0 + 15) >> 4) + 1;  // aligned words a row, at most
          const int nrows = r1 - r0 + 1;
          const float rcp = 1.0f / (float)wpr;
          stage_words<kStageBatch>(tt, tsize, nrows * wpr, wc, b0, b1, b0, c,
                      [&](int k, const uint8_t*& s_, float*& d_, int& kk) {
                        // k / wpr from the reciprocal, corrected by one step
                        int rr = (int)((float)k * rcp);
                        rr -= rr * wpr > k;
                        rr += (rr + 1) * wpr <= k;
                        s_ = xi_img + (long long)(r0 + rr) * wc;
                        d_ = stage + (size_t)rr * pitch;
                        kk = k - rr * wpr;
                      });
        }
      }
      __syncthreads();

      const int yo = yb0 + r;
      const bool row_valid = yo >= ya && yo < ye;
      if (active && yo < yb1 && (row_valid ? (yo >= y && yo < y + S) : first)) {
        int i0y = 0, i1y = 0;
        float fy = 0.0f;
        if (row_valid) ay.taps(yo, i0y, i1y, fy);
        const float* s0 = stage + (size_t)(i0y - r0) * pitch;
        const float* s1 = stage + (size_t)(i1y - r0) * pitch;
        const uint8_t* g0 = xi_img + (long long)i0y * wc;
        const uint8_t* g1 = xi_img + (long long)i1y * wc;
        uint8_t* orow = oi_img + (long long)yo * wc;
        for (int gi = gl; gi < ngroups; gi += gw) {
          const int gx0 = 16 * gi;
          const int npx = w - gx0 < 16 ? w - gx0 : 16;
          uint8_t* dst = orow + (long long)gx0 * c;
          const bool aligned = ((uintptr_t)dst & 15) == 0;
          // pixel p's tap offsets (stage floats, or source pixels) and fraction
          int p = 0, ch = 0, o0 = 0, o1 = 0;
          float fx = 0.0f;
          bool xv = false;
          auto pixel = [&](int pp) {
            const int xi = gx0 + pp;
            xv = row_valid && pp < npx && xi >= xa && xi < xe;
            if (!xv) return;
            if (DIRECT) {
              ax.taps(xi, o0, o1, fx);
              o0 *= c;
              o1 *= c;
            } else {
              const int e = xi - xa;
              const int2 t = tab[e + (e >> 4)];
              o0 = t.x & 0xFFFF;
              o1 = (unsigned)t.x >> 16;
              fx = __int_as_float(t.y);
            }
          };
          auto value = [&]() -> uint32_t {
            float a, bb, cc2, d;
            if (DIRECT) {
              a = u8_f32(g0[o0 + ch]);
              bb = u8_f32(g0[o1 + ch]);
              cc2 = u8_f32(g1[o0 + ch]);
              d = u8_f32(g1[o1 + ch]);
            } else {
              a = s0[o0 + ch];
              bb = s0[o1 + ch];
              cc2 = s1[o0 + ch];
              d = s1[o1 + ch];
            }
            const float top = lerp_f32(a, bb, fx), bot = lerp_f32(cc2, d, fx);
            return trunc_word(lerp_f32(top, bot, fy));
          };
          pixel(0);
          const int nw = C > 0 ? C : c;
#pragma unroll
          for (int wd = 0; wd < nw; ++wd) {
            uint32_t o[4] = {0, 0, 0, 0};
#pragma unroll
            for (int k = 0; k < 16; ++k) {
              if (xv) o[k >> 2] = put_byte(o[k >> 2], value(), k & 3);
              if (++ch == c) {
                ch = 0;
                if (++p < 16) pixel(p);
              }
            }
            store_word(dst, aligned, npx * c, wd, o);
          }
        }
      }
      __syncthreads();  // the stage and the table are rewritten next
      y += S;
      first = false;
    } while (y < ye);
  }
}

template <int C, bool DIRECT>
cudaError_t launch(const uint8_t* x, uint8_t* out, const float* f, int n, int h, int w, int c,
                   int R, int gw, int cap, int teams, long long tstride, cudaStream_t st) {
  const auto kernel = zoom_bilinear_kernel<C, DIRECT>;
  const long long smem = teams * tstride * 4;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int nbands = (h + R - 1) / R;
  const long long units = (long long)n * nbands;
  long long blocks = (units + teams - 1) / teams;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  kernel<<<(unsigned)blocks, teams * R * gw, (size_t)smem, st>>>(
      x, out, f, units, h, w, c, R, nbands, gw, cap, (int)tstride);
  return cudaGetLastError();
}

// The host's geometry from the shapes: gw threads a row (one a 16-pixel
// group, at most a block), R = max_threads / gw rows a band (at most h), a
// stage of R + kSpareRows rows (at least 2, at most h), fewer where shared
// memory is short; the direct route where not even two rows fit.
template <int C>
cudaError_t route(const uint8_t* x, uint8_t* out, const float* f, int n, int h, int w, int c,
                  cudaStream_t st) {
  int max_threads = 0;
  long long max_smem = 0;
  cudaError_t err = limits(zoom_bilinear_kernel<C, false>, &max_threads, &max_smem);
  if (err != cudaSuccess) return err;
  const int ngroups = (w + 15) / 16;
  const int gw = ngroups < max_threads ? ngroups : max_threads;
  int R = max_threads / gw;
  if (R > h) R = h;
  // several teams a block only where a team holds a whole image and its
  // stage every row of it (one pass a band: the block's barriers stay uniform)
  int teams = R == h ? max_threads / (R * gw) : 1;
  int cap = R == h ? h : (R + kSpareRows < h ? R + kSpareRows : h);
  if (cap < 2) cap = 2;
  if (cap > h) cap = h;
  if (cap < h) teams = 1;
  const long long pitch_max = (long long)w * c + (w >> 4) + 1;
  // a team's region starts 8-byte aligned (the table is read as int2)
  auto stride_of = [&](int rows_staged) {
    return (2LL * tab_entries(w) + (long long)rows_staged * pitch_max + 1) / 2 * 2;
  };
  long long tstride = stride_of(cap);
  while (teams > 1 && teams * tstride * 4 > max_smem) teams >>= 1;
  if (teams == 1 && tstride * 4 > max_smem) {
    cap = (int)((max_smem / 4 - 2LL * tab_entries(w)) / pitch_max);  // sub-bands of fewer rows
    tstride = stride_of(cap);
  }
  // not even two rows and the table fit, or offsets past 16 bits: the direct route
  if (cap < (h < 2 ? h : 2) || pitch_max > 0xFFFF) {
    const int t = max_threads / (R * gw);
    return launch<C, true>(x, out, f, n, h, w, c, R, gw, 0, t > 0 ? t : 1, 0, st);
  }
  return launch<C, false>(x, out, f, n, h, w, c, R, gw, cap, teams, tstride, st);
}

}  // namespace

// x: u8 [n, h, w, c]; out: u8 [n, h, w, c]; factors: f32 [n]. Launches on
// `stream`; returns a CUDA error code (0 on success).
extern "C" int zoom_bilinear(const void* x, void* out, const void* factors, int n, int h, int w,
                             int c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* xi = static_cast<const uint8_t*>(x);
  uint8_t* o = static_cast<uint8_t*>(out);
  const float* f = static_cast<const float*>(factors);
  switch (c) {
    case 1: return route<1>(xi, o, f, n, h, w, c, st);
    case 3: return route<3>(xi, o, f, n, h, w, c, st);
    case 4: return route<4>(xi, o, f, n, h, w, c, st);
    default: return route<0>(xi, o, f, n, h, w, c, st);
  }
}
