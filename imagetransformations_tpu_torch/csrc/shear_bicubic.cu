// PIL AFFINE BICUBIC shear with one factor an image, white fill, cropped
// back to the input width. NHWC u8 in and out, any channel count.
//
// Replaces: imagetransformations_tpu/ops/pallas/resample.py
// _shear_bicubic_kernel (reached through shear_bicubic_batched), the
// reference's apply_shear (transformation.py:212-226) on its widened canvas,
// cropped to [:, :, :w]. The inverse map is (1, s, m2; 0, 1, 0) with
// m2 = -ceil(s*h) for s > 0, else 0, so the source row is the output row
// and the vertical cubic collapses (fy == 0): each output value is a
// 4-tap horizontal cubic of its own row. In f32, every op rounded on its
// own, in the op order of the JAX kernel and of affine_warp:
//   per row: m2 = -ceil(s*h) (f32), t = s*(y + 0.5)
//   per pixel: xx = ((x + 0.5) + t) + m2, xin = xx - 0.5, x0 = floor(xin),
//   fx = xin - x0
//   taps c_j = v[clamp(x0 + j, 0, w-1)], j = -1..2 (affine_warp._gather)
//   p2 = -c_-1 + c_1, p3 = ((2*(c_-1 - c_0)) + c_1) - c_2,
//   p4 = ((-c_-1 + c_0) - c_1) + c_2
//   out = c_0 + fx*(p2 + fx*(p3 + fx*p4)); <= 0 -> 0, >= 255 -> 255, else
//   trunc; outside 0 <= xx < w: 255.
// PIL's polynomial is the A = -1 cubic, not grid_sample's A = -0.75.
// The log route, chained rolls and the dk clip of the Pallas kernel exist
// only for the TPU's lane rolls; here the taps are read from a staged row.
//
// Bound on the H100 (chip_smoke.py bound_shear_bicubic): the function must
// read the source bytes its valid pixels' taps touch and write n*h*w*c u8;
// its arithmetic is one u8 -> f32 conversion a source value read, ~7
// operations a pixel for the coordinate and ~20 a value for the cubic, the
// clip and the fill, none fused.
//
// Design against that bound. The first version ran one thread a byte: a
// division by c, four clamped u8 loads through L1 each followed by an I2F
// conversion, a truncf and an F2I, one byte stored; 0.155 ms at
// 32x512x512x3, 8x the bound. Now:
// - Units. A unit is (image, row, segment of up to kSegPx pixels); a team
//   of gp threads owns a unit, one thread a group of 16 consecutive pixels,
//   and a block holds kThreads / gp teams (512-pixel rows: 8 a block;
//   CIFAR's 32-pixel rows: 128). Blocks stride over the units: neither n
//   nor h is capped.
// - The valid run. xx is monotone in x (each rounding is), so a segment's
//   valid pixels are one run [xa, xb], which every thread of the team finds
//   from a guess checked at two points (resample::first_true). x0(x) - x is
//   the row's integer shift, kref its value at xa.
// - Stage. The team copies source positions [x0(xa) - 1, x0(xb) + 2] of its
//   row into shared memory as f32, each value converted once
//   (resample::stage_words: aligned 16-byte loads, byte loads at the row's
//   ends, 2^23 | b minus 2^23); positions outside [0, w) hold the edge
//   value, so no tap needs a clamp. Slot q holds position
//   q + px0 + kref - 1, channel ch at slot_off(q) + ch. Segments with no
//   valid pixel stage nothing.
// - Compute. Each thread takes its 16 pixels' coordinates (t and m2 once a
//   row). Where every valid pixel of its group has x0 = x + kref (every
//   group of the rows measured; the fraction still varies along a row) and
//   c is 1, 3 or 4 (template constants), it loads each channel's 19 window
//   values once, at offsets fixed at compile time (slot 16g + j: the spare
//   word every 16 slots puts neighbouring lanes 16c + 1 words apart, on
//   distinct banks), and runs the 16 cubics from registers. Any other
//   group, and any other c, reads 4 taps a value from the stage at computed
//   slots. A team whose shift drifts past the stage's spare slots reads
//   its taps from device memory with the clamps: (x + 0.5) + t rounds to
//   multiples of 64 or more once t nears 2^30 (1x2^20x592 at s = 1024).
// - Output. The clipped value's trunc is the low byte of v + 2^23 added
//   rounding toward zero (no F2I); byte permutes pack 4 values a word, and
//   a group's 16c bytes leave as c 16-byte stores where the row is 16-byte
//   aligned, byte by byte at segment ends and on unaligned rows.
// - Sizing: the launch reads the kernel's thread and shared-memory limits
//   and halves the teams a block until the stages fit. 4 blocks an SM
//   (64 registers): at 512x512x3 a block's 8 stages take 51 KB.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; tools/time_resample.py, device
// time by torch.profiler, in turns with the one-thread-a-byte kernel in one
// call): 0.0487 ms at 32x512x512x3 on the shear grid (0.153 before; bound
// 0.0132, bytes), 0.0347 at 4096x32x32x3 (0.099). Two or four staging
// loads in flight a thread, or 3 blocks an SM, were 2-7% slower at 512x512.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "resample_common.cuh"

namespace {

using namespace resample;

constexpr int kSegPx = 1024;     // longest row segment a team owns
constexpr int kSpareSlots = 16;  // stage slots beyond the window of the last group
// staging loads in flight a thread: 1 at 4 blocks an SM (64 registers) beat
// 2 and 4 words (with 3 or 4 blocks an SM; PERF.md section 5)
constexpr int kStageBatch = 1;
constexpr int kMinBlocks = 4;

// The A = -1 cubic of taps a (c_-1), b (c_0), cc (c_1), d (c_2) at fx,
// clipped, as the word whose low byte is its trunc; 255 where not valid.
__device__ __forceinline__ uint32_t cubic_word(float a, float b, float cc, float d, float fx,
                                               bool valid) {
  const float p2 = __fsub_rn(cc, a);  // -a + cc
  const float p3 = __fsub_rn(__fadd_rn(__fmul_rn(2.0f, __fsub_rn(a, b)), cc), d);
  const float p4 = __fadd_rn(__fsub_rn(__fsub_rn(b, a), cc), d);  // ((-a + b) - cc) + d
  const float v = __fadd_rn(
      b, __fmul_rn(fx, __fadd_rn(p2, __fmul_rn(fx, __fadd_rn(p3, __fmul_rn(fx, p4))))));
  return trunc_word(valid ? fminf(fmaxf(v, 0.0f), 255.0f) : 255.0f);
}

// One unit a team: (row, segment) = divmod(unit, nseg); segment sg covers
// pixels [sg*seg, min(sg*seg + seg, w)). A team's stage holds capq slots
// in `tstride` floats.
template <int C>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
shear_bicubic_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                     const float* __restrict__ factors, long long units, int h, int w, int cc,
                     int seg, int nseg, int gp, int capq, int tstride) {
  extern __shared__ float smem_f32[];
  const int c = C > 0 ? C : cc;
  const long long wc = (long long)w * c;
  const int team = threadIdx.x / gp, g = threadIdx.x - team * gp;
  const int teams = blockDim.x / gp;
  float* st = smem_f32 + (size_t)team * tstride;
  const float wf = (float)w;

  for (long long b = (long long)blockIdx.x * teams; b < units;
       b += (long long)gridDim.x * teams) {
    const long long u = b + team;
    const bool active = u < units;
    long long row = 0;
    int px0 = 0, px1 = 0, kref = 0;
    float t = 0.0f, m2 = 0.0f;
    bool staged = false;
    if (active) {
      int sg, y;
      long long img;
      if (units <= UINT_MAX) {  // 32-bit divisions (a 64-bit one is a long call)
        const unsigned uu = (unsigned)u, r = uu / (unsigned)nseg, im = r / (unsigned)h;
        row = r;
        sg = (int)(uu - r * (unsigned)nseg);
        img = im;
        y = (int)(r - im * (unsigned)h);
      } else {
        row = u / nseg;
        sg = (int)(u - row * nseg);
        img = row / h;
        y = (int)(row - img * h);
      }
      px0 = sg * seg;
      px1 = px0 + seg < w ? px0 + seg : w;
      const float s = factors[img];
      m2 = -(s > 0.0f ? ceilf(__fmul_rn(s, (float)h)) : 0.0f);
      t = __fmul_rn(s, __fadd_rn((float)y, 0.5f));
      auto xx_of = [&](int xi) {
        return __fadd_rn(__fadd_rn(__fadd_rn((float)xi, 0.5f), t), m2);
      };
      const float a = __fadd_rn(t, m2);  // guesses only
      const int xa = first_true(px0, px1, ceilf(__fsub_rn(-0.5f, a)),
                                [&](int xi) { return xx_of(xi) >= 0.0f; });
      const int xb = first_true(xa, px1, ceilf(__fsub_rn(__fsub_rn(wf, 0.5f), a)),
                                [&](int xi) { return !(xx_of(xi) < wf); }) - 1;
      if (xa <= xb) {
        const int x0a = (int)floorf(__fsub_rn(xx_of(xa), 0.5f));
        const int x0b = (int)floorf(__fsub_rn(xx_of(xb), 0.5f));
        kref = x0a - xa;
        // slots [xa - px0, x0b + 3 - px0 - kref]: beyond capq, device memory
        staged = x0b + 3 - px0 - kref < capq;
        if (staged) {
          const int base = px0 + kref - 1;  // position of slot 0
          const int p0 = x0a - 1, p1 = x0b + 2;
          const uint8_t* src = x + row * wc;
          const long long b0 = (long long)(p0 > 0 ? p0 : 0) * c;
          const long long b1 = (long long)((p1 < w - 1 ? p1 : w - 1) + 1) * c;
          const long long gx = (long long)(uintptr_t)src;
          const int nwords = (int)((gx + b1 - ((gx + b0) & ~15LL) + 15) >> 4);
          stage_words<kStageBatch>(g, gp, nwords, wc, b0, b1, (long long)base * c, c,
                      [&](int k, const uint8_t*& s_, float*& d_, int& kk) {
                        s_ = src;
                        d_ = st;
                        kk = k;
                      });
          // edge replication: positions p0..-1 take v[0], w..p1 take v[w-1]
          const int left = p0 < 0 ? -p0 : 0, right = p1 > w - 1 ? p1 - (w - 1) : 0;
          for (int e = g; e < (left + right) * c; e += gp) {
            const int k = e / c, ch = e - k * c;
            const int pos = k < left ? p0 + k : w + (k - left);
            const int edge = pos < 0 ? 0 : w - 1;
            st[slot_off(pos - base, c) + ch] = __fsub_rn(
                __uint_as_float(0x4B000000u | src[(long long)edge * c + ch]), kTwo23);
          }
        }
      }
    }
    __syncthreads();

    const int gx0 = px0 + 16 * g;  // first pixel of this thread's group
    const int npx = px1 - gx0 < 16 ? px1 - gx0 : 16;
    if (active && npx > 0) {
      const float xo0 = __fadd_rn((float)gx0, 0.5f);
      const float ebase = (float)(gx0 + kref);  // x0 of pixel p on the row's shift, less p
      uint8_t* dst = out + row * wc + (long long)gx0 * c;
      const bool aligned = ((uintptr_t)dst & 15) == 0;
      const int nbytes = npx * c;
      const int base = px0 + kref - 1;
      const uint8_t* src = x + row * wc;

      // pixel p: fraction, x0, validity, and whether x0 is on the row's shift
      auto coord = [&](int p, float& fx, int& x0, bool& valid, bool& on_shift) {
        const float xx = __fadd_rn(__fadd_rn(__fadd_rn(xo0, (float)p), t), m2);
        const float xin = __fsub_rn(xx, 0.5f);
        const float fl = floorf(xin);
        fx = __fsub_rn(xin, fl);
        valid = p < npx && xx >= 0.0f && xx < wf;
        on_shift = fl == __fadd_rn(ebase, (float)p);
        x0 = valid ? (int)fl : 0;
      };
      // tap j (-1..2) of a valid pixel at x0, channel ch
      auto tap = [&](int x0, int j, int ch) -> float {
        const int pos = x0 + j;
        if (staged) return st[slot_off(pos - base, c) + ch];
        const int k = pos < 0 ? 0 : (pos > w - 1 ? w - 1 : pos);
        return __fsub_rn(__uint_as_float(0x4B000000u | src[(long long)k * c + ch]), kTwo23);
      };

      bool fast = C > 0 && staged;
      float fxs[16];
      uint32_t vmask = 0;
      if (C > 0) {
#pragma unroll
        for (int p = 0; p < 16; ++p) {
          int x0;
          bool valid, on_shift;
          coord(p, fxs[p], x0, valid, on_shift);
          vmask |= valid ? 1u << p : 0u;
          fast = fast && (!valid || on_shift);
        }
      }
      if (C > 0 && fast) {
        // window: slot 16g + j (j = 0..18) holds position gx0 + kref - 1 + j
        constexpr int CC = C > 0 ? C : 1;
        uint32_t o[4 * CC];
#pragma unroll
        for (int i = 0; i < 4 * CC; ++i) o[i] = 0;
        const float* sw = st + g * (16 * CC + 1);
#pragma unroll
        for (int ch = 0; ch < CC; ++ch) {
          float win[19];
#pragma unroll
          for (int j = 0; j < 19; ++j) win[j] = sw[j * CC + (j >> 4) + ch];
#pragma unroll
          for (int p = 0; p < 16; ++p) {
            const uint32_t q = cubic_word(win[p], win[p + 1], win[p + 2], win[p + 3], fxs[p],
                                          (vmask >> p) & 1u);
            const int i = p * CC + ch;
            o[i >> 2] = put_byte(o[i >> 2], q, i & 3);
          }
        }
#pragma unroll
        for (int wd = 0; wd < CC; ++wd) store_word(dst, aligned, nbytes, wd, &o[4 * wd]);
      } else {
        // value order: byte i of the group is pixel i / c, channel i % c
        int p = 0, ch = 0, x0 = 0;
        float fx = 0.0f;
        bool valid = false, on_shift = false;
        coord(0, fx, x0, valid, on_shift);
#pragma unroll 1
        for (int wd = 0; wd < c; ++wd) {
          uint32_t o[4] = {0, 0, 0, 0};
#pragma unroll
          for (int k = 0; k < 16; ++k) {
            const uint32_t q = valid ? cubic_word(tap(x0, -1, ch), tap(x0, 0, ch), tap(x0, 1, ch),
                                                  tap(x0, 2, ch), fx, true)
                                     : 255u;
            o[k >> 2] = put_byte(o[k >> 2], q, k & 3);
            if (++ch == c) {
              ch = 0;
              if (++p < 16) coord(p, fx, x0, valid, on_shift);
            }
          }
          store_word(dst, aligned, nbytes, wd, o);
        }
      }
    }
    __syncthreads();  // the stage is rewritten next round
  }
}

template <int C>
cudaError_t launch(const uint8_t* x, uint8_t* out, const float* f, int n, int h, int w, int c,
                   cudaStream_t st) {
  const auto kernel = shear_bicubic_kernel<C>;
  int max_threads = 0;
  long long max_smem = 0;
  cudaError_t err = limits(kernel, &max_threads, &max_smem);
  if (err != cudaSuccess) return err;
  const int seg = w < kSegPx ? w : kSegPx;
  const int gp = (seg + 15) / 16;
  if (gp > max_threads) return cudaErrorInvalidValue;
  const long long nseg = (w + seg - 1) / seg;
  const long long units = (long long)n * h * nseg;
  // stage: the window of the last group (16 gp + 3 slots) and spare slots
  // for a shift that changes along the row; the team stride keeps lanes of
  // neighbouring teams 16c + 1 words apart mod 32
  const int capq = 16 * gp + 3 + kSpareSlots;
  long long tstride = (long long)capq * c + (capq >> 4) + 1;
  const long long want = (long long)gp * (16LL * c + 1);
  tstride += ((want - tstride) % 32 + 32) % 32;
  int teams = max_threads / gp;
  while (teams > 1 && teams * tstride * 4 > max_smem) teams >>= 1;
  const long long smem = teams * tstride * 4;
  if (smem > max_smem) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  long long blocks = (units + teams - 1) / teams;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  kernel<<<(unsigned)blocks, teams * gp, (size_t)smem, st>>>(x, out, f, units, h, w, c, seg,
                                                             (int)nseg, gp, capq, (int)tstride);
  return cudaGetLastError();
}

}  // namespace

// x: u8 [n, h, w, c]; out: u8 [n, h, w, c]; factors: f32 [n]. Launches on
// `stream`; returns a CUDA error code (0 on success).
extern "C" int shear_bicubic(const void* x, void* out, const void* factors, int n, int h, int w,
                             int c, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* xi = static_cast<const uint8_t*>(x);
  uint8_t* o = static_cast<uint8_t*>(out);
  const float* f = static_cast<const float*>(factors);
  switch (c) {
    case 1: return launch<1>(xi, o, f, n, h, w, c, st);
    case 3: return launch<3>(xi, o, f, n, h, w, c, st);
    case 4: return launch<4>(xi, o, f, n, h, w, c, st);
    default: return launch<0>(xi, o, f, n, h, w, c, st);
  }
}
