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
// where y is not valid. The roll budgets of the Pallas kernels (drange)
// exist only for the TPU's lane rolls; a direct gather needs none.
//
// Bound on the H100: the function must read the source pixels its taps
// touch (all of them for f <= 1, ~1/f^2 of them above) and write n*h*w*c
// u8: at most ~15 us at 32x512x512x3 over 3.35 TB/s. Its arithmetic is ~17
// operations a value (four u8->f32 conversions, three lerps, trunc, clip,
// conversion) plus ~19 an axis coordinate, which the function needs once
// a column and once a row: ~13 us at 33.5e12 a second. So bytes bound it,
// with operations close behind.
//
// Design against that bound: one thread per output pixel, consecutive
// threads on consecutive pixels of a row; each thread computes its own x
// and y coordinate terms (the same for the whole column or row, so
// ~40 operations a pixel are repeated work; the first thing to hoist when
// this kernel is made fast) and loads its four taps per channel through
// L1. No shared memory, no scratch. The grid is (column chunks, rows,
// images).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxGridZ = 65535;  // grid.z cap: blocks stride over the images

struct Axis {
  int i0, i1;  // clamped taps
  float frac;
  bool valid;
};

__device__ __forceinline__ Axis axis_coords(float inv, int pos, int dim) {
  const float half = __fmul_rn((float)dim, 0.5f);  // dim/2, exact
  const float m = __fsub_rn(half, __fmul_rn(inv, half));
  const float src = __fadd_rn(__fmul_rn(inv, __fadd_rn((float)pos, 0.5f)), m);
  const float sm = __fsub_rn(src, 0.5f);
  const float s0 = floorf(sm);
  const float last = (float)(dim - 1);
  Axis a;
  a.frac = __fsub_rn(sm, s0);
  // clamped in f32 before the conversion: no int overflow for any factor
  a.i0 = (int)fminf(fmaxf(s0, 0.0f), last);
  a.i1 = (int)fminf(fmaxf(__fadd_rn(s0, 1.0f), 0.0f), last);
  a.valid = src >= 0.0f && src < (float)dim;
  return a;
}

__device__ __forceinline__ float lerp_f32(float a, float b, float f) {
  return __fadd_rn(a, __fmul_rn(f, __fsub_rn(b, a)));
}

__global__ void zoom_bilinear_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                                     const float* __restrict__ factors, int n, int h, int w,
                                     int c) {
  const int xo = blockIdx.x * blockDim.x + threadIdx.x;
  if (xo >= w) return;
  const int yo = blockIdx.y;
  for (int img = blockIdx.z; img < n; img += gridDim.z) {
    const float inv = __fdiv_rn(1.0f, factors[img]);
    const Axis ax = axis_coords(inv, xo, w);
    const Axis ay = axis_coords(inv, yo, h);
    const uint8_t* base = x + (size_t)img * h * w * c;
    const uint8_t* r0 = base + (size_t)ay.i0 * w * c;
    const uint8_t* r1 = base + (size_t)ay.i1 * w * c;
    uint8_t* dst = out + (((size_t)img * h + yo) * w + xo) * c;
    for (int ch = 0; ch < c; ++ch) {
      uint8_t q = 0;
      if (ay.valid) {
        float top = 0.0f, bot = 0.0f;
        if (ax.valid) {
          top = lerp_f32((float)r0[ax.i0 * c + ch], (float)r0[ax.i1 * c + ch], ax.frac);
          bot = lerp_f32((float)r1[ax.i0 * c + ch], (float)r1[ax.i1 * c + ch], ax.frac);
        }
        const float v = truncf(lerp_f32(top, bot, ay.frac));
        q = (uint8_t)(int)fminf(fmaxf(v, 0.0f), 255.0f);
      }
      dst[ch] = q;
    }
  }
}

}  // namespace

// x: u8 [n, h, w, c]; out: u8 [n, h, w, c]; factors: f32 [n]. Launches on
// `stream`; returns cudaGetLastError() (0 on success). h <= 65535 (grid.y).
extern "C" int zoom_bilinear(const void* x, void* out, const void* factors, int n, int h,
                             int w, int c, void* stream) {
  // a block spans a row (or 128 pixels of it), rounded up to whole warps
  const int threads = w >= kThreads ? kThreads : (w + 31) / 32 * 32;
  dim3 block(threads);
  dim3 grid((w + threads - 1) / threads, h, n < kMaxGridZ ? n : kMaxGridZ);
  zoom_bilinear_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out),
      static_cast<const float*>(factors), n, h, w, c);
  return cudaGetLastError();
}
