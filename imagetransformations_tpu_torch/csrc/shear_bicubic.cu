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
//   xx = (xo + s*yo) + m2, xin = xx - 0.5, x0 = floor(xin), fx = xin - x0
//   taps c_j = v[clamp(x0 + j, 0, w-1)], j = -1..2 (affine_warp._gather)
//   p2 = -c_-1 + c_1, p3 = ((2*(c_-1 - c_0)) + c_1) - c_2,
//   p4 = ((-c_-1 + c_0) - c_1) + c_2
//   out = c_0 + fx*(p2 + fx*(p3 + fx*p4)); <= 0 -> 0, >= 255 -> 255, else
//   trunc; outside 0 <= xx < w: 255.
// PIL's polynomial is the A = -1 cubic, not grid_sample's A = -0.75.
// The log route, chained rolls and the dk clip of the Pallas kernel exist
// only for the TPU's lane rolls; here each thread gathers its taps.
//
// Bound on the H100: the function must read n*h*w*c u8 and write the same,
// 2*n*h*w*c bytes: ~15 us at 32x512x512x3 over 3.35 TB/s. Its arithmetic,
// ~6 f32 operations a pixel for the source coordinate and ~23 a value for
// the taps' conversions, the cubic and the clip, none fused, issues at most
// 33.5e12 a second: ~18 us at 32x512x512x3. So the two bounds are about
// equal, operations slightly ahead.
//
// Design against that bound: one thread per output value, consecutive
// threads on consecutive bytes of a row, so stores are coalesced and the
// four tap loads of a warp fall on a few neighbouring cache lines (one u8
// read a tap through L1, c bytes apart); no shared memory, no scratch. The
// grid is (row chunks, rows, images): no thread divides to find its row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridZ = 65535;  // grid.z cap: blocks stride over the images

__global__ void shear_bicubic_kernel(const uint8_t* __restrict__ x,
                                     uint8_t* __restrict__ out,
                                     const float* __restrict__ factors, int n,
                                     int h, int w, int c) {
  const int wc = w * c;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // x * c + channel
  if (i >= wc) return;
  const int xpix = i / c, ch = i - xpix * c;
  const float xo = __fadd_rn((float)xpix, 0.5f);
  const int y = blockIdx.y;
  const float yo = __fadd_rn((float)y, 0.5f);
  for (int img = blockIdx.z; img < n; img += gridDim.z) {
    const size_t row = (size_t)img * h + y;
    const float s = factors[img];
    const float m2 = -(s > 0.0f ? ceilf(__fmul_rn(s, (float)h)) : 0.0f);
    const float xx = __fadd_rn(__fadd_rn(xo, __fmul_rn(s, yo)), m2);
    uint8_t q = 255;  // white fill outside the source canvas
    if (xx >= 0.0f && xx < (float)w) {
      const float xin = __fsub_rn(xx, 0.5f);
      const float fl = floorf(xin);
      const int x0 = (int)fl;
      const float fx = __fsub_rn(xin, fl);
      const uint8_t* src = x + row * wc + ch;
      float t[4];
      for (int j = 0; j < 4; ++j) {
        int k = x0 + j - 1;
        k = k < 0 ? 0 : (k > w - 1 ? w - 1 : k);
        t[j] = (float)src[(size_t)k * c];
      }
      const float p2 = __fadd_rn(-t[0], t[2]);
      const float p3 = __fsub_rn(__fadd_rn(__fmul_rn(2.0f, __fsub_rn(t[0], t[1])), t[2]), t[3]);
      const float p4 = __fadd_rn(__fsub_rn(__fadd_rn(-t[0], t[1]), t[2]), t[3]);
      const float v = __fadd_rn(
          t[1], __fmul_rn(fx, __fadd_rn(p2, __fmul_rn(fx, __fadd_rn(p3, __fmul_rn(fx, p4))))));
      q = v <= 0.0f ? 0 : (v >= 255.0f ? 255 : (uint8_t)truncf(v));
    }
    out[row * wc + i] = q;
  }
}

}  // namespace

// x: u8 [n, h, w, c]; out: u8 [n, h, w, c]; factors: f32 [n]. Launches on
// `stream`; returns cudaGetLastError() (0 on success).
// h <= 65535 (grid.y).
extern "C" int shear_bicubic(const void* x, void* out, const void* factors, int n,
                             int h, int w, int c, void* stream) {
  dim3 block(kThreads);
  dim3 grid((w * c + kThreads - 1) / kThreads, h, n < kMaxGridZ ? n : kMaxGridZ);
  shear_bicubic_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out),
      static_cast<const float*>(factors), n, h, w, c);
  return cudaGetLastError();
}
