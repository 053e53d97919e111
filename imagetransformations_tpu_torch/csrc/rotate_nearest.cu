// PIL NEAREST rotation with one inverse-map matrix an image: NHWC u8 in and
// out, any channel count, constant fill; apply_rotation and the PIL-parity
// rotation of apply_all.
//
// Replaces: imagetransformations_tpu/ops/pallas/rotate_gather.py:76
// _rot_kernel (pil_rotate_nearest_batched, launched at :323). Its function
// (module docstring and :104-108): with xc = x + 0.5, yc = y + 0.5 and the
// f32 matrix m = rotation_matrix(angle) of the image, each op rounded on
// its own, in this order:
//   xx = floor((m0*xc + m1*yc) + m2), yy = floor((m3*xc + m4*yc) + m5)
//   out = in[yy, xx] where 0 <= xx < w and 0 <= yy < h, else fill.
// The Pallas kernel builds that gather from two axis passes of log-routed
// rolls plus residual selects (base/residual split, A/B buffers, proved by
// _host_bounds_check over _budgets) because Mosaic has no vector gather.
// None of that is ported: a direct gather is the function itself, exact for
// any angle, and needs no routing budget.
//
// Bound on the H100: the function must read the source pixels that land
// inside the output (most of them for the reference's +-22.5 degrees) and
// write n*h*w*c u8: at most ~15 us at 32x512x512x3 over 3.35 TB/s. Its
// arithmetic, ~13 operations a pixel (two adds and a floor a coordinate,
// the four-sided window test, two conversions; the m*xc and m*yc products
// are needed once a column and once a row), issues in ~3 us. So bytes
// bound it.
//
// Design against that bound: one thread per output pixel, consecutive
// threads on consecutive pixels of a row; a thread reads its image's six
// matrix values (broadcast loads), computes the source pixel and copies its
// c bytes, or writes fill. Source reads of a warp fall along a line of
// slope tan(angle) through the image: a few cache lines for small angles.
// No shared memory. The grid is (column chunks, rows, images).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxGridZ = 65535;  // grid.z cap: blocks stride over the images

__global__ void rotate_nearest_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                                      const float* __restrict__ mats, int n, int h, int w,
                                      int c, int fill) {
  const int xo = blockIdx.x * blockDim.x + threadIdx.x;
  if (xo >= w) return;
  const int yo = blockIdx.y;
  const float xc = __fadd_rn((float)xo, 0.5f);
  const float yc = __fadd_rn((float)yo, 0.5f);
  for (int img = blockIdx.z; img < n; img += gridDim.z) {
    const float* m = mats + (size_t)img * 6;
    const float xx = floorf(__fadd_rn(__fadd_rn(__fmul_rn(m[0], xc), __fmul_rn(m[1], yc)), m[2]));
    const float yy = floorf(__fadd_rn(__fadd_rn(__fmul_rn(m[3], xc), __fmul_rn(m[4], yc)), m[5]));
    uint8_t* dst = out + (((size_t)img * h + yo) * w + xo) * c;
    if (xx >= 0.0f && xx < (float)w && yy >= 0.0f && yy < (float)h) {
      const uint8_t* src = x + (((size_t)img * h + (int)yy) * w + (int)xx) * c;
      for (int ch = 0; ch < c; ++ch) dst[ch] = src[ch];
    } else {
      for (int ch = 0; ch < c; ++ch) dst[ch] = (uint8_t)fill;
    }
  }
}

}  // namespace

// x: u8 [n, h, w, c]; out: u8 [n, h, w, c]; mats: f32 [n, 6]; fill in
// [0, 255]. Launches on `stream`; returns cudaGetLastError() (0 on
// success). h <= 65535 (grid.y).
extern "C" int rotate_nearest(const void* x, void* out, const void* mats, int n, int h, int w,
                              int c, int fill, void* stream) {
  // a block spans a row (or 128 pixels of it), rounded up to whole warps
  const int threads = w >= kThreads ? kThreads : (w + 31) / 32 * 32;
  dim3 block(threads);
  dim3 grid((w + threads - 1) / threads, h, n < kMaxGridZ ? n : kMaxGridZ);
  rotate_nearest_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out),
      static_cast<const float*>(mats), n, h, w, c, fill);
  return cudaGetLastError();
}
