// Fractional row shift with one shift per (image, row): NHWC u8 in and out,
// any channel count; the fast (non-PIL) shear of apply_all.
//
// Replaces: imagetransformations_tpu/ops/pallas/shear.py:446 `kernel`, the
// body of shear_rows_logrouted (launched at :471). Per (image n, row y), in
// f32 with every op rounded on its own:
//   k = floor(s), f = s - k, ki = clamp(k, -b_px, b_px)   (saturation)
//   a = in[x+ki] if 0 <= x+ki < w else fill
//   b = in[x+ki+1] if 0 <= x+ki+1 < w else fill
//   out = trunc(a + f*(b - a)) where -1 <= x+ki <= w-1, else fill.
// x+ki == -1 and x+ki == w-1 lerp against fill (the border fill-lerps). The
// Pallas kernel gets there by a lane-cyclic wrap over a fill-padded
// 128-lane slab and log-routed rolls; worked through, that is exactly the
// bounds-checked gather above, which is what this kernel does.
//
// Bound on the H100: the function must read n*h*w*c u8 (and n*h f32 shifts)
// and write n*h*w*c u8: ~15 us at 32x512x512x3 over 3.35 TB/s. Its
// arithmetic, ~9 operations a value (two u8->f32 conversions, the lerp, the
// trunc and its conversion, the window test) and five a row, none fused,
// issues in ~7 us at 33.5e12 a second. So bytes bound it.
//
// Design against that bound: one thread per output value, consecutive
// threads on consecutive bytes of a row (coalesced stores; the two tap loads
// of a warp fall on a few cache lines). Each thread reads its row's shift
// (one broadcast load a warp) and takes (ki, f) from it: the same two
// instructions in every thread of the row. The grid is (row chunks, rows,
// images): no thread divides to find its row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridZ = 65535;  // grid.z cap: blocks stride over the images

__global__ void shear_rows_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                                  const float* __restrict__ shifts, int n, int h, int w,
                                  int c, int fill, int b_px) {
  const int wc = w * c;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // x * c + channel
  if (i >= wc) return;
  const int xpix = i / c, ch = i - xpix * c;
  const int y = blockIdx.y;
  const float fillf = (float)fill;
  const float bound = (float)b_px;
  for (int img = blockIdx.z; img < n; img += gridDim.z) {
    const size_t row = (size_t)img * h + y;
    const float s = shifts[row];
    const float k = floorf(s);
    const float f = __fsub_rn(s, k);
    const int ki = (int)fminf(fmaxf(k, -bound), bound);
    const int j = xpix + ki;  // source pixel of the left tap
    uint8_t q = (uint8_t)fill;
    if (j >= -1 && j <= w - 1) {
      const uint8_t* src = x + row * wc + ch;
      const float a = j >= 0 ? (float)src[(size_t)j * c] : fillf;
      const float b = j + 1 <= w - 1 ? (float)src[(size_t)(j + 1) * c] : fillf;
      // a + f*(b - a) lies between a and b, both in [0, 255]: no clip
      q = (uint8_t)(int)truncf(__fadd_rn(a, __fmul_rn(f, __fsub_rn(b, a))));
    }
    out[row * wc + i] = q;
  }
}

}  // namespace

// x: u8 [n, h, w, c]; out: u8 [n, h, w, c]; shifts: f32 [n, h]; fill in
// [0, 255]; b_px >= 0 the saturation bound. Launches on `stream`; returns
// cudaGetLastError() (0 on success). h <= 65535 (grid.y).
extern "C" int shear_rows(const void* x, void* out, const void* shifts, int n, int h, int w,
                          int c, int fill, int b_px, void* stream) {
  dim3 block(kThreads);
  dim3 grid((w * c + kThreads - 1) / kThreads, h, n < kMaxGridZ ? n : kMaxGridZ);
  shear_rows_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out),
      static_cast<const float*>(shifts), n, h, w, c, fill, b_px);
  return cudaGetLastError();
}
