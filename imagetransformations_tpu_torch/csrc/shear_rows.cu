// Fractional row shift: NHWC u8 in and out, any channel count. One kernel
// for three Pallas kernels, which all compute the same bounds-checked
// two-tap gather:
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
// Bound on the H100: the function must read the n*h*w*c u8 source values
// its taps touch (and the f32 shifts) and write n*h*w*c u8: at most ~15 us
// at 32x512x512x3 over 3.35 TB/s. Its arithmetic, ~9 operations a value
// (two u8->f32 conversions, the lerp, the trunc and its conversion, the
// window test) and five a row, none fused, issues in ~7 us at 33.5e12 a
// second. So bytes bound it.
//
// Design against that bound: one thread per output value (per pixel with
// grayscale), consecutive threads on consecutive bytes of a row (coalesced
// stores; the two tap loads of a warp fall on a few cache lines). Each
// thread reads its row's shift (one broadcast load a warp) and takes
// (ki, f) from it: the same two instructions in every thread of the row.
// The grid is (row chunks, rows, images): no thread divides to find its row.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGridZ = 65535;  // grid.z cap: blocks stride over the images

// The shifted value of channel ch at pixel xpix, as an integer in [0, 255].
__device__ __forceinline__ int shifted(const uint8_t* src, int xpix, int ch, int ki, float f,
                                       int w, int c, int fill, float fillf) {
  const int j = xpix + ki;  // source pixel of the left tap
  if (j < -1 || j > w - 1) return fill;
  const float a = j >= 0 ? (float)src[(size_t)j * c + ch] : fillf;
  const float b = j + 1 <= w - 1 ? (float)src[(size_t)(j + 1) * c + ch] : fillf;
  // a + f*(b - a) lies between a and b, both in [0, 255]: no clip
  return (int)truncf(__fadd_rn(a, __fmul_rn(f, __fsub_rn(b, a))));
}

template <bool GRAY>
__global__ void shear_rows_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                                  const float* __restrict__ shifts, int shift_stride, int n,
                                  int h, int w, int c, int fill, int b_px) {
  const int wc = w * c;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;  // value x*c + channel, or pixel
  if (i >= (GRAY ? w : wc)) return;
  const int xpix = GRAY ? i : i / c, ch = GRAY ? 0 : i - xpix * c;
  const int y = blockIdx.y;
  const float fillf = (float)fill;
  const float bound = (float)b_px;
  for (int img = blockIdx.z; img < n; img += gridDim.z) {
    const size_t row = (size_t)img * h + y;
    const float s = shifts[(size_t)img * shift_stride + y];
    const float k = floorf(s);
    const float f = __fsub_rn(s, k);
    const int ki = (int)fminf(fmaxf(k, -bound), bound);
    const uint8_t* src = x + row * wc;
    if (GRAY) {  // c == 3, checked by the caller
      const int r = shifted(src, xpix, 0, ki, f, w, c, fill, fillf);
      const int g = shifted(src, xpix, 1, ki, f, w, c, fill, fillf);
      const int b = shifted(src, xpix, 2, ki, f, w, c, fill, fillf);
      const uint8_t l = (uint8_t)((g * 38470 + r * 19595 + b * 7471 + 32768) >> 16);
      uint8_t* o = out + row * wc + (size_t)xpix * 3;
      o[0] = o[1] = o[2] = l;
    } else {
      out[row * wc + i] = (uint8_t)shifted(src, xpix, ch, ki, f, w, c, fill, fillf);
    }
  }
}

}  // namespace

// x: u8 [n, h, w, c]; out: u8 [n, h, w, c]; shifts: f32, image i's row y at
// i * shift_stride + y (shift_stride 0: one [h] vector for the batch, h:
// [n, h]); fill in [0, 255]; b_px >= 0 the saturation bound; grayscale
// (c == 3): PIL L24 luma of the shifted pixel in all three channels.
// Launches on `stream`; returns cudaGetLastError() (0 on success).
// h <= 65535 (grid.y).
extern "C" int shear_rows(const void* x, void* out, const void* shifts, int shift_stride,
                          int n, int h, int w, int c, int fill, int b_px, int grayscale,
                          void* stream) {
  const int units = grayscale ? w : w * c;
  dim3 block(kThreads);
  dim3 grid((units + kThreads - 1) / kThreads, h, n < kMaxGridZ ? n : kMaxGridZ);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* xi = static_cast<const uint8_t*>(x);
  uint8_t* o = static_cast<uint8_t*>(out);
  const float* s = static_cast<const float*>(shifts);
  if (grayscale) {
    shear_rows_kernel<true><<<grid, block, 0, st>>>(xi, o, s, shift_stride, n, h, w, c, fill,
                                                    b_px);
  } else {
    shear_rows_kernel<false><<<grid, block, 0, st>>>(xi, o, s, shift_stride, n, h, w, c, fill,
                                                     b_px);
  }
  return cudaGetLastError();
}
