// Pillow's NEAREST rotation with one set of fixed-point coefficients an
// image: NHWC u8 in and out, any channel count, constant fill;
// apply_rotation on u8 images and the PIL-parity rotation of apply_all.
//
// Replaces: imagetransformations_tpu/ops/pallas/rotate_gather.py:76
// _rot_kernel (pil_rotate_nearest_batched, launched at :323), which maps
// output pixels through f32 coordinates. This kernel computes the function
// that kernel's docstring names, Image.rotate(-a, NEAREST), as Pillow does
// (Geometry.c affine_fixed): with the six 16.16 integers a0..a5 of the
// image (computed on the host from Pillow's f64 matrix,
// ops/hopper/rotate_gather.py pil_rotate_coeffs),
//   xx = a2 + y*a1 + x*a0, yy = a5 + y*a4 + x*a3   (wrapping 32-bit)
//   out[y, x] = in[yy >> 16, xx >> 16] where 0 <= xx >> 16 < w and
//               0 <= yy >> 16 < h, else fill.
// Exact at any angle: there is no rounding on this path. Images whose
// corner coordinates reach 32768 (Pillow's check_fixed fails) take
// Pillow's f64 route instead (rotate_nearest_float, below).
// The Pallas kernel builds its gather from two axis passes of log-routed
// rolls (base/residual split, proved by _host_bounds_check over _budgets)
// because Mosaic has no vector gather. None of that is ported.
//
// Bound on the H100 (chip_smoke.py bound_rotate): the function must read
// the source pixels that land inside the output (most of them for the
// reference's +-22.5 degrees) and write n*h*w*c u8: ~14 us at
// 32x512x512x3 over 3.35 TB/s. Its arithmetic is a few integer operations
// a pixel (two adds, two shifts, the window test, the address) and a
// select a value. So bytes bound it.
//
// Design against that bound. The first version ran one thread a pixel in
// (128-pixel chunk, row, image) blocks: one-warp blocks at w = 32, ~25
// instructions of f32 setup a pixel (matrix loads, rounded products,
// floors, conversions), c one-byte stores a pixel, and grid.y = h capped h
// at 65535; 0.0476 ms at 32x512x512x3. Now:
// - Units. A thread takes a unit of P = 16 consecutive output pixels of a
//   row (image, row, group); 256-thread blocks stride over the units, the
//   grid a few waves of the SMs, so nothing caps n or h. At w = 32 a row
//   is 2 units and a block takes 4 whole images: never a one-warp block.
// - Coordinates. A thread computes (xx, yy) once, at its first pixel, then
//   steps a0, a3 a pixel: two integer adds, two shifts and two unsigned
//   compares, Pillow's own loop. Its 16 loads are issued before any store.
// - Loads. Direct gathers through the read-only path. At c = 3 a pixel is
//   one aligned 32-bit load, and a second where it crosses into the next
//   word, joined by a funnel shift (one load a pixel in place of three
//   byte loads). c = 1 reads a byte a pixel; other c a byte a value.
// - Stores. At c = 3 and c = 1 a thread packs its 48 or 16 output bytes in
//   registers (byte permutes) and writes whole 16-byte words where the
//   output is aligned; byte stores only at an odd data_ptr or a row's
//   ragged end. Other c store a byte a value.
// - The f64 route (rotate_nearest_float): one thread a row, Pillow's adds
//   in Pillow's order from row starts the host accumulated; right, not
//   fast, and reached only by widths or heights near 32768.
// Built with -fmad=false like every kernel of the port (the f64 route must
// round each add on its own; the integer route has no rounding to lose).
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; tools/time_rotate.py, the kernel's
// device time by torch.profiler, in turns with other trees in one call), on
// the rotation grid: this mapping 0.0340-0.0367 ms at 32x512x512x3 (bound
// 0.0142, bytes) and 0.0127-0.0129 at 4096x32x32x3 (bound 0.0072), against
// 0.0365-0.0367 and 0.0212-0.0214 for tiles of 16 rows x 128 columns with
// lanes on neighbouring pixels gathered through shared memory, 0.0387-0.0389
// and 0.0168-0.0178 for P = 32, and 0.048 / 0.080 for the first version. A
// route staging each tile's source footprint in shared memory measured
// 0.045 / 0.038 and is not built.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPix = 16;  // consecutive output pixels a thread (48 bytes at c = 3)
constexpr int kWaves = 4;  // grid: waves of resident blocks; blocks loop beyond

// Source pixel coordinate of a 16.16 accumulator: the arithmetic shift.
__device__ __forceinline__ int coord(uint32_t v) { return (int)v >> 16; }

// The 3 bytes at s in the low bytes of a word: the aligned word holding s,
// and the next one where the pixel crosses into it (each load reads a word
// that holds one of the pixel's bytes, so never past the input's end).
__device__ __forceinline__ uint32_t load3(const uint8_t* s) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(s);
  const uint32_t* p = reinterpret_cast<const uint32_t*>(a & ~(uintptr_t)3);
  const uint32_t sh = (uint32_t)(a & 3) * 8;
  const uint32_t lo = __ldg(p);
  const uint32_t hi = sh > 8 ? __ldg(p + 1) : 0u;
  return __funnelshift_r(lo, hi, sh);
}

// Output bytes [0, 16*NW) of a unit from words o: whole 16-byte stores
// where dst is aligned and the bytes lie inside the row (nbytes), else
// byte stores. Unrolled, so o stays in registers.
template <int NW>
__device__ __forceinline__ void store_words(uint8_t* dst, int nbytes, const uint32_t (&o)[4 * NW]) {
  const bool aligned = ((uintptr_t)dst & 15) == 0;
#pragma unroll
  for (int q = 0; q < NW; ++q) {
    if (aligned && 16 * q + 16 <= nbytes) {
      *reinterpret_cast<uint4*>(dst + 16 * q) = make_uint4(o[4 * q], o[4 * q + 1], o[4 * q + 2],
                                                           o[4 * q + 3]);
    } else {
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        if (16 * q + t < nbytes) dst[16 * q + t] = (uint8_t)(o[4 * q + (t >> 2)] >> (8 * (t & 3)));
      }
    }
  }
}

template <int C>
__global__ void __launch_bounds__(kThreads)
rotate_nearest_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                      const int* __restrict__ coeffs, int cstride, long long units, int h, int w,
                      int cc, int fill, int upr) {
  const int c = C > 0 ? C : cc;
  const long long wc = (long long)w * c;
  const uint32_t fill4 = (uint32_t)fill * 0x01010101u;
  for (long long u = (long long)blockIdx.x * blockDim.x + threadIdx.x; u < units;
       u += (long long)gridDim.x * blockDim.x) {
    const long long row = u / upr;  // image * h + y
    const int x0 = kPix * (int)(u - row * upr), np = min(kPix, w - x0);
    const long long img = row / h;
    const uint32_t y = (uint32_t)(row - img * h);
    const int* k = coeffs + img * cstride;
    const uint32_t a0 = (uint32_t)k[0], a1 = (uint32_t)k[1], a2 = (uint32_t)k[2];
    const uint32_t a3 = (uint32_t)k[3], a4 = (uint32_t)k[4], a5 = (uint32_t)k[5];
    uint32_t xx = a2 + y * a1 + (uint32_t)x0 * a0;
    uint32_t yy = a5 + y * a4 + (uint32_t)x0 * a3;
    const uint8_t* src = x + img * h * wc;
    uint8_t* dst = out + row * wc + (long long)x0 * c;
    if (C == 3) {
      uint32_t v[kPix];
#pragma unroll
      for (int j = 0; j < kPix; ++j, xx += a0, yy += a3) {
        const int xi = coord(xx), yi = coord(yy);
        const bool ok = j < np && (unsigned)xi < (unsigned)w && (unsigned)yi < (unsigned)h;
        v[j] = ok ? load3(src + ((long long)yi * w + xi) * 3) : fill4;
      }
      uint32_t o[3 * kPix / 4];  // 4 pixels (a word each) into 3 words
#pragma unroll
      for (int q = 0; q < kPix / 4; ++q) {
        o[3 * q] = __byte_perm(v[4 * q], v[4 * q + 1], 0x4210);
        o[3 * q + 1] = __byte_perm(v[4 * q + 1], v[4 * q + 2], 0x5421);
        o[3 * q + 2] = __byte_perm(v[4 * q + 2], v[4 * q + 3], 0x6542);
      }
      store_words<3 * kPix / 16>(dst, 3 * np, o);
    } else if (C == 1) {
      uint32_t o[kPix / 4] = {};
#pragma unroll
      for (int j = 0; j < kPix; ++j, xx += a0, yy += a3) {
        const int xi = coord(xx), yi = coord(yy);
        const bool ok = j < np && (unsigned)xi < (unsigned)w && (unsigned)yi < (unsigned)h;
        o[j >> 2] |= (ok ? (uint32_t)__ldg(src + (long long)yi * w + xi) : (uint32_t)fill)
                     << (8 * (j & 3));
      }
      store_words<kPix / 16>(dst, np, o);
    } else {
      for (int j = 0; j < np; ++j, xx += a0, yy += a3) {
        const int xi = coord(xx), yi = coord(yy);
        const bool ok = (unsigned)xi < (unsigned)w && (unsigned)yi < (unsigned)h;
        const uint8_t* s = src + ((long long)yi * w + xi) * c;
        for (int ch = 0; ch < c; ++ch) dst[j * c + ch] = ok ? __ldg(s + ch) : (uint8_t)fill;
      }
    }
  }
}

// Pillow's f64 route for the flagged images: one thread a (image, row).
__global__ void __launch_bounds__(128)
rotate_nearest_float_kernel(const uint8_t* __restrict__ x, uint8_t* __restrict__ out,
                            const int* __restrict__ images, const double* __restrict__ rows,
                            const double* __restrict__ steps, long long tasks, int h, int w,
                            int c, int fill) {
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < tasks;
       t += (long long)gridDim.x * blockDim.x) {
    const long long j = t / h;
    const int y = (int)(t - j * h);
    const long long img = images[j];
    double xx = rows[2 * t], yy = rows[2 * t + 1];
    const double sx = steps[2 * j], sy = steps[2 * j + 1];
    const uint8_t* src = x + img * h * (long long)w * c;
    uint8_t* dst = out + (img * h + y) * (long long)w * c;
    for (int xo = 0; xo < w; ++xo) {
      // COORD(v) = v < 0 ? -1 : (int)v lies in [0, dim) exactly where 0 <= v < dim
      if (xx >= 0.0 && xx < (double)w && yy >= 0.0 && yy < (double)h) {
        const uint8_t* s = src + ((long long)(int)yy * w + (int)xx) * c;
        for (int ch = 0; ch < c; ++ch) dst[(long long)xo * c + ch] = s[ch];
      } else {
        for (int ch = 0; ch < c; ++ch) dst[(long long)xo * c + ch] = (uint8_t)fill;
      }
      xx = __dadd_rn(xx, sx);
      yy = __dadd_rn(yy, sy);
    }
  }
}

// The host's geometry: units of kPix pixels, a few waves of resident blocks
// (fewer where the units run out).
template <int C>
cudaError_t launch(const uint8_t* x, uint8_t* out, const int* coeffs, int cstride, int n, int h,
                   int w, int c, int fill, cudaStream_t st) {
  const auto kernel = rotate_nearest_kernel<C>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  }
  if (err != cudaSuccess) return err;
  const int upr = (w + kPix - 1) / kPix;
  const long long units = (long long)n * h * upr;
  long long blocks = (long long)(per_sm > 0 ? per_sm : 1) * sms * kWaves;
  if (blocks > (units + kThreads - 1) / kThreads) blocks = (units + kThreads - 1) / kThreads;
  kernel<<<(unsigned)blocks, kThreads, 0, st>>>(x, out, coeffs, cstride, units, h, w, c, fill,
                                                upr);
  return cudaGetLastError();
}

}  // namespace

// x: u8 [n, h, w, c]; out: u8 [n, h, w, c]; coeffs: int32 a0..a5 of image
// i at coeffs + i * coeff_stride (6, or 0 for one row for the batch); fill
// in [0, 255]. Launches on `stream`; returns a CUDA error code (0 on
// success).
extern "C" int rotate_nearest(const void* x, void* out, const void* coeffs, int coeff_stride,
                              int n, int h, int w, int c, int fill, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* xi = static_cast<const uint8_t*>(x);
  uint8_t* o = static_cast<uint8_t*>(out);
  const int* k = static_cast<const int*>(coeffs);
  switch (c) {
    case 1: return launch<1>(xi, o, k, coeff_stride, n, h, w, c, fill, st);
    case 3: return launch<3>(xi, o, k, coeff_stride, n, h, w, c, fill, st);
    default: return launch<0>(xi, o, k, coeff_stride, n, h, w, c, fill, st);
  }
}

// Pillow's f64 route for m images of the batch: images int32 [m] (their
// indices), rows f64 [m, h, 2] (each row's first x, y coordinate), steps
// f64 [m, 2] (the per-pixel adds m0, m3). Writes those images' outputs
// whole. Returns a CUDA error code (0 on success).
extern "C" int rotate_nearest_float(const void* x, void* out, const void* images,
                                    const void* rows, const void* steps, int m, int h, int w,
                                    int c, int fill, void* stream) {
  const long long tasks = (long long)m * h;
  long long blocks = (tasks + 127) / 128;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  rotate_nearest_float_kernel<<<(unsigned)blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out),
      static_cast<const int*>(images), static_cast<const double*>(rows),
      static_cast<const double*>(steps), tasks, h, w, c, fill);
  return cudaGetLastError();
}
