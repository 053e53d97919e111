// cv2 GaussianBlur on NHWC u8 batches: u8 in, u8 out, any h, w and channel
// count.
//
// Replaces: imagetransformations_tpu/ops/pallas/blur.py:36 `_blur_kernel`,
// the body of blur_separable (launched at :126) and blur_to_sheared_rows
// (:175). What it computes (oracle: oracle/stencil.gaussian_blur; plain
// version: ops/stencil.gaussian_blur), per channel, in f32 with every
// operation rounded on its own:
//   vertical pass   v[y]  = sum_t in[reflect(y + t - p)] * taps[t]
//   horizontal pass o[x]  = sum_t v[reflect(x + t - p)] * taps[t]
//   out = clip(rint(o), 0, 255)                     (rint: half to even)
// Each sum runs t = 0..K-1 left to right as acc + x*tap (K = 2p + 1); the
// border is reflect-101 (numpy "reflect"), reflected again as often as p
// needs, so images narrower than the window blur too. The Pallas kernel's
// row tiles of 256, 128-lane padding, double-buffered DMA and XLA fallback
// are TPU layout and have no counterpart: this kernel runs at every shape.
//
// Bound on the H100: the function reads n*h*w*c u8 and writes as many:
// ~15 us at 32x512x512x3 over 3.35 TB/s. Its arithmetic, ~2K+3 operations
// a value (a conversion, K multiplies and K-1 adds a pass, rint, clip, none
// fused) issues in ~29 us there at 33.5e12 a second with K = 9. So
// operations bound it, by about 2x.
//
// Design against that bound: one block a tile of rows x 128 values
// (x * c + channel) of one image, 128 threads. The block stages the u8 tile
// and its halo (p rows above and below, p*c values left and right,
// reflect-101 indices) in shared memory once, runs the vertical pass into an
// f32 shared tile and the horizontal pass from there, and stores u8: each
// input byte is read from device memory about (1 + 2p/rows)(1 + 2pc/128)
// times, each output byte written once, and no intermediate leaves the SM.
// The staged columns' source offsets (the divisions by c and the column
// reflection) are computed once a block; each row's reflection once a row.
// Measured on an H100 80GB HBM3 at 700 W, 32x512x512x3, r 1.5 (PERF.md):
// 0.337 ms, 11.5x the bound; an f32 staged tile (one conversion a value
// instead of one a tap, but 44 KB of shared memory a block) took 0.536 ms
// (tools/time_blur.py).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTileValues = 128;  // output values (x * c + channel) a block row spans
constexpr int kThreads = kTileValues;  // one thread an output column of the tile
constexpr int kMaxGridZ = 65535;  // grid.z cap: blocks stride over the images
constexpr size_t kSmemTarget = 100 * 1024;  // rows a tile shrink until its tile fits
constexpr size_t kSmemMax = 227 * 1024;     // the H100's per-block maximum

// numpy mode="reflect" (cv2 BORDER_REFLECT_101) source index of position i
// of a size-n axis, for any i: reflects again as often as needed.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i >= n ? period - i : i;
}

__host__ __device__ __forceinline__ size_t smem_bytes(int rows, int p, int c) {
  const size_t span = kTileValues + 2 * (size_t)p * c;
  return sizeof(float) * (2 * p + 1)        // taps
         + sizeof(float) * rows * span      // f32 vertical-pass tile
         + sizeof(int) * span               // source offset of each staged column
         + (size_t)(rows + 2 * p) * span;   // u8 input tile with its halo
}

__global__ void blur_separable_kernel(const uint8_t* __restrict__ x,
                                      uint8_t* __restrict__ out,
                                      const float* __restrict__ taps, int p, int n,
                                      int h, int w, int c, int rows) {
  extern __shared__ float smem[];
  const int k = 2 * p + 1;
  const int halo = p * c;                   // values of halo left and right
  const int span = kTileValues + 2 * halo;  // values a staged row holds
  float* tp = smem;                         // [k]
  float* mid = tp + k;                      // [rows][span] f32
  int* colsrc = reinterpret_cast<int*>(mid + (size_t)rows * span);  // [span]
  uint8_t* in = reinterpret_cast<uint8_t*>(colsrc + span);           // [rows + 2p][span]
  const int tid = threadIdx.x;
  const int wc = w * c;
  const int v0 = blockIdx.x * kTileValues;  // first output value of the tile
  const int y0 = blockIdx.y * rows;         // first output row of the tile
  for (int i = tid; i < k; i += kThreads) tp[i] = taps[i];
  // the staged columns' source offsets within a row: the same for every
  // row and image, so the divisions run once a block
  for (int col = tid; col < span; col += kThreads) {
    const int v = v0 + col - halo;  // value index along the row, may be off it
    const int px = v >= 0 ? v / c : -((-v + c - 1) / c);  // floor(v / c)
    colsrc[col] = reflect101(px, w) * c + (v - px * c);
  }

  for (int img = blockIdx.z; img < n; img += gridDim.z) {
    const uint8_t* src = x + (size_t)img * h * wc;
    __syncthreads();  // the previous image's tiles are consumed; colsrc is written
    for (int r = 0; r < rows + 2 * p; ++r) {
      const uint8_t* srow = src + (size_t)reflect101(y0 + r - p, h) * wc;
      for (int col = tid; col < span; col += kThreads) in[r * span + col] = srow[colsrc[col]];
    }
    __syncthreads();
    // vertical pass: acc = in[r] * taps[0], then acc + in[r + t] * taps[t]
    for (int r = 0; r < rows; ++r) {
      for (int col = tid; col < span; col += kThreads) {
        const uint8_t* s = in + r * span + col;
        float acc = __fmul_rn((float)s[0], tp[0]);
        for (int t = 1; t < k; ++t) acc = __fadd_rn(acc, __fmul_rn((float)s[t * span], tp[t]));
        mid[r * span + col] = acc;
      }
    }
    __syncthreads();
    // horizontal pass over the vertical sums, taps c values apart; one
    // output column a thread, so each row's store is one coalesced run
    uint8_t* dst = out + (size_t)img * h * wc;
    const int v = v0 + tid;
    for (int r = 0; r < rows && y0 + r < h; ++r) {
      if (v >= wc) break;
      const float* s = mid + r * span + tid;
      float acc = __fmul_rn(s[0], tp[0]);
      for (int t = 1; t < k; ++t) acc = __fadd_rn(acc, __fmul_rn(s[t * c], tp[t]));
      dst[(size_t)(y0 + r) * wc + v] = (uint8_t)fminf(fmaxf(rintf(acc), 0.0f), 255.0f);
    }
  }
}

}  // namespace

// x: u8 [n, h, w, c]; out: u8 [n, h, w, c]; taps: f32 [2p + 1] summing to 1.
// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue when even a one-row tile of this p and c exceeds the
// shared memory of a block.
extern "C" int blur_separable(const void* x, void* out, const void* taps, int p, int n,
                              int h, int w, int c, void* stream) {
  int rows = 32;
  while (rows > 1 && smem_bytes(rows, p, c) > kSmemTarget) rows /= 2;
  const size_t smem = smem_bytes(rows, p, c);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        blur_separable_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((w * c + kTileValues - 1) / kTileValues, (h + rows - 1) / rows,
            n < kMaxGridZ ? n : kMaxGridZ);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  blur_separable_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out),
      static_cast<const float*>(taps), p, n, h, w, c, rows);
  return cudaGetLastError();
}
