// Grayscale-first blur -> 3-shear rotation on one luma plane, NHWC u8 RGB in,
// NHWC u8 (luma replicated to 3 channels) out.
//
// Replaces: imagetransformations_tpu/ops/pallas/megakernel.py
//   _mega_gray1_kernel        (one image per launch step)
//   _mega_gray1_packed_kernel (many small images per slab, h < 128)
//   _mega_traced_gray1_kernel (per-image angles: shifts per image, stride
//                              h / w; its log-routed shifts and group
//                              minima exist only for the TPU's lane rolls)
// All compute the same function; here they are one kernel pair with two
// launch geometries: images_per_block = 1, or P > 1 images looped inside
// each block. The output does not depend on the geometry.
//
// What it computes (oracle: oracle/fast_warp.fused_stream_chain, gray path):
//   exact integer L24 luma (g*38470 + r*19595) + b*7471 -> f32 * 2^-16
//   -> cv2 Gaussian X pass then Y pass (reflect-101, f32 taps)
//   -> three Paeth shears in f32 (fill outside the canvas)
//   -> floor(v + 0.5) through the int cast, replicated to 3 channels.
//
// Bound on the H100 (3.35 TB/s): the function must read n*h*w*3 u8 and
// write the same, 2*n*h*w*3 bytes: ~15 us at 32x512x512x3. Its arithmetic,
// ~3*(2p+1)+20 operations a pixel, none fused, at the unfused f32 issue
// rate of 33.5e12 a second (the 67 TFLOP/s peak counts an FMA as two)
// takes ~12 us there with p = 4, so bytes bound it.
//
// Design against that bound: two launches. The blur launch reads the u8
// input once per tile (+ halo) into shared memory, forms the luma, runs both
// blur passes there and writes an f32 plane [n, h, w] to scratch. The shear
// launch evaluates pass 3 at each output pixel by gather: 2 pass-2 values,
// each from 2 pass-1 values, each from 2 blurred values (8 scratch reads,
// mostly from L1/L2). So it pays a full f32 scratch round trip (4 B written
// + ~4 B read a pixel against the 6 B the bound counts); keeping the
// sheared rows in shared-memory tiles instead is later work.

#include "blur_rotate_common.cuh"

namespace {

using itt::kTile;

__global__ void luma_blur_kernel(const uint8_t* __restrict__ x,
                                 float* __restrict__ blurred,
                                 const float* __restrict__ taps, int p, int n,
                                 int h, int w, int images_per_block) {
  extern __shared__ float smem[];
  const int span = kTile + 2 * p;
  float* in = smem;                       // [span][span]
  float* mid = in + span * span;          // [span][kTile]
  float* tp = mid + span * kTile;         // [2p + 1]
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = tid; i < 2 * p + 1; i += nthreads) tp[i] = taps[i];
  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
  const int groups = (n + images_per_block - 1) / images_per_block;

  for (int g = blockIdx.z; g < groups; g += gridDim.z) {
    for (int j = 0; j < images_per_block; ++j) {
      const int img = g * images_per_block + j;
      if (img >= n) break;  // uniform across the block
      const uint8_t* xi = x + (size_t)img * h * w * 3;
      __syncthreads();  // the previous image's tiles are consumed
      for (int i = tid; i < span * span; i += nthreads) {
        const int yy = itt::reflect101(y0 + i / span - p, h);
        const int xx = itt::reflect101(x0 + i % span - p, w);
        const uint8_t* px = xi + ((size_t)yy * w + xx) * 3;
        const int r = px[0], gg = px[1], b = px[2];
        const int lum = (gg * 38470 + r * 19595) + b * 7471;  // < 2^24: exact
        in[i] = __fmul_rn((float)lum, 1.0f / 65536.0f);
      }
      __syncthreads();
      itt::first_pass<true>(in, mid, tp, p, tid, nthreads);
      __syncthreads();
      float* out = blurred + (size_t)img * h * w;
      for (int i = tid; i < kTile * kTile; i += nthreads) {
        const int ty = i / kTile, tx = i % kTile;
        const int yy = y0 + ty, xx = x0 + tx;
        if (yy < h && xx < w) out[yy * w + xx] = itt::second_pass<true>(mid, tp, p, ty, tx);
      }
    }
  }
}

__global__ void luma_shear_kernel(const float* __restrict__ blurred,
                                  uint8_t* __restrict__ out,
                                  const int* __restrict__ k1,
                                  const float* __restrict__ f1,
                                  const int* __restrict__ k2,
                                  const float* __restrict__ f2,
                                  int shift_stride_h, int shift_stride_w, int n,
                                  int h, int w, float fill,
                                  int images_per_block) {
  const int xx = blockIdx.x * blockDim.x + threadIdx.x;
  const int yy = blockIdx.y * blockDim.y + threadIdx.y;
  if (xx >= w || yy >= h) return;
  const int groups = (n + images_per_block - 1) / images_per_block;
  for (int g = blockIdx.z; g < groups; g += gridDim.z) {
    for (int j = 0; j < images_per_block; ++j) {
      const int img = g * images_per_block + j;
      if (img >= n) break;
      const itt::Shifts s{k1 + (size_t)img * shift_stride_h, f1 + (size_t)img * shift_stride_h,
                          k2 + (size_t)img * shift_stride_w, f2 + (size_t)img * shift_stride_w};
      const float v =
          itt::shear3<false>(blurred + (size_t)img * h * w, yy, xx, h, w, s, fill);
      int q = (int)__fadd_rn(v, 0.5f);  // floor(v + 0.5): v >= 0
      q = q < 0 ? 0 : (q > 255 ? 255 : q);
      uint8_t* o = out + (((size_t)img * h + yy) * w + xx) * 3;
      o[0] = o[1] = o[2] = (uint8_t)q;
    }
  }
}

}  // namespace

// x: u8 [n, h, w, 3]; scratch: f32 [n, h, w]; out: u8 [n, h, w, 3];
// taps: f32 [2p + 1]; k1/f1: [h] and k2/f2: [w] per image, images
// shift_stride_h / shift_stride_w elements apart (0: one set for all).
// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int luma_blur_rotate(const void* x, void* scratch, void* out,
                                const void* taps, int p, const void* k1,
                                const void* f1, const void* k2, const void* f2,
                                int shift_stride_h, int shift_stride_w, int n,
                                int h, int w, int fill, int images_per_block,
                                void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int groups = (n + images_per_block - 1) / images_per_block;
  const int gz = groups < itt::kMaxGridZ ? groups : itt::kMaxGridZ;

  const size_t smem = sizeof(float) * itt::blur_smem_floats(p);
  cudaError_t err = itt::allow_smem(luma_blur_kernel, smem);
  if (err != cudaSuccess) return err;
  dim3 bblock(itt::kBlurThreadsX, itt::kBlurThreadsY);
  dim3 bgrid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile, gz);
  luma_blur_kernel<<<bgrid, bblock, smem, st>>>(
      static_cast<const uint8_t*>(x), static_cast<float*>(scratch),
      static_cast<const float*>(taps), p, n, h, w, images_per_block);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 sblock(itt::kShearThreadsX, itt::kShearThreadsY);
  dim3 sgrid((w + sblock.x - 1) / sblock.x, (h + sblock.y - 1) / sblock.y, gz);
  luma_shear_kernel<<<sgrid, sblock, 0, st>>>(
      static_cast<const float*>(scratch), static_cast<uint8_t*>(out),
      static_cast<const int*>(k1), static_cast<const float*>(f1),
      static_cast<const int*>(k2), static_cast<const float*>(f2), shift_stride_h,
      shift_stride_w, n, h, w, static_cast<float>(fill), images_per_block);
  return cudaGetLastError();
}
