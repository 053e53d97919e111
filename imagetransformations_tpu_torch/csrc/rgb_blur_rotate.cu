// Per-channel blur -> 3-shear rotation (-> PIL grayscale), NHWC u8 in and
// out, any channel count (grayscale needs 3).
//
// Replaces: imagetransformations_tpu/ops/pallas/megakernel.py _mega_kernel,
// in all its modes:
//   stream=True : f32 throughout, one final quantization: trunc after a
//                 rotation, rint at angle 0, PIL L24 floor with grayscale
//                 (oracle: oracle/fast_warp.fused_stream_chain);
//   stream=False: the reference's per-op u8 semantics: rint after the blur,
//                 trunc after every shear, then PIL L24 grayscale
//                 (oracle: gaussian_blur -> fast_warp.rotate_3shear ->
//                 grayscale_rgb);
//   angle 0     : the shears are skipped (identity rotation), rint.
// Also replaces _mega_traced_kernel (per-image angles): the shifts then
// come per image (stride h / w) and so does the identity flag (stride 1).
// The traced Pallas kernel always shears and picks rint for an angle-0
// image; a shear at angle 0 (k = 0, f = 0) is exact, v + 0*(nbr - v) == v,
// so skipping it for that image gives the same bits.
// The blur runs the Y pass first, then the X pass, per channel, with
// reflect-101 borders and f32 taps.
//
// Bound on the H100: the function must read n*h*w*c u8 and write the same,
// 2*n*h*w*c bytes: ~15 us at 32x512x512x3 over 3.35 TB/s. Its arithmetic,
// ~3*(2p+1)+13 f32 operations a value, none fused, issues at most 33.5e12
// a second (the 67 TFLOP/s f32 peak counts an FMA as two): ~30 us at
// 32x512x512x3 with p = 4. So operations bound it, by about 2x.
//
// Design against that bound: two launches. The blur launch reads each
// channel plane's tile (+ halo) into shared memory once, runs both passes
// there and writes planar f32 scratch [n, c, h, w]. The shear launch
// evaluates pass 3 at each output pixel by gather (8 scratch reads a
// channel, mostly from L1/L2) and quantizes. So it pays a full f32 scratch
// round trip (4 B written + ~4 B read a value against the 2 B the bound
// counts); fusing the shears through shared-memory tiles is later work.

#include "blur_rotate_common.cuh"

namespace {

using itt::kTile;

template <bool STRICT>
__global__ void rgb_blur_kernel(const uint8_t* __restrict__ x,
                                float* __restrict__ blurred,
                                const float* __restrict__ taps, int p, int n,
                                int h, int w, int c) {
  extern __shared__ float smem[];
  const int span = kTile + 2 * p;
  float* in = smem;                       // [span][span]
  float* mid = in + span * span;          // [kTile][span]
  float* tp = mid + span * kTile;         // [2p + 1]
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthreads = blockDim.x * blockDim.y;
  for (int i = tid; i < 2 * p + 1; i += nthreads) tp[i] = taps[i];
  const int x0 = blockIdx.x * kTile, y0 = blockIdx.y * kTile;
  const int planes = n * c;

  for (int plane = blockIdx.z; plane < planes; plane += gridDim.z) {
    const int img = plane / c, ch = plane % c;
    const uint8_t* xi = x + (size_t)img * h * w * c + ch;
    __syncthreads();  // the previous plane's tiles are consumed
    for (int i = tid; i < span * span; i += nthreads) {
      const int yy = itt::reflect101(y0 + i / span - p, h);
      const int xx = itt::reflect101(x0 + i % span - p, w);
      in[i] = (float)xi[((size_t)yy * w + xx) * c];
    }
    __syncthreads();
    itt::first_pass<false>(in, mid, tp, p, tid, nthreads);
    __syncthreads();
    float* out = blurred + (size_t)plane * h * w;
    for (int i = tid; i < kTile * kTile; i += nthreads) {
      const int ty = i / kTile, tx = i % kTile;
      const int yy = y0 + ty, xx = x0 + tx;
      if (yy < h && xx < w) {
        const float v = itt::second_pass<false>(mid, tp, p, ty, tx);
        // taps are positive and sum to 1: no clip needed after rint
        out[yy * w + xx] = STRICT ? rintf(v) : v;
      }
    }
  }
}

// PIL convert('L'): L24 fixed point on f32 values, floored by the int cast.
__device__ __forceinline__ uint8_t l24(float r, float g, float b) {
  const float sum3 = __fadd_rn(__fadd_rn(__fmul_rn(g, 38470.0f), __fmul_rn(r, 19595.0f)),
                               __fmul_rn(b, 7471.0f));
  int q = (int)__fadd_rn(__fmul_rn(sum3, 1.0f / 65536.0f), 0.5f);
  q = q < 0 ? 0 : (q > 255 ? 255 : q);
  return (uint8_t)q;
}

template <bool STRICT>
__global__ void rgb_shear_kernel(const float* __restrict__ blurred,
                                 uint8_t* __restrict__ out,
                                 const int* __restrict__ k1,
                                 const float* __restrict__ f1,
                                 const int* __restrict__ k2,
                                 const float* __restrict__ f2,
                                 int shift_stride_h, int shift_stride_w, int n,
                                 int h, int w, int c, float fill, bool grayscale,
                                 const int* __restrict__ identity,
                                 int identity_stride) {
  const int xx = blockIdx.x * blockDim.x + threadIdx.x;
  const int yy = blockIdx.y * blockDim.y + threadIdx.y;
  if (xx >= w || yy >= h) return;
  for (int img = blockIdx.z; img < n; img += gridDim.z) {
    const itt::Shifts s{k1 + (size_t)img * shift_stride_h, f1 + (size_t)img * shift_stride_h,
                        k2 + (size_t)img * shift_stride_w, f2 + (size_t)img * shift_stride_w};
    const bool ident = identity[(size_t)img * identity_stride] != 0;
    const float* planes = blurred + (size_t)img * c * h * w;
    uint8_t* o = out + (((size_t)img * h + yy) * w + xx) * c;
    float rgb[3];
    for (int ch = 0; ch < c; ++ch) {
      const float* B = planes + (size_t)ch * h * w;
      const float v = ident ? B[yy * w + xx]
                               : itt::shear3<STRICT>(B, yy, xx, h, w, s, fill);
      if (grayscale) {
        rgb[ch] = v;  // c == 3, checked by the caller
      } else if (ident) {
        o[ch] = (uint8_t)fminf(fmaxf(rintf(v), 0.0f), 255.0f);
      } else {
        o[ch] = (uint8_t)itt::trunc_u8(v);
      }
    }
    if (grayscale) o[0] = o[1] = o[2] = l24(rgb[0], rgb[1], rgb[2]);
  }
}

template <bool STRICT>
cudaError_t launch(const void* x, void* scratch, void* out, const void* taps,
                   int p, const void* k1, const void* f1, const void* k2,
                   const void* f2, int shift_stride_h, int shift_stride_w,
                   int n, int h, int w, int c, int fill, bool grayscale,
                   const void* identity, int identity_stride, cudaStream_t st) {
  const size_t smem = sizeof(float) * itt::blur_smem_floats(p);
  cudaError_t err = itt::allow_smem(rgb_blur_kernel<STRICT>, smem);
  if (err != cudaSuccess) return err;
  const int planes = n * c;
  dim3 bblock(itt::kBlurThreadsX, itt::kBlurThreadsY);
  dim3 bgrid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile,
             planes < itt::kMaxGridZ ? planes : itt::kMaxGridZ);
  rgb_blur_kernel<STRICT><<<bgrid, bblock, smem, st>>>(
      static_cast<const uint8_t*>(x), static_cast<float*>(scratch),
      static_cast<const float*>(taps), p, n, h, w, c);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dim3 sblock(itt::kShearThreadsX, itt::kShearThreadsY);
  dim3 sgrid((w + sblock.x - 1) / sblock.x, (h + sblock.y - 1) / sblock.y,
             n < itt::kMaxGridZ ? n : itt::kMaxGridZ);
  rgb_shear_kernel<STRICT><<<sgrid, sblock, 0, st>>>(
      static_cast<const float*>(scratch), static_cast<uint8_t*>(out),
      static_cast<const int*>(k1), static_cast<const float*>(f1),
      static_cast<const int*>(k2), static_cast<const float*>(f2), shift_stride_h,
      shift_stride_w, n, h, w, c, static_cast<float>(fill), grayscale,
      static_cast<const int*>(identity), identity_stride);
  return cudaGetLastError();
}

}  // namespace

// x: u8 [n, h, w, c]; scratch: f32 [n, c, h, w]; out: u8 [n, h, w, c];
// taps: f32 [2p + 1]; k1/f1: [h] and k2/f2: [w] per image, images
// shift_stride_h / shift_stride_w elements apart (0: one set for all).
// strict: per-op u8 quantization (stream=False); grayscale needs c == 3;
// identity: i32 flags, 1 for an image at angle 0 (no shears, rint), one
// per image identity_stride elements apart (0: one flag for all).
// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int rgb_blur_rotate(const void* x, void* scratch, void* out,
                               const void* taps, int p, const void* k1,
                               const void* f1, const void* k2, const void* f2,
                               int shift_stride_h, int shift_stride_w, int n,
                               int h, int w, int c, int fill, int strict,
                               int grayscale, const void* identity,
                               int identity_stride, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (strict) {
    return launch<true>(x, scratch, out, taps, p, k1, f1, k2, f2, shift_stride_h,
                        shift_stride_w, n, h, w, c, fill, grayscale != 0,
                        identity, identity_stride, st);
  }
  return launch<false>(x, scratch, out, taps, p, k1, f1, k2, f2, shift_stride_h,
                       shift_stride_w, n, h, w, c, fill, grayscale != 0,
                       identity, identity_stride, st);
}
