// Device helpers of the luma blur -> 3-shear rotation kernel
// (luma_blur_rotate.cu).
//
// Every float add and multiply below goes through the _rn intrinsics, which
// the compiler never contracts into FMAs: each operation rounds on its own,
// as in the numpy oracle and the plain PyTorch versions. That is what makes
// the kernels bit-exact against them. (The build also passes -fmad=false.)
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace itt {

// Output tile of one blur block; the input tile adds a halo of p each side.
constexpr int kTile = 32;
constexpr int kBlurThreadsX = 32;
constexpr int kBlurThreadsY = 8;
constexpr int kShearThreadsX = 32;
constexpr int kShearThreadsY = 8;
// grid.z cap: blocks stride over the remaining images / planes
constexpr int kMaxGridZ = 65535;

__device__ __forceinline__ float lerp_rn(float a, float b, float f) {
  // v + f * (nbr - v): sub, mul, add, each rounded (not torch.lerp's formula)
  return __fadd_rn(a, __fmul_rn(f, __fsub_rn(b, a)));
}

// cv2 BORDER_REFLECT_101 index; exact for i in [-(n-1), 2n-2]. Beyond that
// (halo cells of a ragged edge tile that no output reads) it clamps, so no
// read leaves the image.
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * (n - 1) - i;
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

// Gaussian taps over src[0], src[stride], ..., src[2p*stride]: centre tap
// first, then the mirrored pairs t = 0..p-1 as acc + taps[t] * (lo + hi).
__device__ __forceinline__ float tap_sum(const float* src, int stride,
                                         const float* taps, int p) {
  float acc = __fmul_rn(taps[p], src[p * stride]);
  for (int t = 0; t < p; ++t) {
    acc = __fadd_rn(acc, __fmul_rn(taps[t], __fadd_rn(src[t * stride],
                                                      src[(2 * p - t) * stride])));
  }
  return acc;
}

// Separable blur of one tile held in shared memory.
//   in:  [kTile + 2p rows][kTile + 2p cols], reflect-101 values already in
//   mid: scratch for the first pass
// first_pass() fills mid; second_pass() returns the blurred value at
// output (ty, tx) of the tile. X_FIRST picks the pass order: the luma
// kernel blurs along x first, the per-channel kernel along y first.
template <bool X_FIRST>
__device__ __forceinline__ void first_pass(const float* in, float* mid,
                                           const float* taps, int p, int tid,
                                           int nthreads) {
  const int span = kTile + 2 * p;
  if (X_FIRST) {  // mid: [span rows][kTile cols]
    for (int i = tid; i < span * kTile; i += nthreads) {
      const int ty = i / kTile, tx = i % kTile;
      mid[i] = tap_sum(in + ty * span + tx, 1, taps, p);
    }
  } else {  // mid: [kTile rows][span cols]
    for (int i = tid; i < kTile * span; i += nthreads) {
      const int ty = i / span, tx = i % span;
      mid[i] = tap_sum(in + ty * span + tx, span, taps, p);
    }
  }
}

template <bool X_FIRST>
__device__ __forceinline__ float second_pass(const float* mid, const float* taps,
                                             int p, int ty, int tx) {
  const int span = kTile + 2 * p;
  if (X_FIRST) return tap_sum(mid + ty * kTile + tx, kTile, taps, p);
  return tap_sum(mid + ty * span + tx, 1, taps, p);
}

// Shared-memory floats a blur block needs: input tile, first-pass tile, taps.
__host__ __device__ __forceinline__ int blur_smem_floats(int p) {
  const int span = kTile + 2 * p;
  return span * span + span * kTile + 2 * p + 1;
}

__device__ __forceinline__ float trunc_u8(float v) {
  return fminf(fmaxf(truncf(v), 0.0f), 255.0f);
}

// One image's shear parameters: integer shift k and lerp fraction f per row
// (passes 1 and 3, length h) and per column (pass 2, length w).
struct Shifts {
  const int* k1;
  const float* f1;
  const int* k2;
  const float* f2;
};

// The three Paeth shears evaluated by gather at one output pixel, in the
// original orientation (fast_warp.rotate_3shear / fused_stream_chain):
//   s1[y,x] = lerp(B [y, x+k1[y]],  B [y, x+k1[y]+1],  f1[y])
//   s2[y,x] = lerp(S1[y+k2[x], x],  S1[y+k2[x]+1, x],  f2[x])
//   s3[y,x] = lerp(S2[y, x+k1[y]],  S2[y, x+k1[y]+1],  f1[y])
// where any index outside the h x w canvas reads `fill`. Each intermediate
// is recomputed where it is needed: the arithmetic is deterministic, so a
// recomputed value has the same bits. STRICT truncates to u8 after each
// pass (the reference's per-op quantization); otherwise values stay f32.
template <bool STRICT>
__device__ __forceinline__ float shear1(const float* B, int y, int x, int h,
                                        int w, const Shifts& s, float fill) {
  const int xa = x + s.k1[y];
  const float a = (xa >= 0 && xa < w) ? B[y * w + xa] : fill;
  const float b = (xa + 1 >= 0 && xa + 1 < w) ? B[y * w + xa + 1] : fill;
  const float v = lerp_rn(a, b, s.f1[y]);
  return STRICT ? trunc_u8(v) : v;
}

template <bool STRICT>
__device__ __forceinline__ float shear2(const float* B, int y, int x, int h,
                                        int w, const Shifts& s, float fill) {
  const int ya = y + s.k2[x];
  const float a = (ya >= 0 && ya < h) ? shear1<STRICT>(B, ya, x, h, w, s, fill) : fill;
  const float b =
      (ya + 1 >= 0 && ya + 1 < h) ? shear1<STRICT>(B, ya + 1, x, h, w, s, fill) : fill;
  const float v = lerp_rn(a, b, s.f2[x]);
  return STRICT ? trunc_u8(v) : v;
}

template <bool STRICT>
__device__ __forceinline__ float shear3(const float* B, int y, int x, int h,
                                        int w, const Shifts& s, float fill) {
  const int xa = x + s.k1[y];
  const float a = (xa >= 0 && xa < w) ? shear2<STRICT>(B, y, xa, h, w, s, fill) : fill;
  const float b =
      (xa + 1 >= 0 && xa + 1 < w) ? shear2<STRICT>(B, y, xa + 1, h, w, s, fill) : fill;
  const float v = lerp_rn(a, b, s.f1[y]);
  return STRICT ? trunc_u8(v) : v;
}

// Raise the dynamic shared-memory cap of `kernel` when a block needs more
// than the default 48 KB (large blur radii).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace itt
