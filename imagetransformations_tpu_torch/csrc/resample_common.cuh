// Helpers of the per-image resampling kernels (shear_bicubic.cu,
// zoom_bilinear.cu): exact u8 <-> f32 without conversion instructions, the
// f32 stage's slot layout, a monotone boundary search, 16-byte group stores
// and the launch's shared-memory limit.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace resample {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1 << 20;  // blocks loop over the units beyond this
constexpr float kTwo23 = 8388608.0f;

// f32 value of byte t (0..3) of word v, exactly: 2^23 | b minus 2^23 (a
// byte permute and a subtraction: no I2F, which issues at a fraction of
// the add rate).
__device__ __forceinline__ float byte_f32(uint32_t v, int t) {
  return __fsub_rn(__uint_as_float(__byte_perm(v, 0x4B000000u, 0x7440 + t)), kTwo23);
}

// trunc(v) for v in [0, 255] in the low byte: 2^23 + v added rounding
// toward zero is 2^23 + trunc(v) (no F2I).
__device__ __forceinline__ uint32_t trunc_word(float v) {
  return __float_as_uint(__fadd_rz(v, kTwo23));
}

// The low byte of q put into byte t (0..3) of acc.
__device__ __forceinline__ uint32_t put_byte(uint32_t acc, uint32_t q, int t) {
  return __byte_perm(acc, q, t == 0 ? 0x3214u : t == 1 ? 0x3240u : t == 2 ? 0x3410u : 0x4210u);
}

// Stage offset (floats) of slot q, channel 0, for c channels: one spare
// word every 16 slots, so groups of 16 slots c*16 + 1 words apart (odd)
// fall on distinct banks.
__device__ __forceinline__ int slot_off(int q, int c) { return q * c + (q >> 4); }

// Smallest i in [lo, hi) with pred(i), or hi; pred is false then true. The
// guess is checked at two points first; a binary search runs only when it
// is off (non-finite or huge parameters).
template <typename P>
__device__ __forceinline__ int first_true(int lo, int hi, float guess, P pred) {
  const int e = (int)fminf(fmaxf(guess, (float)lo), (float)hi);  // a NaN guess gives lo
  if ((e == hi || pred(e)) && (e == lo || !pred(e - 1))) return e;
  int a = lo, b = hi;
  while (a < b) {
    const int mid = a + ((b - a) >> 1);
    if (pred(mid)) b = mid; else a = mid + 1;
  }
  return a;
}

// Staging of row bytes [b0, b1) as f32, in the aligned 16-byte words that
// cover them: row byte i goes to dst[r + r / (16c)], r = i - basec >= 0
// (slot_off of its slot plus its channel). A thread issues the loads of
// B words before it converts and stores any (the loads are in flight
// together). Row bytes and stage offsets fit in int.

struct Word {
  long long rel;  // row byte of the word's first byte
  uint32_t v[4];
};

// Word k: an aligned 16-byte load where it lies inside the row (wc bytes at
// src), byte loads where it straddles an end. False past b1.
__device__ __forceinline__ bool load_word(const uint8_t* src, long long wc, long long b0,
                                          long long b1, int k, Word& w) {
  const long long gx = (long long)(uintptr_t)src;
  w.rel = ((gx + b0) & ~15LL) + 16LL * k - gx;
  if (w.rel >= b1) return false;
  if (w.rel >= 0 && w.rel + 16 <= wc) {
    const uint4 q = *reinterpret_cast<const uint4*>(src + w.rel);
    w.v[0] = q.x; w.v[1] = q.y; w.v[2] = q.z; w.v[3] = q.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint32_t word = 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long bi = w.rel + 4 * i + j;
        if (bi >= 0 && bi < wc) word |= (uint32_t)src[bi] << (8 * j);
      }
      w.v[i] = word;
    }
  }
  return true;
}

// The bytes of w inside [b0, b1), converted and stored.
__device__ __forceinline__ void put_word(const Word& w, long long b0, long long b1,
                                         long long basec, int c, float* dst) {
  const int blk = 16 * c;
  const int r0 = (int)(w.rel - basec);
  const int d0 = r0 > 0 ? r0 / blk : 0;
  const int nb = (d0 + 1) * blk - r0;  // first byte of the next block of slots
  float* o = dst + (r0 + d0);
  if (w.rel >= b0 && w.rel + 16 <= b1) {
#pragma unroll
    for (int t = 0; t < 16; ++t) o[t + (t >= nb ? 1 : 0)] = byte_f32(w.v[t >> 2], t & 3);
  } else {
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      if (w.rel + t >= b0 && w.rel + t < b1) {
        o[t + (t >= nb ? 1 : 0)] = byte_f32(w.v[t >> 2], t & 3);
      }
    }
  }
}

// Stage words lane, lane + lanes, ... < nwords. locate(k, src, dst, kk)
// gives word k's source row, its stage row and its index within the row.
template <int B, typename Locate>
__device__ __forceinline__ void stage_words(int lane, int lanes, int nwords, long long wc,
                                            long long b0, long long b1, long long basec, int c,
                                            Locate locate) {
  for (int k0 = lane; k0 < nwords; k0 += lanes * B) {
    Word wd[B];
    float* dst[B];
    bool ok[B];
#pragma unroll
    for (int i = 0; i < B; ++i) {
      const int k = k0 + i * lanes;
      ok[i] = false;
      if (k < nwords) {
        const uint8_t* src;
        int kk;
        locate(k, src, dst[i], kk);
        ok[i] = load_word(src, wc, b0, b1, kk, wd[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < B; ++i) {
      if (ok[i]) put_word(wd[i], b0, b1, basec, c, dst[i]);
    }
  }
}

// Output word `word` (bytes 16*word ..) of a group of `nbytes` bytes at dst:
// one 16-byte store where dst is 16-byte aligned and the word is whole,
// else byte by byte.
__device__ __forceinline__ void store_word(uint8_t* dst, bool aligned, int nbytes, int word,
                                           const uint32_t o[4]) {
  const int i0 = 16 * word;
  if (aligned && i0 + 16 <= nbytes) {
    *reinterpret_cast<uint4*>(dst + i0) = make_uint4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (i0 + k < nbytes) dst[i0 + k] = (uint8_t)(o[k >> 2] >> (8 * (k & 3)));
    }
  }
}

// The kernel's thread limit (at most kThreads) and the dynamic shared
// memory a block of it may opt in to.
template <typename K>
cudaError_t limits(K kernel, int* max_threads, long long* max_smem) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  int dev = 0, optin = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return err;
  *max_threads = attr.maxThreadsPerBlock < kThreads ? attr.maxThreadsPerBlock : kThreads;
  *max_smem = (long long)optin - (long long)attr.sharedSizeBytes;
  return cudaSuccess;
}

}  // namespace resample
