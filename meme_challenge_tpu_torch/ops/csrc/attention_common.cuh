// Shared device helpers of the fused attention kernels (fused_attention.cu,
// fused_attention_bwd.cu): tile sizes, fp32 staging of float32 / bfloat16
// rows, rounding to the storage type, and the dropout hash.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace attn {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query (or key) rows per block
constexpr int kMaxT = 8;                      // key columns per lane: S ≤ 256
constexpr int kMaxU = 4;                      // output columns per lane: D ≤ 128

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(h[0]);
  const float2 b = __bfloat1622float2(h[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as XLA's convert
}
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// x rounded to T and widened back: the value XLA's astype(T) leaves
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// JAX interpret-mode _hash_bits (meme_challenge_tpu/ops/attention.py:51-65)
__device__ __forceinline__ uint32_t hash_bits(uint32_t idx, uint32_t seed) {
  uint32_t x = idx ^ (seed * 2654435761u);
  x = (x ^ (x >> 16)) * 0x85EBCA6Bu;
  x = (x ^ (x >> 13)) * 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__host__ __device__ __forceinline__ int round32(int s) { return (s + 31) & ~31; }

// Stage rows [0, n_pad) of a [n, D] matrix into shared memory as fp32 with
// row stride `stride`; rows >= n are zero.
template <typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int n, int n_pad,
                                      int D, int stride) {
  const int D4 = D >> 2;
  for (int e = threadIdx.x; e < n_pad * D4; e += blockDim.x) {
    const int r = e / D4, d = (e - r * D4) * 4;
    const float4 val = r < n ? load4(src + (size_t)r * D + d)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(dst + r * stride + d) = val;
  }
}

}  // namespace attn
