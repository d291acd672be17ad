// Fused attention forward for Hopper (sm_90a): out = dropout(softmax(q·kᵀ·scale + bias))·v
//
// Replaces the two Pallas forward kernels of the JAX package:
//   meme_challenge_tpu/ops/attention.py  _fwd_kernel      (per-sample grid, :96-111)
//   meme_challenge_tpu/ops/attention.py  _blk_fwd_kernel  (pair-blocked grid, :265-285)
// Both compute the same function; they differ only in how a (sample, head)
// pair finds its dropout seed and its hash index. Here that is one device body
// with one integer, `seed_group`:
//   pair g = b·H + h, bias row g / H,
//   seed  = seeds[g / seed_group],
//   index = (g mod seed_group)·S·S + i·S + j   (uint32, wrapping).
// Per sample: seed_group = H. Per block: seed_group = blk (_largest_block(B·H)).
//
// Dropout bits are the JAX interpret-mode hash (_hash_bits, attention.py:51-65),
// a murmur3 finalizer over the linear index xor seed·2654435761, so the mask of
// this kernel equals the JAX CPU mask bit for bit. An element is kept iff
// bits >= threshold (threshold = min(int(rate·2³²), 2³²−1)).
//
// Bound at the UNITER-base main path (B 16, H 12, S 160, D 64), from the data
// sheet: q, k, v and out are 4 × 1.97 M elements (31.5 MB fp32, 15.7 MB bf16);
// the two products are 1.26 GFLOP. fp32 on the CUDA cores (67 TFLOP/s): ≈ 19 µs,
// bound by operations. bf16 (989 TFLOP/s on the tensor cores, 3.35 TB/s): ≈ 4.7 µs,
// bound by bytes.
//
// Design: fp32 math on the CUDA cores (the fp32 path must match the plain
// version to 1e-5, so no TF32; bf16 inputs are widened to fp32, which is what
// XLA's bf16 product with fp32 accumulation computes). Tensor cores
// (mma/wgmma) and TMA are later work. One block per (pair, tile of 32 query
// rows), 8 warps; each warp owns 4 query rows end to end, so the softmax
// needs no block-wide barrier:
//   1. K of the pair is staged in shared memory as fp32 (rows padded to D+4
//      floats, so float4 reads by lanes of different keys hit different
//      banks), the Q tile beside it.
//   2. Scores: lane l holds keys l, l+32, ... of the warp's 4 rows in
//      registers (a 4 × S/32 register tile; 9 shared-memory reads per 80
//      FMAs), times scale, plus the key bias.
//   3. Softmax in registers: row max and row sum by warp shuffles, exp(s − m),
//      then a true division by the sum, as attention.py:82-89 does.
//   4. The hash-bit drop test and the fp32 1/(1−rate) scale; p rounded to v's
//      dtype and written to shared memory.
//   5. V replaces K in shared memory; P·V in fp32 (lane owns output columns
//      d, d+32, ...; the 4 rows' p are broadcast reads), rounded to the
//      output dtype.
// Scores and probabilities never leave the SM. Limits: S ≤ 256, D ≤ 128 and
// D a multiple of 4; the wrapper checks them.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
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

template <typename T>
__global__ void __launch_bounds__(kWarps * 32, 2)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ bias,
                const int32_t* __restrict__ seeds, T* __restrict__ out,
                int H, int S, int D, float scale, uint32_t threshold,
                float drop_scale, int use_dropout, int seed_group) {
  extern __shared__ __align__(16) float smem[];
  const int S_pad = round32(S);
  const int n_t = S_pad >> 5;
  const int kstride = D + 4;
  float* kv_s = smem;                       // K [S_pad][D+4], later V [S_pad][D]
  float* q_s = kv_s + S_pad * kstride;      // [kRows][D]
  float* p_s = q_s + kRows * D;             // [kRows][S_pad]

  const int g = blockIdx.x;                 // (sample, head) pair
  const int row0 = blockIdx.y * kRows;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const size_t base = (size_t)g * S * D;

  stage(kv_s, k + base, S, S_pad, D, kstride);
  stage(q_s, q + base + (size_t)row0 * D, min(kRows, S - row0), kRows, D, D);
  __syncthreads();

  // 1-2: scores of the warp's 4 rows; lane owns keys lane + 32 t
  const int r0 = warp * kRowsPerWarp;
  float acc[kRowsPerWarp][kMaxT];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) acc[i][t] = 0.f;
  for (int d = 0; d < D; d += 4) {
    float4 qv[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
      qv[i] = *reinterpret_cast<const float4*>(q_s + (r0 + i) * D + d);
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      if (t < n_t) {
        const float4 kk =
            *reinterpret_cast<const float4*>(kv_s + (lane + 32 * t) * kstride + d);
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          acc[i][t] = fmaf(qv[i].x, kk.x, acc[i][t]);
          acc[i][t] = fmaf(qv[i].y, kk.y, acc[i][t]);
          acc[i][t] = fmaf(qv[i].z, kk.z, acc[i][t]);
          acc[i][t] = fmaf(qv[i].w, kk.w, acc[i][t]);
        }
      }
    }
  }

  // 3-4: softmax, dropout and rounding, row by row, in registers
  const float* bias_row = bias + (size_t)(g / H) * S;
  uint32_t seed = 0, idx_base = 0;
  if (use_dropout) {
    seed = (uint32_t)seeds[g / seed_group];
    idx_base = (uint32_t)(g % seed_group) * ((uint32_t)S * (uint32_t)S);
  }
  float b[kMaxT];
#pragma unroll
  for (int t = 0; t < kMaxT; ++t) {
    const int j = lane + 32 * t;
    b[t] = (t < n_t && j < S) ? bias_row[j] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = row0 + r0 + i;
    float m = -CUDART_INF_F;
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      const int j = lane + 32 * t;
      if (t < n_t && j < S) {
        acc[i][t] = acc[i][t] * scale + b[t];
        m = fmaxf(m, acc[i][t]);
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      const int j = lane + 32 * t;
      if (t < n_t) {
        acc[i][t] = j < S ? expf(acc[i][t] - m) : 0.f;
        sum += acc[i][t];
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const uint32_t row_idx = idx_base + (uint32_t)row * (uint32_t)S;
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      const int j = lane + 32 * t;
      if (t < n_t) {
        float p = acc[i][t] / sum;
        if (use_dropout && j < S) {
          const bool keep = hash_bits(row_idx + (uint32_t)j, seed) >= threshold;
          p = keep ? p * drop_scale : 0.f;
        }
        p_s[(r0 + i) * S_pad + j] = to_f32(from_f32<T>(p));  // 0 for j >= S
      }
    }
  }
  __syncthreads();  // every warp is done with K

  // 5: V replaces K; P·V for the warp's 4 rows, lane owns columns lane + 32 u
  stage(kv_s, v + base, S, S_pad, D, D);
  __syncthreads();
  float o[kRowsPerWarp][kMaxU];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int u = 0; u < kMaxU; ++u) o[i][u] = 0.f;
  for (int j = 0; j < S_pad; j += 4) {
    float4 pv[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
      pv[i] = *reinterpret_cast<const float4*>(p_s + (r0 + i) * S_pad + j);
#pragma unroll
    for (int u = 0; u < kMaxU; ++u) {
      const int c = lane + 32 * u;
      if (c < D) {
        const float v0 = kv_s[j * D + c], v1 = kv_s[(j + 1) * D + c];
        const float v2 = kv_s[(j + 2) * D + c], v3 = kv_s[(j + 3) * D + c];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          o[i][u] = fmaf(pv[i].x, v0, o[i][u]);
          o[i][u] = fmaf(pv[i].y, v1, o[i][u]);
          o[i][u] = fmaf(pv[i].z, v2, o[i][u]);
          o[i][u] = fmaf(pv[i].w, v3, o[i][u]);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = row0 + r0 + i;
    if (row < S) {
#pragma unroll
      for (int u = 0; u < kMaxU; ++u) {
        const int c = lane + 32 * u;
        if (c < D) out[base + (size_t)row * D + c] = from_f32<T>(o[i][u]);
      }
    }
  }
}

size_t smem_bytes(int S, int D) {
  const size_t S_pad = (size_t)round32(S);
  return sizeof(float) * (S_pad * (D + 4) + (size_t)kRows * D + (size_t)kRows * S_pad);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* seeds, void* out, int G, int H, int S, int D,
           float scale, uint32_t threshold, float drop_scale, int use_dropout,
           int seed_group, cudaStream_t stream) {
  if (S < 1 || S > 32 * kMaxT || D < 4 || D > 32 * kMaxU || D % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(S, D);
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(G, (S + kRows - 1) / kRows);
  attn_fwd_kernel<T><<<grid, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), static_cast<const int32_t*>(seeds),
      static_cast<T*>(out), H, S, D, scale, threshold, drop_scale, use_dropout,
      seed_group);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest S and D the kernel takes (D must also be a multiple of 4); a
// launch outside them returns cudaErrorInvalidValue. At those limits a block
// needs 184 KB of shared memory, within Hopper's 227 KB.
int fused_attention_max_s(void) { return 32 * kMaxT; }
int fused_attention_max_d(void) { return 32 * kMaxU; }

// q, k, v, out: [G, S, D] contiguous, 16-byte aligned, G = B·H;
// dtype 0 = float32, 1 = bfloat16. bias: [B, S] float32. seeds: int32, read
// only when use_dropout. Returns cudaGetLastError() after the launch (0 on
// success).
int fused_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                        const void* bias, const void* seeds, void* out, int G,
                        int H, int S, int D, float scale, unsigned int threshold,
                        float drop_scale, int use_dropout, int seed_group,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, bias, seeds, out, G, H, S, D, scale, threshold,
                         drop_scale, use_dropout, seed_group, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, bias, seeds, out, G, H, S, D, scale,
                                 threshold, drop_scale, use_dropout, seed_group, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
