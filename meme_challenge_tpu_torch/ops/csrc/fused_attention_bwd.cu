// Fused attention backward for Hopper (sm_90a): dq, dk, dv of
// out = dropout(softmax(q·kᵀ·scale + bias))·v, given dout.
//
// Replaces the two Pallas backward kernels of the JAX package:
//   meme_challenge_tpu/ops/attention.py  _bwd_kernel      (per-sample grid, :114-155)
//   meme_challenge_tpu/ops/attention.py  _blk_bwd_kernel  (pair-blocked grid, :288-323)
// As in the forward (fused_attention.cu) both are one device body with one
// integer, `seed_group`: pair g = b·H + h reads its bias row g / H, its seed
// seeds[g / seed_group] and hashes index (g mod seed_group)·S² + i·S + j.
// The mask depends only on (g, i, j), so it is regenerated bit for bit by
// any tiling; neither P nor the mask is stored between forward and backward.
//
// Math, step for step as _bwd_kernel (same rounding points):
//   s  = q·kᵀ·scale + bias, p = exp(s − max) / Σ exp(s − max)   (true division)
//   dp = dout·vᵀ; with dropout pd = keep ? p·c : 0, dp = keep ? dp·c : 0
//   dv = round_{dout}(pd)ᵀ·dout
//   ds = round_{q}(p·(dp − Σⱼ dp·p))
//   dq = ds·k·scale, dk = dsᵀ·q·scale; each output rounded to its input's type.
//
// Bound at the UNITER-base main path (B 16, H 12, S 160, D 64), from the data
// sheet: q, k, v, dout read and dq, dk, dv written are 7 × 1.97 M elements
// (55 MB fp32, 27.5 MB bf16); the five products are 3.15 GFLOP. fp32 at fp32
// accuracy is at best three TF32 products (495 / 3 TFLOP/s): ≈ 19 µs, bound
// by operations. bf16 (989 TFLOP/s, 3.35 TB/s): ≈ 8.2 µs, bound by bytes.
//
// Three bodies, routed as the forward (ops/attention.py: attention_route):
//   mma_bf16   (attn_bwd_mma_kernel): bfloat16 with S <= 160, D <= 128 and
//              the block's shared memory (bwd_mma_smem_bytes) within 227 KB —
//              at S 160 that is D <= 80.
//   mma_tf32x3 (attn_bwd_tf32_kernel): float32 with S <= 160, D <= 64.
//   cuda_core  (attn_bwd_dq_kernel + attn_bwd_dkv_kernel): either dtype
//              beyond those (e.g. S 256, or S 160 with D 128).
//
// mma_bf16 body: one launch, one block per pair holding the whole pair in
// shared memory, as the TPU kernel held a sample in VMEM; tensor cores by
// mma.sync m16n8k16 (mma_bf16.cuh). Q, K, V and dout as bf16 [S_pad][D_pad+8]
// (92 KB at S 160, D 64), the bf16 pd and ds tiles [S_pad][S_pad+8] (107 KB)
// and the bias row: 196 KB, one block per SM. S_pad/16 warps (10 at S 160);
// Q and K are one cp.async group, V and dout a second that lands while the
// scores are computed.
//   Phase 1, warp w owns query rows 16w .. 16w+15:
//     s, p = softmax(...) in registers (80 floats a thread at S 160), as the
//     forward; dp = dout·Vᵀ in registers (80 more); the hash mask at
//     (g, i, j), computed once; round_bf16(pd) to shared memory;
//     Δ = Σⱼ dp·p by quad shuffles; ds = round_bf16(p·(dp − Δ)) to shared
//     memory and straight from the accumulators into the A operand of
//     dq = ds·K·scale (K by ldmatrix.trans).
//   __syncthreads.
//   Phase 2, warp w owns key rows 16w .. 16w+15: dv = pdᵀ·dout and
//     dk = dsᵀ·Q·scale, pdᵀ and dsᵀ by ldmatrix.trans of the stored tiles.
// Five products, as the TPU kernel. No workspace, no atomics: the sums run
// in one fixed order, so two calls give the same bits. Padded rows and
// columns are zero in shared memory, keys j >= S get p = 0 (bias −∞), rows
// and keys >= S are not written.
// Registers: p and dp whole are 160 floats a thread, and 10 warps leave a
// thread 168 registers (3 warps share one of the SM's four register files),
// so the main path's instantiation spills 192 bytes a thread. A split that
// computes dp 16 keys at a time, twice (six products, no spill), measured
// 2-3 % slower on the H100 (0.0380 against 0.0372 ms at B 16).
// At S_pad 160 and D_pad 64 a full-tile instantiation has every count and
// stride known at compile time (1.7× faster there than the guarded generic
// one). 192 pairs at B 16 are 1.45 waves of one block per SM; 384 at B 32
// are 2.9.
//
// mma_tf32x3 body: one launch, five products, no atomics, 3×TF32 products
// on mma.sync m16n8k8 (mma_tf32.cuh). The bf16 layout does not carry over:
// Q, K, V and dout whole in fp32 are 174 KB, and p and dp whole in registers
// would leave no room for the split. Instead one block a pair, one warp per
// 16 keys (10 at S 160), and the block walks the queries in chunks of 32:
//   K and V of the pair stay in shared memory (rows of D_pad + 4 floats);
//   the Q and dout chunks are double-buffered by cp.async (146 KB at S 160,
//   D 64: one block an SM).
//   Prologue: each query's max and sum of exp, saved by the forward, and
//     Δ_i = Σ_d dout·out, which in exact arithmetic is Σⱼ dp·p, from the
//     forward's output (its loads all issued before the first sum: done row
//     by row it took a large share of the kernel's cycles).
//   Each chunk, warp w (keys 16w .. 16w+15):
//     Sᵀ = K·Qᵀ and dPᵀ = V·doutᵀ into accumulators with key rows;
//     p = exp(s·scale + bias − max) / sum by the forward's div_rn quotient,
//     the hash mask at (g, i, j), pd and ds = p·(dp − Δ);
//     dV += Pdᵀ·dout and dK += dSᵀ·Q, the accumulator tiles as A operands;
//     dS to shared memory [query][key].
//   __syncthreads; the next chunk but one is issued; dQ = dS·K·scale of the
//   chunk over all keys, a warp per (16 queries, 16 columns), written once.
// The sums run in one fixed order, so two calls give the same bits. Two
// blocks a pair (80 keys each, dQ from a fixed-order two-part sum) measured
// slower at B 16 and B 32 on the H100, and splitting the Q and dout chunks
// into TF32 planes once per block instead of in every warp measured no
// faster. 192 pairs at B 16 are 1.45 waves of one block per SM.
//
// cuda_core body: fp32 math on the CUDA cores, as the forward (no TF32).
// dk and dv sum over every query row of a pair, and Hopper blocks run in no
// order, so instead of the TPU's whole-sample VMEM block this body is two
// launches, with no atomics and a deterministic result:
//   A. attn_bwd_dq_kernel: one block per (pair, tile of 32 query rows), 8 warps
//      of 4 rows, laid out as the forward. It recomputes s and p (K staged),
//      then dp (V staged in K's buffer, the dout tile in Q's), and writes
//      three fp32 row statistics to a [3, G, S] workspace: the row max, the
//      row sum of exp(s − max) and Δ = Σⱼ dp·p. ds goes to shared memory,
//      K is staged once more, and dq = ds·K·scale.
//   B. attn_bwd_dkv_kernel: one block per (pair, tile of 32 keys); each warp
//      owns 4 keys. The K and V tiles stay in shared memory while the block
//      walks the pair's query rows in chunks of 32 (Q and dout chunks staged).
//      Lane i of a warp rebuilds s and dp for query i and the warp's keys,
//      with the same dot order as A, and p from the saved max and sum with
//      the same division, so p equals A's bit for bit; pd and ds go to
//      shared memory, and dv += pdᵀ·dout, dk += dsᵀ·q accumulate in
//      registers (lane owns output columns d, d + 32, ...).
// The two launches do seven products where the TPU kernel did five (s and dp
// are recomputed in B), 1.4× the minimal operations.
// Shared memory at S 160, D 64, fp32 staging: A needs 72 KB (one of K, V at a
// time, rows padded to D + 4 floats, the 32-row tile and the ds tile), as the
// forward, so three blocks fit an SM's 228 KB; B needs 43 KB (K, V, Q and
// dout tiles, pd and ds). Both are launched with __launch_bounds__(256, 2):
// at most 128 registers a thread, two blocks (16 warps) per SM guaranteed.
// Limits: S ≤ 256, D ≤ 128, D a multiple of 4 (A needs 184 KB at the limit).
#include <math_constants.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

using namespace attn;
using bf16 = __nv_bfloat16;

// acc[i][t] = Σ_d rows[r0 + i][d] · keys[lane + 32 t][d], d in order; rows
// has stride D, keys stride kstride (D + 4: float4 reads by lanes of
// different keys hit different banks). The forward's score loop.
__device__ __forceinline__ void row_dots(float (&acc)[kRowsPerWarp][kMaxT],
                                         const float* rows, const float* keys,
                                         int r0, int D, int kstride, int n_t,
                                         int lane) {
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) acc[i][t] = 0.f;
  for (int d = 0; d < D; d += 4) {
    float4 qv[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
      qv[i] = *reinterpret_cast<const float4*>(rows + (r0 + i) * D + d);
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      if (t < n_t) {
        const float4 kk =
            *reinterpret_cast<const float4*>(keys + (lane + 32 * t) * kstride + d);
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
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32, 2)
attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const float* __restrict__ bias,
                   const int32_t* __restrict__ seeds, const T* __restrict__ dout,
                   T* __restrict__ dq, float* __restrict__ stats, int G, int H,
                   int S, int D, float scale, uint32_t threshold,
                   float drop_scale, int use_dropout, int seed_group) {
  extern __shared__ __align__(16) float smem[];
  const int S_pad = round32(S);
  const int n_t = S_pad >> 5;
  const int kstride = D + 4;
  float* kv_s = smem;                       // K [S_pad][D+4], then V, then K
  float* r_s = kv_s + S_pad * kstride;      // Q tile [kRows][D], then dout tile
  float* ds_s = r_s + kRows * D;            // [kRows][S_pad]

  const int g = blockIdx.x;                 // (sample, head) pair
  const int row0 = blockIdx.y * kRows;
  const int n_rows = min(kRows, S - row0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r0 = warp * kRowsPerWarp;
  const size_t base = (size_t)g * S * D;
  float* row_max = stats;
  float* row_sum = stats + (size_t)G * S;
  float* row_delta = stats + 2 * (size_t)G * S;

  stage(kv_s, k + base, S, S_pad, D, kstride);
  stage(r_s, q + base + (size_t)row0 * D, n_rows, kRows, D, D);
  __syncthreads();

  // s, then p in registers; lane owns keys lane + 32 t (the forward's layout)
  float p[kRowsPerWarp][kMaxT];
  row_dots(p, r_s, kv_s, r0, D, kstride, n_t, lane);
  const float* bias_row = bias + (size_t)(g / H) * S;
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
        p[i][t] = p[i][t] * scale + b[t];
        m = fmaxf(m, p[i][t]);
      }
    }
    for (int off = 16; off > 0; off >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      const int j = lane + 32 * t;
      if (t < n_t) {
        p[i][t] = j < S ? expf(p[i][t] - m) : 0.f;
        sum += p[i][t];
      }
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int t = 0; t < kMaxT; ++t)
      if (t < n_t) p[i][t] = p[i][t] / sum;  // 0 for j >= S
    if (lane == 0 && row < S) {
      row_max[(size_t)g * S + row] = m;
      row_sum[(size_t)g * S + row] = sum;
    }
  }
  __syncthreads();  // every warp is done with K and the Q tile

  // dp = dout·vᵀ: V replaces K, the dout tile replaces the Q tile
  stage(kv_s, v + base, S, S_pad, D, kstride);
  stage(r_s, dout + base + (size_t)row0 * D, n_rows, kRows, D, D);
  __syncthreads();
  float dp[kRowsPerWarp][kMaxT];
  row_dots(dp, r_s, kv_s, r0, D, kstride, n_t, lane);
  uint32_t seed = 0, idx_base = 0;
  if (use_dropout) {
    seed = (uint32_t)seeds[g / seed_group];
    idx_base = (uint32_t)(g % seed_group) * ((uint32_t)S * (uint32_t)S);
  }
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int row = row0 + r0 + i;
    const uint32_t row_idx = idx_base + (uint32_t)row * (uint32_t)S;
    float delta = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      const int j = lane + 32 * t;
      if (t < n_t) {
        if (use_dropout && j < S) {
          const bool keep = hash_bits(row_idx + (uint32_t)j, seed) >= threshold;
          dp[i][t] = keep ? dp[i][t] * drop_scale : 0.f;
        }
        delta += dp[i][t] * p[i][t];
      }
    }
    delta = warp_sum(delta);
    if (lane == 0 && row < S) row_delta[(size_t)g * S + row] = delta;
#pragma unroll
    for (int t = 0; t < kMaxT; ++t) {
      const int j = lane + 32 * t;
      if (t < n_t)  // p = 0 beyond S, so ds = 0 there
        ds_s[(r0 + i) * S_pad + j] = round_to<T>(p[i][t] * (dp[i][t] - delta));
    }
  }
  __syncthreads();  // every warp is done with V

  // dq = ds·K·scale: K once more (row stride D), lane owns columns lane + 32 u
  stage(kv_s, k + base, S, S_pad, D, D);
  __syncthreads();
  float o[kRowsPerWarp][kMaxU];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i)
#pragma unroll
    for (int u = 0; u < kMaxU; ++u) o[i][u] = 0.f;
  for (int j = 0; j < S_pad; j += 4) {
    float4 sv[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i)
      sv[i] = *reinterpret_cast<const float4*>(ds_s + (r0 + i) * S_pad + j);
#pragma unroll
    for (int u = 0; u < kMaxU; ++u) {
      const int c = lane + 32 * u;
      if (c < D) {
        const float k0 = kv_s[j * D + c], k1 = kv_s[(j + 1) * D + c];
        const float k2 = kv_s[(j + 2) * D + c], k3 = kv_s[(j + 3) * D + c];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) {
          o[i][u] = fmaf(sv[i].x, k0, o[i][u]);
          o[i][u] = fmaf(sv[i].y, k1, o[i][u]);
          o[i][u] = fmaf(sv[i].z, k2, o[i][u]);
          o[i][u] = fmaf(sv[i].w, k3, o[i][u]);
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
        if (c < D) dq[base + (size_t)row * D + c] = from_f32<T>(o[i][u] * scale);
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32, 2)
attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const float* __restrict__ bias,
                    const int32_t* __restrict__ seeds, const T* __restrict__ dout,
                    const float* __restrict__ stats, T* __restrict__ dk,
                    T* __restrict__ dv, int G, int H, int S, int D, float scale,
                    uint32_t threshold, float drop_scale, int use_dropout,
                    int seed_group) {
  extern __shared__ __align__(16) float smem[];
  const int stride = D + 4;
  float* k_s = smem;                        // K tile [kRows][D+4]
  float* v_s = k_s + kRows * stride;        // V tile
  float* q_s = v_s + kRows * stride;        // Q chunk [32][D+4]
  float* o_s = q_s + 32 * stride;           // dout chunk
  float* pd_s = o_s + 32 * stride;          // [kRows keys][32 queries]
  float* ds_s = pd_s + kRows * 32;

  const int g = blockIdx.x;
  const int col0 = blockIdx.y * kRows;      // first key of the tile
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c0 = warp * kRowsPerWarp;       // the warp's keys, within the tile
  const size_t base = (size_t)g * S * D;
  const float* row_max = stats;
  const float* row_sum = stats + (size_t)G * S;
  const float* row_delta = stats + 2 * (size_t)G * S;

  stage(k_s, k + base + (size_t)col0 * D, min(kRows, S - col0), kRows, D, stride);
  stage(v_s, v + base + (size_t)col0 * D, min(kRows, S - col0), kRows, D, stride);
  const float* bias_row = bias + (size_t)(g / H) * S;
  float bj[kRowsPerWarp];
#pragma unroll
  for (int jj = 0; jj < kRowsPerWarp; ++jj) {
    const int j = col0 + c0 + jj;
    bj[jj] = j < S ? bias_row[j] : 0.f;
  }
  uint32_t seed = 0, idx_base = 0;
  if (use_dropout) {
    seed = (uint32_t)seeds[g / seed_group];
    idx_base = (uint32_t)(g % seed_group) * ((uint32_t)S * (uint32_t)S);
  }
  float acc_v[kRowsPerWarp][kMaxU], acc_k[kRowsPerWarp][kMaxU];
#pragma unroll
  for (int jj = 0; jj < kRowsPerWarp; ++jj)
#pragma unroll
    for (int u = 0; u < kMaxU; ++u) acc_v[jj][u] = acc_k[jj][u] = 0.f;

  for (int i0 = 0; i0 < S; i0 += 32) {
    __syncthreads();  // the previous chunk's Q and dout are read
    const int n_q = min(32, S - i0);
    stage(q_s, q + base + (size_t)i0 * D, n_q, 32, D, stride);
    stage(o_s, dout + base + (size_t)i0 * D, n_q, 32, D, stride);
    __syncthreads();

    // lane's query i = i0 + lane against the warp's 4 keys, same dot order
    // as attn_bwd_dq_kernel (d ascending, one fmaf each)
    float s[kRowsPerWarp], dpv[kRowsPerWarp];
#pragma unroll
    for (int jj = 0; jj < kRowsPerWarp; ++jj) s[jj] = dpv[jj] = 0.f;
    for (int d = 0; d < D; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(q_s + lane * stride + d);
      const float4 ov = *reinterpret_cast<const float4*>(o_s + lane * stride + d);
#pragma unroll
      for (int jj = 0; jj < kRowsPerWarp; ++jj) {
        const float4 kk = *reinterpret_cast<const float4*>(k_s + (c0 + jj) * stride + d);
        const float4 vv = *reinterpret_cast<const float4*>(v_s + (c0 + jj) * stride + d);
        s[jj] = fmaf(qv.x, kk.x, s[jj]);
        s[jj] = fmaf(qv.y, kk.y, s[jj]);
        s[jj] = fmaf(qv.z, kk.z, s[jj]);
        s[jj] = fmaf(qv.w, kk.w, s[jj]);
        dpv[jj] = fmaf(ov.x, vv.x, dpv[jj]);
        dpv[jj] = fmaf(ov.y, vv.y, dpv[jj]);
        dpv[jj] = fmaf(ov.z, vv.z, dpv[jj]);
        dpv[jj] = fmaf(ov.w, vv.w, dpv[jj]);
      }
    }
    const int i = i0 + lane;
    const bool row_ok = i < S;
    const float m = row_ok ? row_max[(size_t)g * S + i] : 0.f;
    const float l = row_ok ? row_sum[(size_t)g * S + i] : 1.f;
    const float delta = row_ok ? row_delta[(size_t)g * S + i] : 0.f;
    const uint32_t row_idx = idx_base + (uint32_t)i * (uint32_t)S;
#pragma unroll
    for (int jj = 0; jj < kRowsPerWarp; ++jj) {
      const int j = col0 + c0 + jj;
      float pd = 0.f, ds = 0.f;
      if (row_ok && j < S) {
        float sv = s[jj] * scale + bj[jj];
        const float p = expf(sv - m) / l;
        float dp = dpv[jj];
        pd = p;
        if (use_dropout) {
          const bool keep = hash_bits(row_idx + (uint32_t)j, seed) >= threshold;
          pd = keep ? p * drop_scale : 0.f;
          dp = keep ? dp * drop_scale : 0.f;
        }
        pd = round_to<T>(pd);
        ds = round_to<T>(p * (dp - delta));
      }
      pd_s[(c0 + jj) * 32 + lane] = pd;
      ds_s[(c0 + jj) * 32 + lane] = ds;
    }
    __syncwarp();

    // dv[j] += Σᵢ pd[j][i]·dout[i], dk[j] += Σᵢ ds[j][i]·q[i]; lane owns
    // columns lane + 32 u, the 4 keys' pd and ds are broadcast reads
    for (int ii = 0; ii < 32; ii += 4) {
      float4 pv[kRowsPerWarp], sv[kRowsPerWarp];
#pragma unroll
      for (int jj = 0; jj < kRowsPerWarp; ++jj) {
        pv[jj] = *reinterpret_cast<const float4*>(pd_s + (c0 + jj) * 32 + ii);
        sv[jj] = *reinterpret_cast<const float4*>(ds_s + (c0 + jj) * 32 + ii);
      }
#pragma unroll
      for (int u = 0; u < kMaxU; ++u) {
        const int c = lane + 32 * u;
        if (c < D) {
          const float o0 = o_s[ii * stride + c], o1 = o_s[(ii + 1) * stride + c];
          const float o2 = o_s[(ii + 2) * stride + c], o3 = o_s[(ii + 3) * stride + c];
          const float q0 = q_s[ii * stride + c], q1 = q_s[(ii + 1) * stride + c];
          const float q2 = q_s[(ii + 2) * stride + c], q3 = q_s[(ii + 3) * stride + c];
#pragma unroll
          for (int jj = 0; jj < kRowsPerWarp; ++jj) {
            acc_v[jj][u] = fmaf(pv[jj].x, o0, acc_v[jj][u]);
            acc_v[jj][u] = fmaf(pv[jj].y, o1, acc_v[jj][u]);
            acc_v[jj][u] = fmaf(pv[jj].z, o2, acc_v[jj][u]);
            acc_v[jj][u] = fmaf(pv[jj].w, o3, acc_v[jj][u]);
            acc_k[jj][u] = fmaf(sv[jj].x, q0, acc_k[jj][u]);
            acc_k[jj][u] = fmaf(sv[jj].y, q1, acc_k[jj][u]);
            acc_k[jj][u] = fmaf(sv[jj].z, q2, acc_k[jj][u]);
            acc_k[jj][u] = fmaf(sv[jj].w, q3, acc_k[jj][u]);
          }
        }
      }
    }
    __syncwarp();  // pd_s and ds_s are rewritten by the next chunk
  }
#pragma unroll
  for (int jj = 0; jj < kRowsPerWarp; ++jj) {
    const int j = col0 + c0 + jj;
    if (j < S) {
#pragma unroll
      for (int u = 0; u < kMaxU; ++u) {
        const int c = lane + 32 * u;
        if (c < D) {
          dk[base + (size_t)j * D + c] = from_f32<T>(acc_k[jj][u] * scale);
          dv[base + (size_t)j * D + c] = from_f32<T>(acc_v[jj][u]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------- mma_bf16

// Q, K, V, dout as bf16 [S_pad][D_pad + 8], pd and ds as bf16
// [S_pad][S_pad + 8], the fp32 bias row [S_pad]
size_t bwd_mma_smem_bytes(int S, int D) {
  const size_t S_pad = mma::pad16(S), ld = mma::pad16(D) + 8;
  return (4 * S_pad * ld + 2 * S_pad * (S_pad + 8)) * sizeof(bf16) +
         S_pad * sizeof(float);
}

// DC: 16-column chunks of D held for the outputs (4: D <= 64, 8: D <= 128).
// kFull: S_pad = 160 and D_pad = 16·DC exactly (the main path), so every
// tile count and row stride is a compile-time constant.
template <int DC, bool kFull>
__global__ void __launch_bounds__(mma::kKeyChunks * 32, 1)
attn_bwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ bias,
                    const int32_t* __restrict__ seeds, const bf16* __restrict__ dout,
                    bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
                    int H, int S, int D, float scale, uint32_t threshold,
                    float drop_scale, int use_dropout, int seed_group) {
  using namespace mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S_pad = kFull ? 16 * kKeyChunks : pad16(S);
  const int D_pad = kFull ? 16 * DC : pad16(D), ld = D_pad + 8, lds = S_pad + 8;
  const int n_kc = S_pad >> 4, n_dc = D_pad >> 4;
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* k_s = q_s + S_pad * ld;
  bf16* v_s = k_s + S_pad * ld;
  bf16* o_s = v_s + S_pad * ld;             // dout
  bf16* pd_s = o_s + S_pad * ld;            // round_bf16(pd) [query][key]
  bf16* ds_s = pd_s + S_pad * lds;          // ds [query][key]
  float* bias_s = reinterpret_cast<float*>(ds_s + S_pad * lds);

  const int g = blockIdx.x;                 // (sample, head) pair
  const int lane = threadIdx.x & 31;
  const int w0 = (threadIdx.x >> 5) * 16;   // the warp's 16 query rows, then keys
  const size_t base = (size_t)g * S * D;
  // Q and K first; V and dout land while the scores and the softmax are computed
  stage_async(q_s, ld, q + base, S, S_pad, D, D_pad);
  stage_async(k_s, ld, k + base, S, S_pad, D, D_pad);
  cp_async_commit();
  stage_async(v_s, ld, v + base, S, S_pad, D, D_pad);
  stage_async(o_s, ld, dout + base, S, S_pad, D, D_pad);
  cp_async_commit();
  stage_bias(bias_s, bias + (size_t)(g / H) * S, S, S_pad);
  cp_async_wait<1>();
  __syncthreads();

  // phase 1: p, dp, the mask, pd, Δ and ds of the warp's query rows, then dq
  float p[2 * kKeyChunks][4];
  softmax_rows<DC>(p, q_s, k_s, ld, bias_s, w0, n_kc, n_dc, scale, lane);
  cp_async_wait<0>();
  __syncthreads();  // V and dout are in shared memory
  uint32_t seed = 0, idx_base = 0;
  if (use_dropout) {
    seed = (uint32_t)seeds[g / seed_group];
    idx_base = (uint32_t)(g % seed_group) * ((uint32_t)S * (uint32_t)S);
  }
  // dp = dout·Vᵀ whole beside p; the mask, pd to shared memory, Δ
  float dp[2 * kKeyChunks][4];
  rows_times_keys<DC>(dp, o_s, v_s, ld, w0, n_kc, n_dc, lane);
  float delta[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 2 * kKeyChunks; ++nt) {
    if (nt < 2 * n_kc) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = w0 + acc_row(lane, 2 * h), j = 8 * nt + acc_col(lane, 2 * h);
        float pd0 = p[nt][2 * h], pd1 = p[nt][2 * h + 1];
        if (use_dropout) {
          const uint32_t idx = idx_base + (uint32_t)i * (uint32_t)S + (uint32_t)j;
          const bool keep0 = hash_bits(idx, seed) >= threshold;
          const bool keep1 = hash_bits(idx + 1u, seed) >= threshold;
          pd0 = keep0 ? pd0 * drop_scale : 0.f;
          pd1 = keep1 ? pd1 * drop_scale : 0.f;
          dp[nt][2 * h] = keep0 ? dp[nt][2 * h] * drop_scale : 0.f;
          dp[nt][2 * h + 1] = keep1 ? dp[nt][2 * h + 1] * drop_scale : 0.f;
        }
        // rows i >= S hold a finite pd against zero dout rows: no effect on dv
        *reinterpret_cast<uint32_t*>(pd_s + i * lds + j) = pack_bf16(pd0, pd1);
        delta[h] += dp[nt][2 * h] * p[nt][2 * h];
        delta[h] += dp[nt][2 * h + 1] * p[nt][2 * h + 1];
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    delta[h] += __shfl_xor_sync(0xffffffffu, delta[h], 1);
    delta[h] += __shfl_xor_sync(0xffffffffu, delta[h], 2);
  }
  // ds = round_bf16(p·(dp − Δ)) to shared memory and into dq = ds·K
  float acc[2 * DC][4];
#pragma unroll
  for (int nt = 0; nt < 2 * DC; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] = 0.f;
#pragma unroll
  for (int kc = 0; kc < kKeyChunks; ++kc) {
    if (kc < n_kc) {
#pragma unroll
      for (int t = 2 * kc; t < 2 * kc + 2; ++t)
#pragma unroll
        for (int r = 0; r < 4; ++r) dp[t][r] = p[t][r] * (dp[t][r] - delta[r >> 1]);
      uint32_t a[4];
      a_from_acc(a, dp[2 * kc], dp[2 * kc + 1]);   // ds rounded to bf16
      store_a(ds_s, lds, w0, 16 * kc, a, lane);
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        if (dc < n_dc) {
          uint32_t b[2][2];
          load_b2_trans(b, k_s, ld, 16 * kc, 16 * dc, lane);
          mma_bf16(acc[2 * dc], a, b[0]);
          mma_bf16(acc[2 * dc + 1], a, b[1]);
        }
      }
    }
  }
  store_rows(dq + base, acc, w0, S, D, scale, lane);
  __syncthreads();  // every warp's pd and ds rows are in shared memory

  // phase 2: dv = pdᵀ·dout and dk = dsᵀ·Q·scale of the warp's keys
  float acc_v[2 * DC][4];
#pragma unroll
  for (int nt = 0; nt < 2 * DC; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc_v[nt][r] = acc[nt][r] = 0.f;
#pragma unroll
  for (int qc = 0; qc < kKeyChunks; ++qc) {
    if (qc < n_kc) {
      uint32_t a[4], b[2][2];
      load_a_trans(a, pd_s, lds, w0, 16 * qc, lane);
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        if (dc < n_dc) {
          load_b2_trans(b, o_s, ld, 16 * qc, 16 * dc, lane);
          mma_bf16(acc_v[2 * dc], a, b[0]);
          mma_bf16(acc_v[2 * dc + 1], a, b[1]);
        }
      }
      load_a_trans(a, ds_s, lds, w0, 16 * qc, lane);
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        if (dc < n_dc) {
          load_b2_trans(b, q_s, ld, 16 * qc, 16 * dc, lane);
          mma_bf16(acc[2 * dc], a, b[0]);
          mma_bf16(acc[2 * dc + 1], a, b[1]);
        }
      }
    }
  }
  store_rows(dv + base, acc_v, w0, S, D, 1.f, lane);
  store_rows(dk + base, acc, w0, S, D, scale, lane);
}

template <int DC, bool kFull>
int launch_mma_dc(const void* q, const void* k, const void* v, const void* bias,
                  const void* seeds, const void* dout, void* dq, void* dk, void* dv,
                  int G, int H, int S, int D, float scale, uint32_t threshold,
                  float drop_scale, int use_dropout, int seed_group,
                  cudaStream_t stream) {
  const size_t smem = bwd_mma_smem_bytes(S, D);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_mma_kernel<DC, kFull>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_mma_kernel<DC, kFull><<<G, 32 * (mma::pad16(S) >> 4), smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<const int32_t*>(seeds), static_cast<const bf16*>(dout),
      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, S, D,
      scale, threshold, drop_scale, use_dropout, seed_group);
  return (int)cudaGetLastError();
}

size_t dq_smem_bytes(int S, int D) {
  const size_t S_pad = (size_t)round32(S);
  return sizeof(float) * (S_pad * (D + 4) + (size_t)kRows * D + (size_t)kRows * S_pad);
}

size_t dkv_smem_bytes(int D) {
  return sizeof(float) * ((size_t)4 * kRows * (D + 4) + (size_t)2 * kRows * 32);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* seeds, const void* dout, void* dq, void* dk, void* dv,
           void* stats, int G, int H, int S, int D, float scale,
           uint32_t threshold, float drop_scale, int use_dropout, int seed_group,
           cudaStream_t stream) {
  if (S < 1 || S > 32 * kMaxT || D < 4 || D > 32 * kMaxU || D % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem_a = dq_smem_bytes(S, D), smem_b = dkv_smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_a);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      attn_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_b);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(G, (S + kRows - 1) / kRows);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(dout);
  const float* bt = static_cast<const float*>(bias);
  const int32_t* st = static_cast<const int32_t*>(seeds);
  float* ws = static_cast<float*>(stats);
  attn_bwd_dq_kernel<T><<<grid, kWarps * 32, smem_a, stream>>>(
      qt, kt, vt, bt, st, ot, static_cast<T*>(dq), ws, G, H, S, D, scale,
      threshold, drop_scale, use_dropout, seed_group);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkv_kernel<T><<<grid, kWarps * 32, smem_b, stream>>>(
      qt, kt, vt, bt, st, ot, ws, static_cast<T*>(dk), static_cast<T*>(dv), G,
      H, S, D, scale, threshold, drop_scale, use_dropout, seed_group);
  return (int)cudaGetLastError();
}

// -------------------------------------------------------------- mma_tf32x3

constexpr int kChunk = 32;     // query rows a block takes a step
constexpr int kTf32MaxD = 64;  // dk and dv of 16 keys × D_pad in registers

// K and V of the pair and two stages of the Q and dout chunks as fp32 rows
// of D_pad + 4, the dS chunk [kChunk][S_pad + 8], and five fp32 rows [S_pad]:
// the key bias, each query's max, sum of exp, its reciprocal and Δ
size_t bwd_tf32_smem_bytes(int S, int D) {
  const size_t S_pad = mma::pad16(S), ld = mma::pad16(D) + 4;
  return ((2 * S_pad + 4 * kChunk) * ld + kChunk * (S_pad + 8) + 5 * S_pad) *
         sizeof(float);
}

// kFull: S_pad = 160 and D_pad = 64 exactly (the main path): every count and
// stride is a compile-time constant, and every chunk has 32 queries.
template <bool kFull>
__global__ void __launch_bounds__(mma::kKeyChunks * 32, 1)
attn_bwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     const int32_t* __restrict__ seeds, const float* __restrict__ dout,
                     const float* __restrict__ out, const float* __restrict__ stats,
                     float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                     int G, int H, int S, int D, float scale, uint32_t threshold,
                     float drop_scale, int use_dropout, int seed_group) {
  using namespace mma;
  constexpr int DC = kTf32MaxD / 16;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S_pad = kFull ? 16 * kKeyChunks : pad16(S);
  const int D_pad = kFull ? kTf32MaxD : pad16(D), ld = D_pad + 4, lds = S_pad + 8;
  const int n_kc = S_pad >> 4, n_dc = D_pad >> 4;
  const int n_warps = n_kc;                 // one warp per 16 keys
  const int n_chunks = (S_pad + kChunk - 1) / kChunk;
  float* k_s = reinterpret_cast<float*>(smem_raw);
  float* v_s = k_s + S_pad * ld;
  float* qc_s = v_s + S_pad * ld;           // Q chunks [2][kChunk][ld]
  float* oc_s = qc_s + 2 * kChunk * ld;     // dout chunks [2][kChunk][ld]
  float* ds_s = oc_s + 2 * kChunk * ld;     // dS of the chunk [query][key]
  float* bias_s = ds_s + kChunk * lds;
  float* m_s = bias_s + S_pad;              // per query: max of s,
  float* l_s = m_s + S_pad;                 //   sum of exp(s − max),
  float* r_s = l_s + S_pad;                 //   its reciprocal,
  float* d_s = r_s + S_pad;                 //   Δ = Σ_d dout·out

  const int g = blockIdx.x;                 // (sample, head) pair
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w0 = warp * 16;                 // the warp's 16 keys
  const size_t base = (size_t)g * S * D;
  auto stage_chunk = [&](int c) {
    const int i0 = c * kChunk, buf = (c & 1) * kChunk * ld;
    stage_async_f32(qc_s + buf, ld, q + base + (size_t)i0 * D, S - i0, kChunk, D, D_pad);
    stage_async_f32(oc_s + buf, ld, dout + base + (size_t)i0 * D, S - i0, kChunk, D,
                    D_pad);
  };
  stage_async_f32(k_s, ld, k + base, S, S_pad, D, D_pad);
  stage_async_f32(v_s, ld, v + base, S, S_pad, D, D_pad);
  stage_chunk(0);
  cp_async_commit();
  if (n_chunks > 1) stage_chunk(1);
  cp_async_commit();
  stage_bias(bias_s, bias + (size_t)(g / H) * S, S, S_pad);
  // the forward's row statistics; padded queries get p = 0 (max +∞)
  for (int i = threadIdx.x; i < S_pad; i += blockDim.x) {
    const float l = i < S ? stats[((size_t)G + g) * S + i] : 1.f;
    m_s[i] = i < S ? stats[(size_t)g * S + i] : __int_as_float(0x7f800000);
    l_s[i] = l;
    r_s[i] = __frcp_rn(l);
  }
  // Δ_i = Σⱼ dp·p = Σ_d dout·out (exact arithmetic). A half-warp takes a
  // row, a lane 4 columns (D <= 64); the block's 2·S_pad threads cover the
  // rows in 8 steps whose loads are all issued before the first sum, so the
  // device-memory latency is paid once, not once a row.
  {
    float4 a[8], b[8];
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int e = threadIdx.x + it * blockDim.x, i = e >> 4, c = (e & 15) << 2;
      a[it] = b[it] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < S && c < D) {
        a[it] = *reinterpret_cast<const float4*>(dout + base + (size_t)i * D + c);
        b[it] = *reinterpret_cast<const float4*>(out + base + (size_t)i * D + c);
      }
    }
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      float acc = a[it].x * b[it].x;
      acc = fmaf(a[it].y, b[it].y, acc);
      acc = fmaf(a[it].z, b[it].z, acc);
      acc = fmaf(a[it].w, b[it].w, acc);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      const int e = threadIdx.x + it * blockDim.x;
      if ((e & 15) == 0) d_s[e >> 4] = acc;
    }
  }
  uint32_t seed = 0, idx_base = 0;
  if (use_dropout) {
    seed = (uint32_t)seeds[g / seed_group];
    idx_base = (uint32_t)(g % seed_group) * ((uint32_t)S * (uint32_t)S);
  }

  float acc_v[2 * DC][4], acc_k[2 * DC][4];
#pragma unroll
  for (int nt = 0; nt < 2 * DC; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc_v[nt][r] = acc_k[nt][r] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<1>();
    __syncthreads();  // chunk c is staged; the previous chunk's dQ has read ds_s
    const float* q_c = qc_s + (c & 1) * kChunk * ld;
    const float* o_c = oc_s + (c & 1) * kChunk * ld;
    const int i0 = c * kChunk;
    const int n_qt = kFull ? kChunk / 16 : min(kChunk / 16, n_kc - 2 * c);

    // Sᵀ = K·Qᵀ and dPᵀ = V·doutᵀ: the warp's 16 keys × the chunk's queries
    float st[kChunk / 8][4], dpt[kChunk / 8][4];
#pragma unroll
    for (int nt = 0; nt < kChunk / 8; ++nt)
#pragma unroll
      for (int r = 0; r < 4; ++r) st[nt][r] = dpt[nt][r] = 0.f;
#pragma unroll
    for (int kd = 0; kd < 2 * DC; ++kd) {
      if (kd < 2 * n_dc) {
        FragA ak, av;
        load_a_plain(ak, k_s, ld, w0, 8 * kd, lane);
        load_a_plain(av, v_s, ld, w0, 8 * kd, lane);
#pragma unroll
        for (int nt = 0; nt < kChunk / 8; ++nt) {
          if (nt < 2 * n_qt) {
            FragB b;
            load_b_nk_plain(b, q_c, ld, 8 * nt, 8 * kd, lane);
            mma_3xtf32(st[nt], ak, b);
            load_b_nk_plain(b, o_c, ld, 8 * nt, 8 * kd, lane);
            mma_3xtf32(dpt[nt], av, b);
          }
        }
      }
    }
    // p from the saved max and sum, with the forward's quotient
    bool tiny = false;
#pragma unroll
    for (int nt = 0; nt < kChunk / 8; ++nt) {
      if (nt < 2 * n_qt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = w0 + acc_row(lane, r), i = i0 + 8 * nt + acc_col(lane, r);
          st[nt][r] = expf(st[nt][r] * scale + bias_s[j] - m_s[i]);
          tiny |= is_tiny_numerator(st[nt][r]);
        }
      }
    }
    if (__any_sync(0xffffffffu, tiny)) {
#pragma unroll
      for (int nt = 0; nt < kChunk / 8; ++nt)
        if (nt < 2 * n_qt)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            st[nt][r] = __fdiv_rn(st[nt][r], l_s[i0 + 8 * nt + acc_col(lane, r)]);
    } else {
#pragma unroll
      for (int nt = 0; nt < kChunk / 8; ++nt)
        if (nt < 2 * n_qt)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = i0 + 8 * nt + acc_col(lane, r);
            st[nt][r] = div_rn(st[nt][r], l_s[i], r_s[i]);
          }
    }
    // the mask at (g, i, j); pd into st, ds = p·(dp − Δ) into dpt and ds_s
#pragma unroll
    for (int nt = 0; nt < kChunk / 8; ++nt) {
      if (nt < 2 * n_qt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = w0 + acc_row(lane, r), i = i0 + 8 * nt + acc_col(lane, r);
          const float p = st[nt][r];
          float dp = dpt[nt][r];
          if (use_dropout) {
            const bool keep = hash_bits(idx_base + (uint32_t)i * (uint32_t)S + (uint32_t)j,
                                        seed) >= threshold;
            st[nt][r] = keep ? p * drop_scale : 0.f;
            dp = keep ? dp * drop_scale : 0.f;
          }
          dpt[nt][r] = p * (dp - d_s[i]);
          ds_s[(i - i0) * lds + j] = dpt[nt][r];
        }
      }
    }
    // dV += Pdᵀ·dout and dK += dSᵀ·Q: the accumulator tiles are the A operands
#pragma unroll
    for (int nt = 0; nt < kChunk / 8; ++nt) {
      if (nt < 2 * n_qt) {
        FragA a;
        a_from_acc(a, st[nt]);
#pragma unroll
        for (int dn = 0; dn < 2 * DC; ++dn) {
          if (dn < 2 * n_dc) {
            FragB b;
            load_b_kn_pair(b, o_c, ld, 8 * nt, 8 * dn, lane);
            mma_3xtf32(acc_v[dn], a, b);
          }
        }
        a_from_acc(a, dpt[nt]);
#pragma unroll
        for (int dn = 0; dn < 2 * DC; ++dn) {
          if (dn < 2 * n_dc) {
            FragB b;
            load_b_kn_pair(b, q_c, ld, 8 * nt, 8 * dn, lane);
            mma_3xtf32(acc_k[dn], a, b);
          }
        }
      }
    }
    __syncthreads();  // the chunk's dS is whole; its Q and dout are read
    if (c + 2 < n_chunks) stage_chunk(c + 2);
    cp_async_commit();

    // dQ = dS·K·scale of the chunk: a warp takes (16 queries, 16 columns)
    for (int u = warp; u < n_qt * n_dc; u += n_warps) {
      const int qt = u / n_dc, dc = u - qt * n_dc;
      float acc[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[h][r] = 0.f;
#pragma unroll
      for (int kt = 0; kt < 2 * kKeyChunks; ++kt) {
        if (kt < 2 * n_kc) {
          FragA a;
          load_a_pair(a, ds_s, lds, 16 * qt, 8 * kt, lane);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            FragB b;
            load_b_kn_pair(b, k_s, ld, 8 * kt, 16 * dc + 8 * h, lane);
            mma_3xtf32(acc[h], a, b);
          }
        }
      }
      store_rows_f32(dq + base, acc, i0 + 16 * qt, 16 * dc, S, D, scale, lane);
    }
  }
  store_rows_f32(dv + base, acc_v, w0, 0, S, D, 1.f, lane);
  store_rows_f32(dk + base, acc_k, w0, 0, S, D, scale, lane);
}

template <bool kFull>
int launch_tf32(const void* q, const void* k, const void* v, const void* bias,
                const void* seeds, const void* dout, const void* out, const void* stats,
                void* dq, void* dk, void* dv, int G, int H, int S, int D, float scale,
                uint32_t threshold, float drop_scale, int use_dropout, int seed_group,
                cudaStream_t stream) {
  const size_t smem = bwd_tf32_smem_bytes(S, D);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_tf32_kernel<kFull>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_tf32_kernel<kFull><<<G, 32 * (mma::pad16(S) >> 4), smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<const int32_t*>(seeds), static_cast<const float*>(dout),
      static_cast<const float*>(out), static_cast<const float*>(stats),
      static_cast<float*>(dq), static_cast<float*>(dk), static_cast<float*>(dv), G, H, S,
      D, scale, threshold, drop_scale, use_dropout, seed_group);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, k, v, dout, dq, dk, dv: [G, S, D] contiguous, 16-byte aligned, G = B·H;
// dtype 0 = float32, 1 = bfloat16. bias: [B, S] float32. seeds: int32, read
// only when use_dropout. stats: float32 workspace of 3·G·S, written by the
// first launch and read by the second. Returns cudaGetLastError() after the
// launches (0 on success).
int fused_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                        const void* bias, const void* seeds, const void* dout,
                        void* dq, void* dk, void* dv, void* stats, int G, int H,
                        int S, int D, float scale, unsigned int threshold,
                        float drop_scale, int use_dropout, int seed_group,
                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, bias, seeds, dout, dq, dk, dv, stats, G, H, S,
                         D, scale, threshold, drop_scale, use_dropout, seed_group, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, bias, seeds, dout, dq, dk, dv, stats, G,
                                 H, S, D, scale, threshold, drop_scale,
                                 use_dropout, seed_group, st);
  return (int)cudaErrorInvalidValue;
}

// The mma_bf16 body: bfloat16 only, the arguments of fused_attention_bwd
// without the workspace; S <= 160, D <= 128 and a multiple of 4, and
// fused_attention_bwd_mma_smem(S, D) within 227 KB, else
// cudaErrorInvalidValue. One launch.
int fused_attention_bwd_mma(const void* q, const void* k, const void* v,
                            const void* bias, const void* seeds, const void* dout,
                            void* dq, void* dk, void* dv, int G, int H, int S, int D,
                            float scale, unsigned int threshold, float drop_scale,
                            int use_dropout, int seed_group, void* stream) {
  if (S < 1 || S > mma::kMaxS || D < 4 || D > mma::kMaxD || D % 4 != 0 ||
      bwd_mma_smem_bytes(S, D) > (size_t)mma::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mma::pad16(S) == mma::kMaxS && mma::pad16(D) == 64)
    return launch_mma_dc<4, true>(q, k, v, bias, seeds, dout, dq, dk, dv, G, H, S, D,
                                  scale, threshold, drop_scale, use_dropout, seed_group,
                                  st);
  if (mma::pad16(D) <= 64)
    return launch_mma_dc<4, false>(q, k, v, bias, seeds, dout, dq, dk, dv, G, H, S, D,
                                   scale, threshold, drop_scale, use_dropout, seed_group,
                                   st);
  return launch_mma_dc<8, false>(q, k, v, bias, seeds, dout, dq, dk, dv, G, H, S, D,
                                 scale, threshold, drop_scale, use_dropout, seed_group,
                                 st);
}

// dynamic shared memory of one mma_bf16 block (the route rule's formula)
int fused_attention_bwd_mma_smem(int S, int D) { return (int)bwd_mma_smem_bytes(S, D); }

// The mma_tf32x3 body: float32 only, the arguments of fused_attention_bwd_mma
// plus the forward's output `out` and its row statistics `stats` ([2, G, S]:
// each row's max and sum of exp, from fused_attention_fwd_tf32); S <= 160,
// D <= 64 and a multiple of 4, else cudaErrorInvalidValue. One launch.
int fused_attention_bwd_tf32(const void* q, const void* k, const void* v,
                             const void* bias, const void* seeds, const void* dout,
                             const void* out, const void* stats, void* dq, void* dk,
                             void* dv, int G, int H, int S, int D, float scale,
                             unsigned int threshold, float drop_scale, int use_dropout,
                             int seed_group, void* stream) {
  if (S < 1 || S > mma::kMaxS || D < 4 || D > kTf32MaxD || D % 4 != 0 ||
      bwd_tf32_smem_bytes(S, D) > (size_t)mma::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mma::pad16(S) == mma::kMaxS && mma::pad16(D) == kTf32MaxD)
    return launch_tf32<true>(q, k, v, bias, seeds, dout, out, stats, dq, dk, dv, G, H, S,
                             D, scale, threshold, drop_scale, use_dropout, seed_group, st);
  return launch_tf32<false>(q, k, v, bias, seeds, dout, out, stats, dq, dk, dv, G, H, S,
                            D, scale, threshold, drop_scale, use_dropout, seed_group, st);
}

// dynamic shared memory of one mma_tf32x3 block (the route rule's formula)
int fused_attention_bwd_tf32_smem(int S, int D) { return (int)bwd_tf32_smem_bytes(S, D); }

}  // extern "C"
