// Fused attention forward for Hopper (sm_90a): out = dropout(softmax(q·kᵀ·scale + bias))·v
//
// Replaces the two Pallas forward kernels of the JAX package:
//   meme_challenge_tpu/ops/attention.py  _fwd_kernel      (per-sample grid, :96-111)
//   meme_challenge_tpu/ops/attention.py  _blk_fwd_kernel  (pair-blocked grid, :265-285)
// Both compute the same function; they differ only in how a (sample, head)
// pair finds its dropout seed and its hash index. Here that is one device body
// with one map, `SeedMap` (attention_common.cuh):
//   pair g = b·H + h, bias row g / H; its global pair P = seed_map.pair(g, H)
//   (P = g unless the launch holds a slice of each fold's rows or heads),
//   seed  = seeds[P / group],
//   index = (P mod group)·S·S + i·S + j   (uint32, wrapping).
// Per sample: group = the fold's heads. Per block: group = blk
// (_largest_block of one fold's global B·H).
//
// Dropout bits are the JAX interpret-mode hash (_hash_bits, attention.py:51-65),
// a murmur3 finalizer over the linear index xor seed·2654435761, so the mask of
// this kernel equals the JAX CPU mask bit for bit. An element is kept iff
// bits >= threshold (threshold = min(int(rate·2³²), 2³²−1)).
//
// Bound at the UNITER-base main path (B 16, H 12, S 160, D 64), from the data
// sheet: q, k, v and out are 4 × 1.97 M elements (31.5 MB fp32, 15.7 MB bf16);
// the two products are 1.26 GFLOP. fp32 at fp32 accuracy is at best three TF32
// products (495 / 3 TFLOP/s): ≈ 9.4 µs, bound by bytes. bf16 (989 TFLOP/s on
// the tensor cores, 3.35 TB/s): ≈ 4.7 µs, bound by bytes.
//
// Three bodies; the route is a pure function of (dtype, S, D), the same as
// ops/attention.py: attention_route:
//   mma_bf16   (attn_fwd_mma_kernel): bfloat16 with S <= 160 (mma::kMaxS),
//              D <= 128 — every shape whose scores fit the register tile.
//   mma_tf32x3 (attn_fwd_tf32_kernel): float32 within the same limits.
//   cuda_core  (attn_fwd_kernel): either dtype beyond them.
// The route never depends on a failure: a launch that fails returns its
// error, and nothing falls back.
//
// mma_bf16 body, FlashAttention-2's register layout on mma.sync m16n8k16
// (mma_bf16.cuh; why not wgmma is noted there). One block per (pair, 80 query
// rows): kFwdTiles = 5 warps, one per 16 query rows, two blocks a pair at
// S 160 (384 blocks at B 16: of 10, 5, 4 and 2 tiles a block, 5 measured
// fastest on the H100). K and V of the pair and the block's Q rows are
// staged in shared memory as bf16 by cp.async (rows padded to D_pad + 8, D
// zero-padded to a multiple of 16, which is exact; 58 KB at S 160, D 64),
// with the key bias row (−∞ for the padded keys j >= S); V is a second copy
// group that lands while the scores are computed. Each warp:
//   1. s = Q·Kᵀ into registers, fp32 accumulation, all keys at once (80
//      floats a thread at S 160); · scale + bias.
//   2. Row max and row sum by quad shuffles, exp(s − m) / sum with the
//      quotient of IEEE division (mma::div_rn; attention.py:82-89); the hash
//      drop test at (g, i, j) and the fp32 1/(1 − rate) scale.
//   3. p rounded to bf16 (attention.py:109) is the A operand of P·V straight
//      from the accumulators (mma::a_from_acc), no shared memory between;
//      V from shared memory by ldmatrix.trans; out rounded to bf16, rows
//      i >= S not written.
// 2 products of 2·S²·D, as the TPU kernel. At S_pad 160 and D_pad 64 (the
// main path) a full-tile instantiation has every count and stride known at
// compile time: the guarded generic one ran 1.3× longer there. The bound is
// bytes, but at one block's 2 × 80 rows the time goes to instructions: the
// exp, the division and, under dropout, ~13 integer operations of the hash
// for each of the 25,600 scores of a pair.
//
// mma_tf32x3 body: the mma_bf16 body's layout and softmax in fp32, with
// 3×TF32 products on mma.sync m16n8k8 (mma_tf32.cuh: one TF32 product misses
// the fp32 path's 1e-5 parity, the split holds it). K, V and the block's Q
// rows are fp32 in shared memory (113 KB at S 160, D 64: two blocks an SM),
// staged in three cp.async groups (Q and the first half of the keys, the
// second half, V) so that each lands while the block computes on the one
// before; Q·Kᵀ reads Q and K as 8-byte pairs (rows padded to D_pad + 8), P·V
// reads V across rows (padded to D_pad + 4), each 8-key accumulator tile of p
// is the next A operand as it stands. The operands are split into TF32 pairs
// in registers as they are loaded. With a non-null `stats` it also writes
// each row's max and sum of exp, which the backward's one launch rebuilds p
// from. Of 5 and 10 query tiles a block, 5 measured faster on the H100.
//
// cuda_core body: fp32 math on the CUDA cores (no TF32; bf16 inputs are widened to fp32, which
// is what XLA's bf16 product with fp32 accumulation computes). One block per
// (pair, tile of 32 query rows), 8 warps; each warp owns 4 query rows end to
// end, so the softmax needs no block-wide barrier:
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
#include <math_constants.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

using namespace attn;
using bf16 = __nv_bfloat16;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32, 2)
attn_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const float* __restrict__ bias,
                const int32_t* __restrict__ seeds, T* __restrict__ out,
                int H, int S, int D, float scale, uint32_t threshold,
                float drop_scale, int use_dropout, SeedMap seed_map) {
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
    seed = (uint32_t)seeds[seed_map.pair(g, H) / seed_map.group];
    idx_base = (uint32_t)(seed_map.pair(g, H) % seed_map.group) * ((uint32_t)S * (uint32_t)S);
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

// ---------------------------------------------------------------- mma_bf16

// query tiles of 16 rows a block takes, one warp each
constexpr int kFwdTiles = 5;
static_assert(kFwdTiles <= mma::kKeyChunks, "a block takes at most S_pad/16 tiles");

int fwd_tiles(int S) {
  const int n_tiles = mma::pad16(S) >> 4;
  return n_tiles < kFwdTiles ? n_tiles : kFwdTiles;
}

// K, V as bf16 [S_pad][D_pad + 8], the block's Q rows [16·tiles][D_pad + 8],
// the fp32 bias row [S_pad]
size_t mma_smem_bytes(int S, int D) {
  const size_t S_pad = mma::pad16(S), ld = mma::pad16(D) + 8;
  return (2 * S_pad + 16 * (size_t)fwd_tiles(S)) * ld * sizeof(bf16) +
         S_pad * sizeof(float);
}

// DC: 16-column chunks of D held for the output (4: D <= 64, 8: D <= 128).
// kFull: S_pad = 160 and D_pad = 16·DC exactly (the main path), so every
// tile count and row stride is a compile-time constant: no guard branches,
// and ldmatrix offsets fold into immediates.
template <int DC, bool kFull>
__global__ void __launch_bounds__(mma::kKeyChunks * 32, 1)
attn_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ bias,
                    const int32_t* __restrict__ seeds, bf16* __restrict__ out, int H,
                    int S, int D, float scale, uint32_t threshold, float drop_scale,
                    int use_dropout, SeedMap seed_map) {
  using namespace mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S_pad = kFull ? 16 * kKeyChunks : pad16(S);
  const int D_pad = kFull ? 16 * DC : pad16(D), ld = D_pad + 8;
  const int n_kc = S_pad >> 4, n_dc = D_pad >> 4;
  const int q_rows = kFull ? 16 * kFwdTiles : blockDim.x >> 1;   // 16 per warp
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + S_pad * ld;
  bf16* q_s = v_s + S_pad * ld;
  float* bias_s = reinterpret_cast<float*>(q_s + q_rows * ld);

  const int g = blockIdx.x;                 // (sample, head) pair
  const int row0 = blockIdx.y * q_rows;     // the block's first query row
  const int lane = threadIdx.x & 31;
  const int m0 = (threadIdx.x >> 5) * 16;   // the warp's 16 rows within q_s
  const size_t base = (size_t)g * S * D;
  // Q and K first; V lands while the scores and the softmax are computed
  stage_async(q_s, ld, q + base + (size_t)row0 * D, min(q_rows, S - row0), q_rows, D,
              D_pad);
  stage_async(k_s, ld, k + base, S, S_pad, D, D_pad);
  cp_async_commit();
  stage_async(v_s, ld, v + base, S, S_pad, D, D_pad);
  cp_async_commit();
  stage_bias(bias_s, bias + (size_t)(g / H) * S, S, S_pad);
  cp_async_wait<1>();
  __syncthreads();

  float p[2 * kKeyChunks][4];
  softmax_rows<DC>(p, q_s, k_s, ld, bias_s, m0, n_kc, n_dc, scale, lane);
  if (use_dropout) {
    const uint32_t seed = (uint32_t)seeds[seed_map.pair(g, H) / seed_map.group];
    const uint32_t idx_base = (uint32_t)(seed_map.pair(g, H) % seed_map.group) * ((uint32_t)S * (uint32_t)S);
#pragma unroll
    for (int nt = 0; nt < 2 * kKeyChunks; ++nt) {
      if (nt < 2 * n_kc) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint32_t i = row0 + m0 + acc_row(lane, r), j = 8 * nt + acc_col(lane, r);
          const bool keep =
              hash_bits(idx_base + i * (uint32_t)S + j, seed) >= threshold;
          p[nt][r] = keep ? p[nt][r] * drop_scale : 0.f;
        }
      }
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // V is in shared memory

  // out = round_bf16(p)·V; p goes from the accumulators into the A operand
  float o[2 * DC][4];
#pragma unroll
  for (int nt = 0; nt < 2 * DC; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[nt][r] = 0.f;
#pragma unroll
  for (int kc = 0; kc < kKeyChunks; ++kc) {
    if (kc < n_kc) {
      uint32_t a[4];
      a_from_acc(a, p[2 * kc], p[2 * kc + 1]);
#pragma unroll
      for (int dc = 0; dc < DC; ++dc) {
        if (dc < n_dc) {
          uint32_t b[2][2];
          load_b2_trans(b, v_s, ld, 16 * kc, 16 * dc, lane);
          mma_bf16(o[2 * dc], a, b[0]);
          mma_bf16(o[2 * dc + 1], a, b[1]);
        }
      }
    }
  }
  store_rows(out + base, o, row0 + m0, S, D, 1.f, lane);
}

template <int DC, bool kFull>
int launch_mma_dc(const void* q, const void* k, const void* v, const void* bias,
                  const void* seeds, void* out, int G, int H, int S, int D, float scale,
                  uint32_t threshold, float drop_scale, int use_dropout, SeedMap seed_map,
                  cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(S, D);
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_mma_kernel<DC, kFull>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = fwd_tiles(S);
  const dim3 grid(G, ((mma::pad16(S) >> 4) + tiles - 1) / tiles);
  attn_fwd_mma_kernel<DC, kFull><<<grid, 32 * tiles, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(bias),
      static_cast<const int32_t*>(seeds), static_cast<bf16*>(out), H, S, D, scale,
      threshold, drop_scale, use_dropout, seed_map);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias,
           const void* seeds, void* out, int G, int H, int S, int D,
           float scale, uint32_t threshold, float drop_scale, int use_dropout,
           SeedMap seed_map, cudaStream_t stream) {
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
      seed_map);
  return (int)cudaGetLastError();
}

// -------------------------------------------------------------- mma_tf32x3

// K and the block's Q rows as fp32 [rows][D_pad + 8] (pair-map loads), V as
// fp32 [S_pad][D_pad + 4] (read across rows), the fp32 bias row [S_pad]
size_t tf32_smem_bytes(int S, int D) {
  const size_t S_pad = mma::pad16(S), D_pad = mma::pad16(D);
  return ((S_pad + 16 * (size_t)fwd_tiles(S)) * (D_pad + 8) + S_pad * (D_pad + 4) + S_pad) *
         sizeof(float);
}

// The float32 body on the tensor cores: attn_fwd_mma_kernel's layout with
// 3×TF32 products (mma_tf32.cuh). `stats`, when not null, receives each
// row's max and sum of exp(s − max) ([2, G, S]) for the backward.
template <int DC, bool kFull>
__global__ void __launch_bounds__(kFwdTiles * 32, 2)
attn_fwd_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ bias,
                     const int32_t* __restrict__ seeds, float* __restrict__ out,
                     float* __restrict__ stats, int G, int H, int S, int D, float scale,
                     uint32_t threshold, float drop_scale, int use_dropout,
                     SeedMap seed_map) {
  using namespace mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int S_pad = kFull ? 16 * kKeyChunks : pad16(S);
  const int D_pad = kFull ? 16 * DC : pad16(D);
  const int ldk = D_pad + 8, ldv = D_pad + 4;
  const int n_kc = S_pad >> 4, n_dc = D_pad >> 4;
  const int q_rows = kFull ? 16 * kFwdTiles : blockDim.x >> 1;   // 16 per warp
  float* k_s = reinterpret_cast<float*>(smem_raw);
  float* q_s = k_s + S_pad * ldk;
  float* v_s = q_s + q_rows * ldk;
  float* bias_s = v_s + S_pad * ldv;

  const int g = blockIdx.x;                 // (sample, head) pair
  const int row0 = blockIdx.y * q_rows;     // the block's first query row
  const int lane = threadIdx.x & 31;
  const int m0 = (threadIdx.x >> 5) * 16;   // the warp's 16 rows within q_s
  const size_t base = (size_t)g * S * D;
  // Q and the first half of the keys, the second half, then V: each lands
  // while the block computes on the one before
  const int half = 16 * ((n_kc + 1) >> 1);
  stage_async_f32(q_s, ldk, q + base + (size_t)row0 * D, min(q_rows, S - row0), q_rows,
                  D, D_pad);
  stage_async_f32(k_s, ldk, k + base, min(S, half), half, D, D_pad);
  cp_async_commit();
  stage_async_f32(k_s + half * ldk, ldk, k + base + (size_t)half * D, S - half,
                  S_pad - half, D, D_pad);
  cp_async_commit();
  stage_async_f32(v_s, ldv, v + base, S, S_pad, D, D_pad);
  cp_async_commit();
  stage_bias(bias_s, bias + (size_t)(g / H) * S, S, S_pad);

  // s = Q·Kᵀ, every key of the warp's 16 rows, pair map over d
  float p[2 * kKeyChunks][4];
#pragma unroll
  for (int nt = 0; nt < 2 * kKeyChunks; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) p[nt][r] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (h == 0) cp_async_wait<2>();
    else cp_async_wait<1>();
    __syncthreads();
#pragma unroll
    for (int kd = 0; kd < 2 * DC; ++kd) {
      if (kd < 2 * n_dc) {
        FragA a;
        load_a_pair(a, q_s, ldk, m0, 8 * kd, lane);
#pragma unroll
        for (int nt = 0; nt < 2 * kKeyChunks; ++nt) {
          if (nt < 2 * n_kc && (nt < half / 8) == (h == 0)) {
            FragB b;
            load_b_nk_pair(b, k_s, ldk, 8 * nt, 8 * kd, lane);
            mma_3xtf32(p[nt], a, b);
          }
        }
      }
    }
  }
  float mx[2], sum[2];
  softmax_scores(p, bias_s, n_kc, scale, lane, mx, sum);
  if (stats != nullptr && (lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int i = row0 + m0 + acc_row(lane, 2 * h);
      if (i < S) {
        stats[(size_t)g * S + i] = mx[h];
        stats[((size_t)G + g) * S + i] = sum[h];
      }
    }
  }
  if (use_dropout) {
    const uint32_t seed = (uint32_t)seeds[seed_map.pair(g, H) / seed_map.group];
    const uint32_t idx_base = (uint32_t)(seed_map.pair(g, H) % seed_map.group) * ((uint32_t)S * (uint32_t)S);
#pragma unroll
    for (int nt = 0; nt < 2 * kKeyChunks; ++nt) {
      if (nt < 2 * n_kc) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint32_t i = row0 + m0 + acc_row(lane, r), j = 8 * nt + acc_col(lane, r);
          const bool keep =
              hash_bits(idx_base + i * (uint32_t)S + j, seed) >= threshold;
          p[nt][r] = keep ? p[nt][r] * drop_scale : 0.f;
        }
      }
    }
  }

  cp_async_wait<0>();
  __syncthreads();  // V is in shared memory

  // out = p·V; each 8-key accumulator tile of p is the A operand as it stands
  float o[2 * DC][4];
#pragma unroll
  for (int nt = 0; nt < 2 * DC; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) o[nt][r] = 0.f;
#pragma unroll
  for (int kt = 0; kt < 2 * kKeyChunks; ++kt) {
    if (kt < 2 * n_kc) {
      FragA a;
      a_from_acc(a, p[kt]);
#pragma unroll
      for (int dn = 0; dn < 2 * DC; ++dn) {
        if (dn < 2 * n_dc) {
          FragB b;
          load_b_kn_pair(b, v_s, ldv, 8 * kt, 8 * dn, lane);
          mma_3xtf32(o[dn], a, b);
        }
      }
    }
  }
  store_rows_f32(out + base, o, row0 + m0, 0, S, D, 1.f, lane);
}

template <int DC, bool kFull>
int launch_tf32_dc(const void* q, const void* k, const void* v, const void* bias,
                   const void* seeds, void* out, void* stats, int G, int H, int S, int D,
                   float scale, uint32_t threshold, float drop_scale, int use_dropout,
                   SeedMap seed_map, cudaStream_t stream) {
  const size_t smem = tf32_smem_bytes(S, D);
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_tf32_kernel<DC, kFull>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = fwd_tiles(S);
  const dim3 grid(G, ((mma::pad16(S) >> 4) + tiles - 1) / tiles);
  attn_fwd_tf32_kernel<DC, kFull><<<grid, 32 * tiles, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<const int32_t*>(seeds), static_cast<float*>(out),
      static_cast<float*>(stats), G, H, S, D, scale, threshold, drop_scale, use_dropout,
      seed_map);
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
    int rows, int rows_total, int row0, int heads_total, int head0, void* stream) {
  const SeedMap sm{seed_group, rows, rows_total, row0, heads_total, head0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, bias, seeds, out, G, H, S, D, scale, threshold,
                         drop_scale, use_dropout, sm, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, bias, seeds, out, G, H, S, D, scale,
                                 threshold, drop_scale, use_dropout, sm, st);
  return (int)cudaErrorInvalidValue;
}

// The mma_bf16 body: bfloat16 only, same arguments and layouts as
// fused_attention_fwd; S <= fused_attention_mma_max_s(), D <= 128 and a
// multiple of 4, else cudaErrorInvalidValue.
int fused_attention_fwd_mma(const void* q, const void* k, const void* v,
                            const void* bias, const void* seeds, void* out, int G, int H,
                            int S, int D, float scale, unsigned int threshold,
                            float drop_scale, int use_dropout, int seed_group,
    int rows, int rows_total, int row0, int heads_total, int head0, void* stream) {
  const SeedMap sm{seed_group, rows, rows_total, row0, heads_total, head0};
  if (S < 1 || S > mma::kMaxS || D < 4 || D > mma::kMaxD || D % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mma::pad16(S) == mma::kMaxS && mma::pad16(D) == 64)
    return launch_mma_dc<4, true>(q, k, v, bias, seeds, out, G, H, S, D, scale,
                                  threshold, drop_scale, use_dropout, sm, st);
  if (mma::pad16(D) <= 64)
    return launch_mma_dc<4, false>(q, k, v, bias, seeds, out, G, H, S, D, scale,
                                   threshold, drop_scale, use_dropout, sm, st);
  return launch_mma_dc<8, false>(q, k, v, bias, seeds, out, G, H, S, D, scale,
                                 threshold, drop_scale, use_dropout, sm, st);
}

int fused_attention_mma_max_s(void) { return mma::kMaxS; }
// dynamic shared memory of one mma_bf16 block (the route rule's formula)
int fused_attention_mma_smem(int S, int D) { return (int)mma_smem_bytes(S, D); }

// The mma_tf32x3 body: float32 only, the arguments of fused_attention_fwd_mma
// plus `stats` (null, or [2, G, S] fp32 receiving each row's max and sum of
// exp for the backward) and G; S <= 160, D <= 128 and a multiple of 4, else
// cudaErrorInvalidValue.
int fused_attention_fwd_tf32(const void* q, const void* k, const void* v,
                             const void* bias, const void* seeds, void* out, void* stats,
                             int G, int H, int S, int D, float scale,
                             unsigned int threshold, float drop_scale, int use_dropout,
                             int seed_group,
    int rows, int rows_total, int row0, int heads_total, int head0, void* stream) {
  const SeedMap sm{seed_group, rows, rows_total, row0, heads_total, head0};
  if (S < 1 || S > mma::kMaxS || D < 4 || D > mma::kMaxD || D % 4 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mma::pad16(S) == mma::kMaxS && mma::pad16(D) == 64)
    return launch_tf32_dc<4, true>(q, k, v, bias, seeds, out, stats, G, H, S, D, scale,
                                   threshold, drop_scale, use_dropout, sm, st);
  if (mma::pad16(D) <= 64)
    return launch_tf32_dc<4, false>(q, k, v, bias, seeds, out, stats, G, H, S, D, scale,
                                    threshold, drop_scale, use_dropout, sm, st);
  return launch_tf32_dc<8, false>(q, k, v, bias, seeds, out, stats, G, H, S, D, scale,
                                  threshold, drop_scale, use_dropout, sm, st);
}

// dynamic shared memory of one mma_tf32x3 block (the route rule's formula)
int fused_attention_tf32_smem(int S, int D) { return (int)tf32_smem_bytes(S, D); }

}  // extern "C"
