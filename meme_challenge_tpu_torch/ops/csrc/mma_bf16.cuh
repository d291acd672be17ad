// Tensor-core fragment helpers of the bf16 attention bodies
// (fused_attention.cu: attn_fwd_mma_kernel; fused_attention_bwd.cu:
// attn_bwd_mma_kernel): `mma.sync.aligned.m16n8k16` (bf16 × bf16 → fp32),
// `ldmatrix` loads from padded shared memory, `cp.async` staging.
//
// Why mma.sync and not wgmma: at the main path's S 160 a pair is 10 tiles of
// 16 rows but 2.5 of wgmma's 64, and one warp owning 16 whole query rows lets
// the softmax stay in registers with quad shuffles only. wgmma is later work.
//
// Fragment layouts of m16n8k16 (PTX ISA, "Matrix fragments for
// mma.m16n8k16"), lane = threadIdx.x % 32:
//   accumulator C/D, 16 × 8, float c[4]: register r holds
//     row acc_row(lane, r) = lane/4 + 8·(r/2), col acc_col(lane, r) = 2·(lane%4) + r%2.
//   A, 16 × 16 (row major), uint32_t a[4] of two bf16 each: a[0] rows 0-7 ×
//     cols 0-7, a[1] rows 8-15 × cols 0-7, a[2] rows 0-7 × cols 8-15, a[3]
//     rows 8-15 × cols 8-15; in each, the lane holds row lane/4, cols
//     2·(lane%4) and +1 (lower column in the low half).
//   B, 16 × 8 (k × n, "col"), uint32_t b[2]: b[0] k 0-7, b[1] k 8-15; the lane
//     holds n = lane/4, k = 2·(lane%4) and +1.
// So two accumulator tiles side by side (16 × 16) are, once rounded to bf16,
// an A fragment with the same rows and k = their 16 columns (a_from_acc):
// FlashAttention-2's register reuse, P and dS never go through shared memory
// on their way into the next product.
//
// ldmatrix.x4: lane t gives the address of row t%8 of 8×8 matrix t/8 and gets
// back, for matrix i, register i holding (row lane/4, cols 2·(lane%4), +1),
// or with .trans the transposed pair (rows 2·(lane%4), +1 of col lane/4).
// Two address patterns cover every operand here:
//   P1: row = lane%16,               col = 8·(lane/16)
//   P2: row = lane%8 + 8·(lane/16),  col = 8·((lane/8)%2)
//   A from [m][k] storage: P1, plain;   A from [k][m] storage: P2, .trans
//   B from [n][k] storage: P2, plain;   B from [k][n] storage: P1, .trans
// (the two B loads give the fragments of two n-tiles, n0 and n0 + 8).
// Every row is 16-byte aligned, and row strides of D_pad + 8 or S_pad + 8
// bf16 (D_pad, S_pad multiples of 16) put the 8 rows of a matrix in 8
// different 16-byte bank groups, so no load has a bank conflict.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

// Longest S the bf16 bodies take: a warp holds its 16 query rows' scores
// over every key in registers, 2·(S_pad/16) accumulator tiles (80 floats a
// thread at 160). The route rule (ops/attention.py: attention_route) sends
// longer sequences to the CUDA-core body.
constexpr int kMaxS = 160;
constexpr int kKeyChunks = kMaxS / 16;   // 16-key chunks, one warp per 16 rows
constexpr int kMaxD = 128;
// shared memory a block may take on Hopper (227 KB)
constexpr int kMaxSmem = 232448;

// the accumulator layout; every other mapping in the bf16 bodies uses these
__device__ __forceinline__ int acc_row(int lane, int r) { return (lane >> 2) + 8 * (r >> 1); }
__device__ __forceinline__ int acc_col(int lane, int r) { return 2 * (lane & 3) + (r & 1); }

__host__ __device__ __forceinline__ int pad16(int n) { return (n + 15) & ~15; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// two floats rounded to bf16 (nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// d += a · b, 16 × 8 × 16, fp32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ const __nv_bfloat16* p1(const __nv_bfloat16* s, int ld,
                                                   int row0, int col0, int lane) {
  return s + (row0 + (lane & 15)) * ld + col0 + 8 * (lane >> 4);
}
__device__ __forceinline__ const __nv_bfloat16* p2(const __nv_bfloat16* s, int ld,
                                                   int row0, int col0, int lane) {
  return s + (row0 + (lane & 7) + 8 * (lane >> 4)) * ld + col0 + 8 * ((lane >> 3) & 1);
}

// A (16 × 16 at rows m0, cols k0) of a row-major [m][k] matrix
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const __nv_bfloat16* s, int ld,
                                       int m0, int k0, int lane) {
  ldsm_x4(a, p1(s, ld, m0, k0, lane));
}
// A (rows m0, cols k0) of the transpose of a row-major [k][m] matrix
__device__ __forceinline__ void load_a_trans(uint32_t (&a)[4], const __nv_bfloat16* s,
                                             int ld, int m0, int k0, int lane) {
  ldsm_x4_trans(a, p2(s, ld, k0, m0, lane));
}
// B of n-tiles n0 and n0 + 8 (k0 .. k0 + 15) of a row-major [n][k] matrix
__device__ __forceinline__ void load_b2(uint32_t (&b)[2][2], const __nv_bfloat16* s,
                                        int ld, int n0, int k0, int lane) {
  uint32_t r[4];
  ldsm_x4(r, p2(s, ld, n0, k0, lane));
  b[0][0] = r[0]; b[0][1] = r[1]; b[1][0] = r[2]; b[1][1] = r[3];
}
// B of n-tiles n0 and n0 + 8 (k0 .. k0 + 15) of a row-major [k][n] matrix
__device__ __forceinline__ void load_b2_trans(uint32_t (&b)[2][2], const __nv_bfloat16* s,
                                              int ld, int k0, int n0, int lane) {
  uint32_t r[4];
  ldsm_x4_trans(r, p1(s, ld, k0, n0, lane));
  b[0][0] = r[0]; b[0][1] = r[1]; b[1][0] = r[2]; b[1][1] = r[3];
}

// A fragment (k = 16 columns) from the accumulators of n-tiles c0 (cols 0-7)
// and c1 (cols 8-15), rounded to bf16: a[0] = row acc_row(lane, 0..1) of c0,
// a[1] = row acc_row(lane, 2..3) of c0, a[2], a[3] the same of c1.
__device__ __forceinline__ void a_from_acc(uint32_t (&a)[4], const float (&c0)[4],
                                           const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `n` committed groups are still in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(n) : "memory");
}

// a / b rounded to nearest even, as IEEE division, for 2^-100 <= a <= b or
// a = 0, and 1 <= b < 2^24 (a softmax numerator over its row sum), given
// rcp_b = __frcp_rn(b): Markstein's correction q + (a − b·q)·rcp_b is
// correctly rounded while a·rcp_b and the remainder stay normal. The
// compiler's `/` opens a range check and a slow-path branch on every
// quotient; softmax_rows calls this on the whole tile unless some numerator
// needs __fdiv_rn (is_tiny_numerator), a branch taken once for the warp.
__device__ __forceinline__ float div_rn(float a, float b, float rcp_b) {
  const float q = a * rcp_b;
  return fmaf(fmaf(-b, q, a), rcp_b, q);
}
__device__ __forceinline__ bool is_tiny_numerator(float a) {
  return a != 0.f && a < 7.88860905e-31f;   // 2^-100
}

// Start copying rows [0, n) of a row-major [n, D] bf16 matrix into a
// [n_pad][ld] shared tile, columns [0, D_pad); rows >= n and columns >= D are
// zero (exact padding for the products). D is a multiple of 4; 16-byte copies
// when it is a multiple of 8, else 8-byte ones. Completes at the
// cp_async_wait() that covers its group, and a barrier.
__device__ __forceinline__ void stage_async(__nv_bfloat16* dst, int ld,
                                            const __nv_bfloat16* src, int n, int n_pad,
                                            int D, int D_pad) {
  if ((D & 7) == 0) {
    const int per_row = D_pad >> 3;
    for (int e = threadIdx.x; e < n_pad * per_row; e += blockDim.x) {
      const int r = e / per_row, c = (e - r * per_row) << 3;
      __nv_bfloat16* d = dst + r * ld + c;
      if (r < n && c < D) cp_async16(d, src + (size_t)r * D + c);
      else *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  } else {
    const int per_row = D_pad >> 2;
    for (int e = threadIdx.x; e < n_pad * per_row; e += blockDim.x) {
      const int r = e / per_row, c = (e - r * per_row) << 2;
      __nv_bfloat16* d = dst + r * ld + c;
      if (r < n && c < D) cp_async8(d, src + (size_t)r * D + c);
      else *reinterpret_cast<uint2*>(d) = make_uint2(0u, 0u);
    }
  }
}

// the key bias row of the pair in shared memory: bias for j < S, −∞ for the
// padded keys S <= j < S_pad (so they get probability 0, not a −10000 bias)
__device__ __forceinline__ void stage_bias(float* dst, const float* bias_row, int S,
                                           int S_pad) {
  for (int j = threadIdx.x; j < S_pad; j += blockDim.x)
    dst[j] = j < S ? bias_row[j] : -__int_as_float(0x7f800000);
}

// acc[nt] = A[m0 .. m0+15] · Bᵀ over n-tiles nt < 2·n_kc: A row-major [m][d],
// B row-major [n][d], d < 16·n_dc (≤ 16·DC). s = Q·Kᵀ and dp = dout·Vᵀ.
template <int DC>
__device__ __forceinline__ void rows_times_keys(float (&acc)[2 * kKeyChunks][4],
                                                const __nv_bfloat16* a_s,
                                                const __nv_bfloat16* b_s, int ld, int m0,
                                                int n_kc, int n_dc, int lane) {
#pragma unroll
  for (int nt = 0; nt < 2 * kKeyChunks; ++nt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[nt][r] = 0.f;
#pragma unroll
  for (int dc = 0; dc < DC; ++dc) {
    if (dc < n_dc) {
      uint32_t a[4];
      load_a(a, a_s, ld, m0, 16 * dc, lane);
#pragma unroll
      for (int kc = 0; kc < kKeyChunks; ++kc) {
        if (kc < n_kc) {
          uint32_t b[2][2];
          load_b2(b, b_s, ld, 16 * kc, 16 * dc, lane);
          mma_bf16(acc[2 * kc], a, b[0]);
          mma_bf16(acc[2 * kc + 1], a, b[1]);
        }
      }
    }
  }
}

// p = softmax(p·scale + bias) in place, for raw scores p = Q·Kᵀ of 16 query
// rows held whole in registers: p[nt][r] is (row acc_row(lane, r), key
// 8·nt + acc_col(lane, r)). The row max and sum are over the quad that holds
// a row (lanes 4·(lane/4) .. +3); exp(s − m) / sum with the quotient of IEEE
// division (div_rn), as attention.py:82-89. Keys j >= S (bias −∞) get 0.
// mx[h], sum[h] return the max and the sum of rows acc_row(lane, 2h).
__device__ __forceinline__ void softmax_scores(float (&p)[2 * kKeyChunks][4],
                                               const float* bias_s, int n_kc, float scale,
                                               int lane, float (&mx)[2], float (&sum)[2]) {
  mx[0] = mx[1] = -__int_as_float(0x7f800000);
#pragma unroll
  for (int nt = 0; nt < 2 * kKeyChunks; ++nt) {
    if (nt < 2 * n_kc) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        p[nt][r] = p[nt][r] * scale + bias_s[8 * nt + acc_col(lane, r)];
        mx[r >> 1] = fmaxf(mx[r >> 1], p[nt][r]);
      }
    }
  }
  sum[0] = sum[1] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
  }
#pragma unroll
  for (int nt = 0; nt < 2 * kKeyChunks; ++nt) {
    if (nt < 2 * n_kc) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        p[nt][r] = expf(p[nt][r] - mx[r >> 1]);
        sum[r >> 1] += p[nt][r];
      }
    }
  }
  float rcp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    rcp[h] = __frcp_rn(sum[h]);
  }
  bool tiny = false;
#pragma unroll
  for (int nt = 0; nt < 2 * kKeyChunks; ++nt)
    if (nt < 2 * n_kc)
#pragma unroll
      for (int r = 0; r < 4; ++r) tiny |= is_tiny_numerator(p[nt][r]);
  if (__any_sync(0xffffffffu, tiny)) {
#pragma unroll
    for (int nt = 0; nt < 2 * kKeyChunks; ++nt)
      if (nt < 2 * n_kc)
#pragma unroll
        for (int r = 0; r < 4; ++r) p[nt][r] = __fdiv_rn(p[nt][r], sum[r >> 1]);
  } else {
#pragma unroll
    for (int nt = 0; nt < 2 * kKeyChunks; ++nt)
      if (nt < 2 * n_kc)
#pragma unroll
        for (int r = 0; r < 4; ++r) p[nt][r] = div_rn(p[nt][r], sum[r >> 1], rcp[r >> 1]);
  }
}

// p = softmax(Q·Kᵀ·scale + bias) of the warp's 16 query rows m0 .. m0+15
// (softmax_scores)
template <int DC>
__device__ __forceinline__ void softmax_rows(float (&p)[2 * kKeyChunks][4],
                                             const __nv_bfloat16* q_s,
                                             const __nv_bfloat16* k_s, int ld,
                                             const float* bias_s, int m0, int n_kc,
                                             int n_dc, float scale, int lane) {
  rows_times_keys<DC>(p, q_s, k_s, ld, m0, n_kc, n_dc, lane);
  float mx[2], sum[2];
  softmax_scores(p, bias_s, n_kc, scale, lane, mx, sum);
}

// Store an A-shaped bf16 tile (a_from_acc's output: rows m0 + acc_row,
// 16 columns from col0) into a row-major shared matrix.
__device__ __forceinline__ void store_a(__nv_bfloat16* s, int ld, int m0, int col0,
                                        const uint32_t (&a)[4], int lane) {
  const int row = m0 + acc_row(lane, 0), col = col0 + acc_col(lane, 0);
  *reinterpret_cast<uint32_t*>(s + row * ld + col) = a[0];
  *reinterpret_cast<uint32_t*>(s + (row + 8) * ld + col) = a[1];
  *reinterpret_cast<uint32_t*>(s + row * ld + col + 8) = a[2];
  *reinterpret_cast<uint32_t*>(s + (row + 8) * ld + col + 8) = a[3];
}

// Write accumulator tiles acc[nt] (rows m0 .., columns 8·nt ..) · mul as
// bf16 to a row-major [S, D] matrix in device memory; rows >= S and
// columns >= D are not written (D is even, so a column pair is all in or out).
template <int NT>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, const float (&acc)[NT][4],
                                           int m0, int S, int D, float mul, int lane) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + acc_row(lane, 2 * h), col = 8 * nt + acc_col(lane, 2 * h);
      if (row < S && col < D)
        *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)row * D + col) =
            __floats2bfloat162_rn(acc[nt][2 * h] * mul, acc[nt][2 * h + 1] * mul);
    }
  }
}

}  // namespace mma
