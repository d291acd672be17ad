// Tensor-core fragment helpers of the float32 attention bodies
// (fused_attention.cu: attn_fwd_tf32_kernel; fused_attention_bwd.cu:
// attn_bwd_tf32_kernel): `mma.sync.aligned.m16n8k8` (tf32 × tf32 → fp32) in
// the 3×TF32 split, scalar fragment loads from padded fp32 shared memory.
//
// 3×TF32. TF32 keeps 10 mantissa bits, so one TF32 product errs by ≈ 2⁻¹¹
// of a product, 50× the 1e-5 that float32 attention must hold against its
// plain version. Each operand is split, x = hi + lo with hi = rna_tf32(x)
// and lo = x − hi (exact in fp32; Split::set), and a·b is taken as
// a_lo·b_hi + a_hi·b_lo + a_hi·b_hi: the dropped a_lo·b_lo is ≈ 2⁻²² of a
// product, and the products of TF32 values are exact in the tensor core's
// fp32 accumulation. The two small terms are accumulated before the large
// one. The operands are split in registers as they are loaded (three
// instructions an element), not staged as hi and lo: that would double the
// shared memory of K and V.
//
// Fragment layouts of m16n8k8 .tf32 (PTX ISA, "Matrix fragments for
// mma.m16n8k8"), g = lane / 4, t = lane % 4:
//   A 16 × 8: a[0] (g, t), a[1] (g + 8, t), a[2] (g, t + 4), a[3] (g + 8, t + 4)
//   B 8 × 8 (k × n): b[0] (k t, n g), b[1] (k t + 4, n g)
//   C 16 × 8: c[0] (g, 2t), c[1] (g, 2t + 1), c[2] (g + 8, 2t), c[3] (g + 8, 2t + 1)
//   — the same accumulator layout as m16n8k16 (mma_bf16.cuh: acc_row, acc_col).
// A's k-index does not line up with C's column as it does in bf16. The order
// of k inside a product is free, so the "pair" k-map sends k-index t to
// column 2t and t + 4 to 2t + 1: then an accumulator tile is, as it stands,
// the A fragment of the next product (a_from_acc: P and dS stay in
// registers), and a row's two columns 2t, 2t + 1 are one 8-byte load. The
// "plain" k-map keeps k-index = column. Both operands of a product use one
// k-map. Fragments are loaded as scalars (ldmatrix cannot transpose 32-bit
// elements). Bank-conflict-free row strides (floats), checked lane by lane:
//   A/B from [m|n][k] storage, pair map (float2 at row g, col 2t): ld ≡ 8 (mod 16)
//   A/B from [m|n][k] storage, plain map (row g, col t):          ld ≡ 4 (mod 16)
//   B from [k][n] storage, pair map (rows 2t, 2t + 1, col g):      ld ≡ 4 (mod 16)
// With D_pad and S_pad multiples of 16: ld = D_pad + 8 (or S_pad + 8) for the
// first pattern, D_pad + 4 for the other two.
#pragma once

#include "mma_bf16.cuh"

namespace mma {

// An operand element split into two TF32 operands. hi is x rounded to TF32,
// half away from zero, by integer arithmetic: for finite x the bits of
// `cvt.rna.tf32.f32`, whose emulation on sm_90 adds range checks (FSETP,
// SEL) to every conversion. lo is x − hi (exact) as it stands: the tensor
// core reads the top 19 bits of a TF32 register, so lo is truncated, not
// rounded — an error of at most 2⁻²¹ of |x| where the rounded split has
// 2⁻²² (CUTLASS's fast-F32 split, the other way round, truncates hi and
// rounds lo). Both measured faster on the H100 than cvt.rna, within the
// 1e-5 parity (PERF.md §6).
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

template <int N>
struct Split {
  uint32_t hi[N], lo[N];
  __device__ __forceinline__ void set(int i, float x) {
    hi[i] = to_tf32(x);
    lo[i] = __float_as_uint(x - __uint_as_float(hi[i]));
  }
};
using FragA = Split<4>;
using FragB = Split<2>;

// d += a · b, 16 × 8 × 8, one TF32 product
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a · b to fp32 accuracy: the small terms, then the large one
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const FragA& a, const FragB& b) {
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

__device__ __forceinline__ int lane_g(int lane) { return lane >> 2; }
__device__ __forceinline__ int lane_t(int lane) { return lane & 3; }

// A (rows m0 .. m0+15, columns k0 .. k0+7) of a row-major [m][k] matrix, pair map
__device__ __forceinline__ void load_a_pair(FragA& a, const float* s, int ld, int m0,
                                            int k0, int lane) {
  const float* p = s + (m0 + lane_g(lane)) * ld + k0 + 2 * lane_t(lane);
  const float2 x = *reinterpret_cast<const float2*>(p);
  const float2 y = *reinterpret_cast<const float2*>(p + 8 * ld);
  a.set(0, x.x); a.set(2, x.y); a.set(1, y.x); a.set(3, y.y);
}
// A of a row-major [m][k] matrix, plain map
__device__ __forceinline__ void load_a_plain(FragA& a, const float* s, int ld, int m0,
                                             int k0, int lane) {
  const float* p = s + (m0 + lane_g(lane)) * ld + k0 + lane_t(lane);
  a.set(0, p[0]); a.set(1, p[8 * ld]); a.set(2, p[4]); a.set(3, p[8 * ld + 4]);
}
// B (n0 .. n0+7, k0 .. k0+7) of a row-major [n][k] matrix, pair map
__device__ __forceinline__ void load_b_nk_pair(FragB& b, const float* s, int ld, int n0,
                                               int k0, int lane) {
  const float2 x = *reinterpret_cast<const float2*>(
      s + (n0 + lane_g(lane)) * ld + k0 + 2 * lane_t(lane));
  b.set(0, x.x); b.set(1, x.y);
}
// B of a row-major [n][k] matrix, plain map
__device__ __forceinline__ void load_b_nk_plain(FragB& b, const float* s, int ld, int n0,
                                                int k0, int lane) {
  const float* p = s + (n0 + lane_g(lane)) * ld + k0 + lane_t(lane);
  b.set(0, p[0]); b.set(1, p[4]);
}
// B (k0 .. k0+7, n0 .. n0+7) of a row-major [k][n] matrix, pair map
__device__ __forceinline__ void load_b_kn_pair(FragB& b, const float* s, int ld, int k0,
                                               int n0, int lane) {
  const float* p = s + (k0 + 2 * lane_t(lane)) * ld + n0 + lane_g(lane);
  b.set(0, p[0]); b.set(1, p[ld]);
}
// the A fragment (pair map) of an accumulator tile: its 8 columns are the k
// of the next product
__device__ __forceinline__ void a_from_acc(FragA& a, const float (&c)[4]) {
  a.set(0, c[0]); a.set(2, c[1]); a.set(1, c[2]); a.set(3, c[3]);
}

// Start copying rows [0, n) of a row-major [n, D] fp32 matrix into an
// [n_pad][ld] shared tile, columns [0, D_pad); rows >= n and columns >= D
// are zero. D is a multiple of 4: 16-byte copies.
__device__ __forceinline__ void stage_async_f32(float* dst, int ld, const float* src,
                                                int n, int n_pad, int D, int D_pad) {
  const int per_row = D_pad >> 2;
  for (int e = threadIdx.x; e < n_pad * per_row; e += blockDim.x) {
    const int r = e / per_row, c = (e - r * per_row) << 2;
    float* d = dst + r * ld + c;
    if (r < n && c < D) cp_async16(d, src + (size_t)r * D + c);
    else *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Write accumulator tiles acc[nt] (rows m0 .., columns col0 + 8·nt ..) · mul
// to a row-major [S, D] fp32 matrix in device memory; rows >= S and columns
// >= D are not written (D is even, so a column pair is all in or out).
template <int NT>
__device__ __forceinline__ void store_rows_f32(float* dst, const float (&acc)[NT][4],
                                               int m0, int col0, int S, int D, float mul,
                                               int lane) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + acc_row(lane, 2 * h), col = col0 + 8 * nt + acc_col(lane, 2 * h);
      if (row < S && col < D)
        *reinterpret_cast<float2*>(dst + (size_t)row * D + col) =
            make_float2(acc[nt][2 * h] * mul, acc[nt][2 * h + 1] * mul);
    }
  }
}

}  // namespace mma
