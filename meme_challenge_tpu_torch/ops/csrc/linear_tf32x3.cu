// The encoder's float32 matrix products on Hopper's tensor cores (sm_90a),
// 3×TF32: forward y = x·Wᵀ + b, dgrad dx = dy·W and wgrad dW = dyᵀ·x.
//
// Replaces no TPU kernel: the JAX encoder leaves its dense layers to XLA's
// dots. The port ran them as cuBLAS float32 GEMMs, which with TF32 off run
// on the CUDA cores (≈ 40 TFLOP/s of the card's 67), and added the bias in
// a separate elementwise pass. TF32 alone errs by ≈ 2⁻¹¹ of a product, far
// beyond float32. So each operand is split as mma_tf32.cuh splits it,
// x = hi + lo with hi = rna_tf32(x) and lo = x − hi, and a·b is taken as
// a_lo·b_hi + a_hi·b_lo + a_hi·b_hi, the two small terms before the large
// one. The tensor core's fp32 accumulator rounds toward zero, which over
// K / 8 steps loses several times float32's accuracy (4-10× cuBLAS's
// error, measured on the H100), so it sums one stage of 32 k only, starting
// from zero, and each stage's sum is added to the running sum on the CUDA
// cores, rounded to nearest (Ootomo and Yokota 2022). Three TF32 products
// a product bound the kernel at 495 / 3 = 165 TFLOP/s; at the encoder's
// shapes (M = 2 560 rows a micro-batch, N and K 768-4 096) a product does
// hundreds of operations a byte, so operations, not bytes, bound it.
//
// One kernel, C[m][n] = Σ_k A(m, k)·B(n, k) (+ bias[n]), reads each operand
// either K-major (A[m·lda + k], B[n·ldb + k]) or the other way round
// (A[k·lda + m], B[k·ldb + n]), so the three products are three
// instantiations:
//   forward  A = x  (K-major), B = W  (K-major), M × N over K, bias;
//   dgrad    A = dy (K-major), B = W  (read N-major): M × K over N;
//   wgrad    A = dy (read M-major), B = x (read M-major): N × K over M.
// A block computes a 128 × 128 tile with one producer warpgroup and two
// consumer warpgroups of 64 rows each, 32 k a stage:
//   - The producer copies each stage's A tile (fp32, cp.async) into a ring
//     of padded rows, and its B tile into a ring of raw fp32 slots, kLead
//     stages ahead. It then splits the stage's B into hi and lo and stores
//     both K-major in the 128-byte swizzled layout wgmma reads: `wgmma`
//     takes a .tf32 operand from shared memory only K-major, so this pass
//     is also where dgrad and wgrad transpose B. It signals the stage full
//     on an mbarrier (its stores fenced for the async proxy).
//   - Each consumer loads its 64 rows of A in the m16n8k8 fragment layout,
//     splits them in registers (A is a register operand of wgmma, in any
//     layout, so A is never split in shared memory) and issues three
//     `wgmma.mma_async m64n128k8` a k-step of 8 into a stage sum, then
//     frees the stage and adds the stage sum to its running sum.
// The raw B slots cost shared-memory bandwidth and save latency: loading B
// straight into registers, the producer waited on device memory (the kernel
// ran ≈ 15 % slower on the H100); splitting A in shared memory as well cost
// ≈ 12 %.
// Nothing is kept between launches: no split or transposed copy of an
// operand lives in device memory. The bias is added once to the fp32
// accumulator in the epilogue, the rounding of "product, then bias".
//
// Wave quantisation: an output of few tiles (a wgrad's 768 × 768 = 36, or
// UNITER-large's 2 560 × 1 024 = 160 on 132 SMs) leaves SMs idle, so the
// wrapper may split the k range over `splits` blocks of a tile, each
// writing its partial to a workspace, and a second kernel sums the partials
// in a fixed order (then adds the bias): no atomics, so a result repeats bit
// for bit from run to run.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr int kBN = 128;                 // output columns a block
constexpr int kBK = 32;                  // k a stage: one 128-byte swizzled row
constexpr int kBTile = kBN * kBK * 4;    // bytes of B hi (or lo) a stage
constexpr int kConsumers = 2;            // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kStages = 2;              // stages of B hi and lo
constexpr int kLead = 2;                // stages of copies in flight ahead of the split
constexpr int kRing = kLead + kStages;  // A and raw B slots
constexpr int kBM = 64 * kConsumers;    // output rows a block
constexpr int kBStage = 2 * kBTile;     // B hi, B lo
constexpr int kBRaw = kBN * kBK * 4;    // B as loaded

// A stays fp32 in shared memory, rows padded so that the consumers' fragment
// loads meet no bank conflict: [m][k] padded to 36 (≡ 4 mod 32 banks) or
// [k][m] padded to BM + 8 (≡ 8 mod 32).
template <bool A_K>
struct ALayout {
  static constexpr int kLd = A_K ? kBK + 4 : kBM + 8;
  static constexpr int kFloats = (A_K ? kBM : kBK) * kLd;
  // B hi/lo ring, A ring, raw B ring, the full and empty barriers, and
  // slack to align the ring to 1 024 bytes
  static constexpr int kSmem = kStages * kBStage + kRing * (kFloats * 4 + kBRaw) +
                               2 * kStages * 8 + 1024;
  static_assert(kSmem <= 232448, "shared memory of a block");
};

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(mma::smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(mma::smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(mma::smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = mma::smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// generic-proxy stores to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most n committed groups are still in flight
template <int n>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(n) : "memory");
}
// keeps the compiler from moving accumulator reads across the async region
__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// Shared-memory descriptor of a K-major tile of 8-row groups 1 024 bytes
// apart (SBO), each row 128 bytes swizzled in 16-byte chunks (layout 1:
// SWIZZLE_128B; LBO unused). `addr` moves 32 bytes along a row per k-step of
// 8; the swizzle is applied to the address, so the ring is 1 024-aligned.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d[64] = a · B (+ d if accumulate), m64n128k8, one TF32 product: a the
// warpgroup's A fragment in registers (m16n8k8's layout, warp w rows
// 16w .. 16w + 15), B a 128 × 8 K-major tile in shared memory (desc). The
// accumulator layout: warp w, lane (g, t) = (lane / 4, lane % 4), holds
// d[4j + e] at row 16w + g + 8·(e / 2), column 8j + 2t + e % 2.
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(accumulate));
}

// four values split into hi and lo, stored as 16-byte chunk `chunk` of row
// `row` of the swizzled hi and lo tiles
__device__ __forceinline__ void store_split(uint8_t* hi, uint8_t* lo, int row, int chunk,
                                            const float* v) {
  uint4 h, l;
  h.x = mma::to_tf32(v[0]); l.x = __float_as_uint(v[0] - __uint_as_float(h.x));
  h.y = mma::to_tf32(v[1]); l.y = __float_as_uint(v[1] - __uint_as_float(h.y));
  h.z = mma::to_tf32(v[2]); l.z = __float_as_uint(v[2] - __uint_as_float(h.z));
  h.w = mma::to_tf32(v[3]); l.w = __float_as_uint(v[3] - __uint_as_float(h.w));
  const int off = row * 128 + ((chunk ^ (row & 7)) << 4);
  *reinterpret_cast<uint4*>(hi + off) = h;
  *reinterpret_cast<uint4*>(lo + off) = l;
}

// One operand's 128 × 32 tile of a stage, copied (cp.async, zero past the
// matrix) as 8 chunks of 16 bytes a thread into raw[c][p]; thread p reads
// back only its own chunks, and a warp's copy is 512 contiguous bytes or
// four 128-byte rows.
//   K-major (X[row·ld + k]): chunk c is row p / 8 + 16c, k quad p % 8.
//   Else (X[k·ld + row]): chunk c is k 8·(p / 32) + c, row quad p % 32.
template <bool KMAJOR>
__device__ __forceinline__ void copy_tile(float4* raw, const float* __restrict__ X, int ld,
                                          int row0, int rows, int k0, int K, int p) {
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    int row, k;
    const float* src;
    if (KMAJOR) {
      row = row0 + (p >> 3) + 16 * c; k = k0 + 4 * (p & 7);
      src = X + (size_t)row * ld + k;
    } else {
      row = row0 + 4 * (p & 31); k = k0 + 8 * (p >> 5) + c;
      src = X + (size_t)k * ld + row;
    }
    const bool ok = row < rows && k < K;
    cp_async16_zfill(raw + c * 128 + p, ok ? src : X, ok);
  }
}

// A's 128 × 32 tile of a stage, fp32, copied (cp.async, zero past the
// matrix) into its padded ALayout rows; a warp's copy is 512 contiguous
// bytes or four 128-byte rows.
template <bool A_K>
__device__ __forceinline__ void copy_a(float* dst, const float* __restrict__ A, int lda,
                                       int m0, int M, int k0, int K, int p) {
  using L = ALayout<A_K>;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = p + 128 * i;
    int m, k;
    const float* src;
    float* to;
    if (A_K) {
      m = m0 + (c >> 3); k = k0 + 4 * (c & 7);
      src = A + (size_t)m * lda + k; to = dst + (c >> 3) * L::kLd + 4 * (c & 7);
    } else {
      k = k0 + (c >> 5); m = m0 + 4 * (c & 31);
      src = A + (size_t)k * lda + m; to = dst + (c >> 5) * L::kLd + 4 * (c & 31);
    }
    const bool ok = m < M && k < K;
    cp_async16_zfill(to, ok ? src : A, ok);
  }
}

// The thread's chunks of copy_tile, split, into the hi and lo tiles (row r,
// 16-byte chunk q at r·128 + 16·(q ^ r % 8)). A quarter-warp's 16-byte
// stores land in 8 different chunk columns, so none conflicts on a bank:
//   K-major: the 8 threads of a row write its 8 chunks.
//   Else: the thread holds 8 k of rows 4·(p % 32) .. + 3 and writes two
//   chunks of each row, transposed in registers; store s writes row
//   jj = (s + p / 2) % 4 of its quad, so that rows of 8 neighbouring threads
//   differ mod 8.
template <bool KMAJOR>
__device__ __forceinline__ void split_tile(uint8_t* hi, uint8_t* lo, const float4* raw, int p) {
  float4 x[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) x[c] = raw[c * 128 + p];
  if (KMAJOR) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float v[4] = {x[c].x, x[c].y, x[c].z, x[c].w};
      store_split(hi, lo, (p >> 3) + 16 * c, p & 7, v);
    }
  } else {
    const int rq = p & 31, w = p >> 5;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int jj = (s + (rq >> 1)) & 3;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 q = x[4 * h + i];
          v[i] = jj == 0 ? q.x : jj == 1 ? q.y : jj == 2 ? q.z : q.w;
        }
        store_split(hi, lo, 4 * rq + jj, 2 * w + h, v);
      }
    }
  }
}

template <bool A_K, bool B_K>
__global__ void __launch_bounds__(kThreads, 1)
gemm_tf32x3_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   const float* __restrict__ bias, float* __restrict__ C, int M, int N,
                   int K, int lda, int ldb, int kt_per_split) {
  using L = ALayout<A_K>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (mma::smem_addr(smem_raw) & 1023)) & 1023);
  float* a_ring = reinterpret_cast<float*>(smem + kStages * kBStage);
  float4* b_raw = reinterpret_cast<float4*>(a_ring + kRing * L::kFloats);
  uint64_t* full = reinterpret_cast<uint64_t*>(b_raw + kRing * (kBRaw / 16));
  uint64_t* empty = full + kStages;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int kt0 = blockIdx.z * kt_per_split;
  const int nk = max(0, min((K + kBK - 1) / kBK - kt0, kt_per_split));
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 128);              // one a producer thread
      mbar_init(&empty[s], 4 * kConsumers);  // one a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {  // producer warpgroup
    const int p = threadIdx.x;
    // one cp.async group a stage (A into its ring, B raw), kLead ahead of
    // the split; an empty group past the end keeps the count
    auto issue = [&](int i) {
      if (i < nk) {
        const int k0 = (kt0 + i) * kBK;
        copy_a<A_K>(a_ring + (i % kRing) * L::kFloats, A, lda, m0, M, k0, K, p);
        copy_tile<B_K>(b_raw + (i % kRing) * 8 * 128, B, ldb, n0, N, k0, K, p);
      }
      mma::cp_async_commit();
    };
    for (int i = 0; i < kLead; ++i) issue(i);
    for (int i = 0; i < nk; ++i) {
      const int s = i % kStages;
      // stage i - kStages freed: its B hi/lo slot, and the A and raw B slot
      // that stage i + kLead takes
      mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
      issue(i + kLead);
      mma::cp_async_wait<kLead>();
      uint8_t* st = smem + s * kBStage;
      split_tile<B_K>(st, st + kBTile, b_raw + (i % kRing) * 8 * 128, p);
      fence_proxy_async();
      mbar_arrive(&full[s]);
    }
    return;
  }

  // consumer warpgroups
  const int cw = (threadIdx.x >> 7) - 1, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int r = cw * 64 + warp * 16 + g;  // the thread's first row in the tile
  float d[64], part[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) d[e] = 0.f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % kStages;
    const float* as = a_ring + (i % kRing) * L::kFloats;
    const uint32_t bhi = mma::smem_addr(smem + s * kBStage), blo = bhi + kBTile;
    mbar_wait(&full[s], (i / kStages) & 1);
    // A's fragments of each k-step of 8, split in registers, two sets: a
    // set is loaded again once the products that read it have finished
    uint32_t ahi[2][4], alo[2][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = 8 * j + t;
      float x[4];
      if (A_K) {
        x[0] = as[r * L::kLd + k];
        x[1] = as[(r + 8) * L::kLd + k];
        x[2] = as[r * L::kLd + k + 4];
        x[3] = as[(r + 8) * L::kLd + k + 4];
      } else {
        x[0] = as[k * L::kLd + r];
        x[1] = as[k * L::kLd + r + 8];
        x[2] = as[(k + 4) * L::kLd + r];
        x[3] = as[(k + 4) * L::kLd + r + 8];
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ahi[j & 1][e] = mma::to_tf32(x[e]);
        alo[j & 1][e] = __float_as_uint(x[e] - __uint_as_float(ahi[j & 1][e]));
      }
      wgmma_fence();
      wgmma_m64n128k8(part, alo[j & 1], desc_sw128(bhi + 32 * j), j > 0);
      wgmma_m64n128k8(part, ahi[j & 1], desc_sw128(blo + 32 * j), 1);
      wgmma_m64n128k8(part, ahi[j & 1], desc_sw128(bhi + 32 * j), 1);
      wgmma_commit();
      if (j < 3) wgmma_wait<1>();
    }
    wgmma_wait<0>();
    fence_operands(part);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    // the tensor core's accumulator rounds toward zero; a stage's sum is
    // added to the running one here, rounded to nearest
#pragma unroll
    for (int e = 0; e < 64; ++e) d[e] = __fadd_rn(d[e], part[e]);
  }

  // epilogue: split partials go to slice blockIdx.z of the workspace
  float* out = C + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = n0 + 8 * j + 2 * t;
    if (col >= N) continue;
    float b0 = 0.f, b1 = 0.f;
    if (bias != nullptr) { b0 = bias[col]; b1 = bias[col + 1]; }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + r + 8 * h;
      if (row >= M) continue;
      float2 o = make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
      if (bias != nullptr) { o.x += b0; o.y += b1; }
      *reinterpret_cast<float2*>(out + (size_t)row * N + col) = o;
    }
  }
}

// C = Σ_z work[z] (+ bias), z in order; four elements a thread
__global__ void gemm_splitk_sum_kernel(const float4* __restrict__ work,
                                       const float4* __restrict__ bias, float4* __restrict__ C,
                                       long long n4, int n_quads, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 acc = work[i];
  for (int z = 1; z < splits; ++z) {
    const float4 w = work[(long long)z * n4 + i];
    acc.x += w.x; acc.y += w.y; acc.z += w.z; acc.w += w.w;
  }
  if (bias != nullptr) {
    const float4 b = bias[i % n_quads];
    acc.x += b.x; acc.y += b.y; acc.z += b.z; acc.w += b.w;
  }
  C[i] = acc;
}

template <bool A_K, bool B_K>
int launch(const float* A, const float* B, const float* bias, float* C, int M, int N, int K,
           int lda, int ldb, int kt_per_split, int splits, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_tf32x3_kernel<A_K, B_K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        ALayout<A_K>::kSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  gemm_tf32x3_kernel<A_K, B_K><<<grid, kThreads, ALayout<A_K>::kSmem, stream>>>(
      A, B, bias, C, M, N, K, lda, ldb, kt_per_split);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// k a pipeline stage: the unit of kt_per_split below.
int gemm_tf32x3_stage_k(void) { return kBK; }

// C[M][N] = Σ_k A(m, k)·B(n, k) (+ bias[n]) over K, in 3×TF32.
// a_kmajor: A(m, k) = A[m·lda + k], else A[k·lda + m]; b_kmajor likewise
// with ldb. Only (1, 1), (1, 0) and (0, 0) are built. splits > 1 cuts the
// k range into `splits` pieces of kt_per_split stages of 32: each writes its
// partial sums to work[z][M][N], then the sum kernel writes C (and the
// bias). Every pointer 16-byte aligned, lda and ldb multiples of 4, and the
// extent along each operand's contiguous axis too (K where K-major, else M
// or N). Returns cudaGetLastError() after each
// launch (0 on success), cudaErrorInvalidValue for a layout not built.
int gemm_tf32x3(int a_kmajor, int b_kmajor, const void* A, const void* B, const void* bias,
                void* C, void* work, int M, int N, int K, int lda, int ldb, int splits,
                int kt_per_split, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  const float* b = static_cast<const float*>(B);
  const bool split = splits > 1;
  float* out = static_cast<float*>(split ? work : C);
  const float* bias_k = split ? nullptr : static_cast<const float*>(bias);
  int err;
  if (a_kmajor && b_kmajor)
    err = launch<true, true>(a, b, bias_k, out, M, N, K, lda, ldb, kt_per_split, splits, s);
  else if (a_kmajor && !b_kmajor)
    err = launch<true, false>(a, b, bias_k, out, M, N, K, lda, ldb, kt_per_split, splits, s);
  else if (!a_kmajor && !b_kmajor)
    err = launch<false, false>(a, b, bias_k, out, M, N, K, lda, ldb, kt_per_split, splits, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != 0 || !split) return err;
  const long long n4 = (long long)M * N / 4;
  const int threads = 256;
  gemm_splitk_sum_kernel<<<(unsigned)((n4 + threads - 1) / threads), threads, 0, s>>>(
      static_cast<const float4*>(work), static_cast<const float4*>(bias),
      static_cast<float4*>(C), n4, N / 4, splits);
  return (int)cudaGetLastError();
}

}  // extern "C"
