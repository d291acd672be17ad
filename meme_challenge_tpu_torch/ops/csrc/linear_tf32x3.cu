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
//
// A row list (LIST): the encoder's rows are [B·S] tokens of which about
// half are padding, and nothing reads a padded row's output. The wrapper
// then hands a list built on the device from the key mask: rows[0] the
// count of valid rows, rows[1 .. M] their positions first, ascending, then
// the padded ones. Forward and dgrad gather A's rows through the list and
// scatter C's rows back through it, and write zeros to the rows at list
// positions ≥ count (a NaN there would reach valid rows through P·V with
// P = 0); wgrad takes the list's first `count` rows as its k range. The
// host never reads the count, so a captured step replays with each batch's
// own list: the grid is sized for the whole M, and which block does which
// tile over which k range follows the count through a plan the host made
// for every count (plan[u] = (splits, stages a split) for u row tiles of
// 128, or for wgrad u stages of 32); a block with no work exits. The plan
// at count = M is the no-list plan, so an all-valid list gives the no-list
// bits. The instantiations without a list compile to the code they had.
//
// The experts of an MoE layer (ops/expert_linear.py) take the same tile
// (gemm_tile) in a second kernel, expert_gemm_tf32x3_kernel: one grid slice
// an expert, whose rows (forward, dgrad) or k range (wgrad) are the
// expert's group of the row-sorted operands, its bounds read on the device
// from an offsets array. A group's size is data: the host never reads it,
// so a captured train step replays without a sync. The grid's row extent
// is the bound of a group's rows; a block past its group's end exits at
// once. No split-K: an expert's wgrad runs over its own rows only.
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
//   Else (X[k·ld + row]): chunk c is k 8·(p / 32) + c, row quad p % 32;
//   with GATHER, k is a position of the row list and the row read is
//   order[k] (wgrad's x).
template <bool KMAJOR, bool GATHER>
__device__ __forceinline__ void copy_tile(float4* raw, const float* __restrict__ X, int ld,
                                          int row0, int rows, int k0, int K, int p,
                                          const int* __restrict__ order) {
  static_assert(!(KMAJOR && GATHER), "a list gathers the k of an M-major operand only");
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    int row, k;
    const float* src;
    if (KMAJOR) {
      row = row0 + (p >> 3) + 16 * c; k = k0 + 4 * (p & 7);
      src = X + (size_t)row * ld + k;
    } else {
      row = row0 + 4 * (p & 31); k = k0 + 8 * (p >> 5) + c;
      const int kr = GATHER ? (k < K ? __ldg(order + k) : 0) : k;
      src = X + (size_t)kr * ld + row;
    }
    const bool ok = row < rows && k < K;
    cp_async16_zfill(raw + c * 128 + p, ok ? src : X, ok);
  }
}

// A's 128 × 32 tile of a stage, fp32, copied (cp.async, zero past the
// matrix) into its padded ALayout rows; a warp's copy is 512 contiguous
// bytes or four 128-byte rows. With GATHER, m (K-major: forward, dgrad) or
// k (else: wgrad) is a position of the row list: a K-major row is read from
// a_row[i], the thread's rows looked up once a tile, a k from order[k].
template <bool A_K, bool GATHER>
__device__ __forceinline__ void copy_a(float* dst, const float* __restrict__ A, int lda,
                                       int m0, int M, int k0, int K, int p,
                                       const int* __restrict__ order, const int (&a_row)[8]) {
  using L = ALayout<A_K>;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int c = p + 128 * i;
    int m, k;
    const float* src;
    float* to;
    if (A_K) {
      m = m0 + (c >> 3); k = k0 + 4 * (c & 7);
      src = A + (size_t)(GATHER ? a_row[i] : m) * lda + k;
      to = dst + (c >> 3) * L::kLd + 4 * (c & 7);
    } else {
      k = k0 + (c >> 5); m = m0 + 4 * (c & 31);
      const int kr = GATHER ? (k < K ? __ldg(order + k) : 0) : k;
      src = A + (size_t)kr * lda + m; to = dst + (c >> 5) * L::kLd + 4 * (c & 31);
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

// One block's 128 × 128 tile at (m0, n0) of C[M][N] = Σ_k A(m, k)·B(n, k)
// (+ bias[n]) over the nk stages of 32 k from stage kt0, written to `out`
// (row stride N). The body of both kernels below.
// LIST: `order` is the row list past its count. A K-major A (forward,
// dgrad) reads its row m < M (M the count) from order[m]; with `scatter`
// (= order) the tile's row at list position m < rows_out is written to
// out's row order[m], as zeros where m ≥ M; without it, out's row m for
// m < M (a split's partial). Else (wgrad) the k < K (the count) of A and B
// read row order[k].
template <bool A_K, bool B_K, bool LIST = false>
__device__ __forceinline__ void gemm_tile(const float* __restrict__ A,
                                          const float* __restrict__ B,
                                          const float* __restrict__ bias,
                                          float* __restrict__ out, int M, int N, int K,
                                          int lda, int ldb, int m0, int n0, int kt0,
                                          int nk, const int* __restrict__ order = nullptr,
                                          const int* __restrict__ scatter = nullptr,
                                          int rows_out = 0) {
  using L = ALayout<A_K>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (mma::smem_addr(smem_raw) & 1023)) & 1023);
  float* a_ring = reinterpret_cast<float*>(smem + kStages * kBStage);
  float4* b_raw = reinterpret_cast<float4*>(a_ring + kRing * L::kFloats);
  uint64_t* full = reinterpret_cast<uint64_t*>(b_raw + kRing * (kBRaw / 16));
  uint64_t* empty = full + kStages;
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
    // a K-major A's rows are the same in every stage: looked up once
    int a_row[8] = {};
    if constexpr (LIST && A_K) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = m0 + (p >> 3) + 16 * i;
        a_row[i] = m < M ? __ldg(order + m) : 0;
      }
    }
    // one cp.async group a stage (A into its ring, B raw), kLead ahead of
    // the split; an empty group past the end keeps the count
    auto issue = [&](int i) {
      if (i < nk) {
        const int k0 = (kt0 + i) * kBK;
        copy_a<A_K, LIST>(a_ring + (i % kRing) * L::kFloats, A, lda, m0, M, k0, K, p, order,
                          a_row);
        copy_tile<B_K, LIST && !A_K>(b_raw + (i % kRing) * 8 * 128, B, ldb, n0, N, k0, K, p,
                                     order);
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

  // epilogue
  if constexpr (LIST && A_K) {
    if (scatter != nullptr) {
      // the thread's two rows, by list position: written to order[pos], or
      // zeros past the count
      int to[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pos = m0 + r + 8 * h;
        to[h] = pos < rows_out ? __ldg(scatter + pos) : -1;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        if (col >= N) continue;
        float b0 = 0.f, b1 = 0.f;
        if (bias != nullptr) { b0 = bias[col]; b1 = bias[col + 1]; }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (to[h] < 0) continue;
          float2 o = make_float2(0.f, 0.f);
          if (m0 + r + 8 * h < M) {
            o = make_float2(d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
            if (bias != nullptr) { o.x += b0; o.y += b1; }
          }
          *reinterpret_cast<float2*>(out + (size_t)to[h] * N + col) = o;
        }
      }
      return;
    }
  }
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

// zeros to the 128 × 128 tile at list positions m0.., columns n0.. of
// C[M][N], each row written at its listed row order[m]
__device__ __forceinline__ void zero_tile(float* __restrict__ C, int M, int N,
                                          const int* __restrict__ order, int m0, int n0) {
  for (int e = threadIdx.x; e < kBM * (kBN / 4); e += kThreads) {
    const int m = m0 + e / (kBN / 4), col = n0 + 4 * (e % (kBN / 4));
    if (m < M && col < N)
      *reinterpret_cast<float4*>(C + (size_t)__ldg(order + m) * N + col) =
          make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// Without a list: tile (blockIdx.y, blockIdx.x), split blockIdx.z, whose
// partials go to slice blockIdx.z of the workspace C.
// LIST: a 1-D grid; rows[0] the count, rows + 1 the order; plan[u] =
// (splits, stages a split) for u units of the count (row tiles where A is
// K-major, else stages). One split: block b is tile (b / tiles_n,
// b % tiles_n) of C, zeros where the tile lies past the count. More: block
// b is split b / active of tile b % active of the `active` tiles the count
// covers, its partial in work[split] (by list position).
template <bool A_K, bool B_K, bool LIST>
__global__ void __launch_bounds__(kThreads, 1)
gemm_tf32x3_kernel(const float* __restrict__ A, const float* __restrict__ B,
                   const float* __restrict__ bias, float* __restrict__ C, int M, int N,
                   int K, int lda, int ldb, int kt_per_split, float* __restrict__ work,
                   const int* __restrict__ rows, const int2* __restrict__ plan) {
  if constexpr (!LIST) {
    const int kt0 = blockIdx.z * kt_per_split;
    const int nk = max(0, min((K + kBK - 1) / kBK - kt0, kt_per_split));
    // split partials go to slice blockIdx.z of the workspace
    gemm_tile<A_K, B_K>(A, B, bias, C + (size_t)blockIdx.z * M * N, M, N, K, lda, ldb,
                        blockIdx.y * kBM, blockIdx.x * kBN, kt0, nk);
  } else {
    const int count = __ldg(rows), b = blockIdx.x;
    const int* order = rows + 1;
    const int tiles_n = (N + kBN - 1) / kBN;
    if constexpr (A_K) {  // forward, dgrad: the list's positions are C's rows
      const int2 pl = __ldg(plan + (count + kBM - 1) / kBM);
      const int stages = (K + kBK - 1) / kBK;
      if (pl.x == 1) {
        if (b >= ((M + kBM - 1) / kBM) * tiles_n) return;
        const int m0 = (b / tiles_n) * kBM, n0 = (b % tiles_n) * kBN;
        if (m0 >= count) {
          zero_tile(C, M, N, order, m0, n0);
          return;
        }
        gemm_tile<A_K, B_K, true>(A, B, bias, C, count, N, K, lda, ldb, m0, n0, 0, stages,
                                  order, order, M);
      } else {
        const int active = ((count + kBM - 1) / kBM) * tiles_n;
        if (b >= active * pl.x) return;
        const int z = b / active, j = b % active, kt0 = z * pl.y;
        gemm_tile<A_K, B_K, true>(A, B, nullptr, work + (size_t)z * M * N, count, N, K, lda,
                                  ldb, (j / tiles_n) * kBM, (j % tiles_n) * kBN, kt0,
                                  max(0, min(stages - kt0, pl.y)), order);
      }
    } else {  // wgrad: the list's positions are the k range
      const int stages = (count + kBK - 1) / kBK;
      const int2 pl = __ldg(plan + stages);
      const int tiles = ((M + kBM - 1) / kBM) * tiles_n;
      const int z = b / tiles, j = b % tiles, kt0 = z * pl.y;
      if (z >= pl.x) return;
      gemm_tile<A_K, B_K, true>(A, B, nullptr, pl.x > 1 ? work + (size_t)z * M * N : C, M, N,
                                count, lda, ldb, (j / tiles_n) * kBM, (j % tiles_n) * kBN, kt0,
                                max(0, min(stages - kt0, pl.y)), order);
    }
  }
}

// The experts' products: one group of rows a grid slice z = the expert,
// the group's bounds read from offsets[z], offsets[z + 1] on the device
// (int32, ascending), so no host ever reads a group's size and a CUDA
// graph captures the launch.
//   ROWS (forward, dgrad): the group's rows of A and C, each group's B its
//   own slab (b_stride floats apart): C[lo + m][N] over K. A block whose
//   first row lies past the group's end exits at once; the grid's y extent
//   is the bound of a group's rows.
//   Else (wgrad): the group's rows are the k range of A and B (each read
//   M- or N-major), C the group's own [M][N] slab. An empty group writes
//   zeros.
template <bool A_K, bool B_K, bool ROWS>
__global__ void __launch_bounds__(kThreads, 1)
expert_gemm_tf32x3_kernel(const float* __restrict__ A, const float* __restrict__ B,
                          float* __restrict__ C, const int* __restrict__ offsets, int M,
                          int N, int K, int lda, int ldb, long long b_stride) {
  const int z = blockIdx.z;
  const int lo = offsets[z], hi = offsets[z + 1];
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  if (ROWS) {
    const int rows = hi - lo;
    if (m0 >= rows) return;
    gemm_tile<A_K, B_K>(A + (size_t)lo * lda, B + (size_t)z * b_stride, nullptr,
                        C + (size_t)lo * N, rows, N, K, lda, ldb, m0, n0, 0,
                        (K + kBK - 1) / kBK);
  } else {
    const int depth = hi - lo;
    gemm_tile<A_K, B_K>(A + (size_t)lo * lda, B + (size_t)lo * ldb, nullptr,
                        C + (size_t)z * M * N, M, N, depth, lda, ldb, m0, n0, 0,
                        (depth + kBK - 1) / kBK);
  }
}

// C = Σ_z work[z] (+ bias), z in order; four elements a thread.
// LIST: the splits are the plan's for the count (none: the GEMM wrote C,
// and this launch does nothing), `unit` the rows (or k) of a plan step;
// with `scatter` the partials' rows are list positions: the sum of position
// m < count goes to C's row order[m], zeros past the count.
template <bool LIST>
__global__ void gemm_splitk_sum_kernel(const float4* __restrict__ work,
                                       const float4* __restrict__ bias, float4* __restrict__ C,
                                       long long n4, int n_quads, int splits,
                                       const int* __restrict__ rows,
                                       const int2* __restrict__ plan, int unit, int scatter) {
  int count = 0;
  if (LIST) {
    count = __ldg(rows);
    splits = __ldg(plan + (count + unit - 1) / unit).x;
    if (splits == 1) return;
  }
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  long long to = i;
  if (LIST && scatter) {
    const long long m = i / n_quads;
    to = (long long)__ldg(rows + 1 + m) * n_quads + i % n_quads;
    if (m >= count) {
      C[to] = make_float4(0.f, 0.f, 0.f, 0.f);
      return;
    }
  }
  float4 acc = work[i];
  for (int z = 1; z < splits; ++z) {
    const float4 w = work[(long long)z * n4 + i];
    acc.x += w.x; acc.y += w.y; acc.z += w.z; acc.w += w.w;
  }
  if (bias != nullptr) {
    const float4 b = bias[i % n_quads];
    acc.x += b.x; acc.y += b.y; acc.z += b.z; acc.w += b.w;
  }
  C[to] = acc;
}

// without a list the grid is (N tiles, M tiles, splits); with one,
// `blocks` along x (the largest plan's)
template <bool A_K, bool B_K, bool LIST>
int launch(const float* A, const float* B, const float* bias, float* C, int M, int N, int K,
           int lda, int ldb, int kt_per_split, int splits, float* work, const int* rows,
           const int2* plan, int blocks, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_tf32x3_kernel<A_K, B_K, LIST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        ALayout<A_K>::kSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid = LIST ? dim3(blocks) : dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  gemm_tf32x3_kernel<A_K, B_K, LIST><<<grid, kThreads, ALayout<A_K>::kSmem, stream>>>(
      A, B, bias, C, M, N, K, lda, ldb, kt_per_split, work, rows, plan);
  return (int)cudaGetLastError();
}

template <bool A_K, bool B_K, bool ROWS>
int launch_expert(const float* A, const float* B, float* C, const int* offsets, int groups,
                  int grid_rows, int M, int N, int K, int lda, int ldb, long long b_stride,
                  cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        expert_gemm_tf32x3_kernel<A_K, B_K, ROWS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, ALayout<A_K>::kSmem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((N + kBN - 1) / kBN, (grid_rows + kBM - 1) / kBM, groups);
  expert_gemm_tf32x3_kernel<A_K, B_K, ROWS>
      <<<grid, kThreads, ALayout<A_K>::kSmem, stream>>>(A, B, C, offsets, M, N, K, lda, ldb,
                                                        b_stride);
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
    err = launch<true, true, false>(a, b, bias_k, out, M, N, K, lda, ldb, kt_per_split, splits,
                                    nullptr, nullptr, nullptr, 0, s);
  else if (a_kmajor && !b_kmajor)
    err = launch<true, false, false>(a, b, bias_k, out, M, N, K, lda, ldb, kt_per_split, splits,
                                     nullptr, nullptr, nullptr, 0, s);
  else if (!a_kmajor && !b_kmajor)
    err = launch<false, false, false>(a, b, bias_k, out, M, N, K, lda, ldb, kt_per_split,
                                      splits, nullptr, nullptr, nullptr, 0, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != 0 || !split) return err;
  const long long n4 = (long long)M * N / 4;
  const int threads = 256;
  gemm_splitk_sum_kernel<false><<<(unsigned)((n4 + threads - 1) / threads), threads, 0, s>>>(
      static_cast<const float4*>(work), static_cast<const float4*>(bias),
      static_cast<float4*>(C), n4, N / 4, splits, nullptr, nullptr, 0, 0);
  return (int)cudaGetLastError();
}

// The same product over a row list (int32 on the device: rows[0] the count
// of valid rows, rows[1 .. L] the list, L = M where A is K-major, else K).
// a_kmajor (forward, dgrad: A(m, k) = A[m·lda + k], then b_kmajor as
// above): C's rows are the list's, A's read and C's written through it, the
// rows past the count zeros. Else (wgrad, b_kmajor 0): the k range is the
// list's first `count` rows of A and B. plan[u] (int2, on the device) is
// (splits, stages a split) for u row tiles of 128 (a_kmajor) or u stages
// of 32 of the count; `blocks` the grid (the most any plan needs);
// `max_splits` > 1 has a second launch sum the partials from work (room for
// max_splits slices of M × N) where the count's plan splits. Returns
// cudaGetLastError() after each launch.
int gemm_tf32x3_list(int a_kmajor, int b_kmajor, const void* A, const void* B,
                     const void* bias, void* C, void* work, int M, int N, int K, int lda,
                     int ldb, const void* rows, const void* plan, int blocks, int max_splits,
                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  const float* b = static_cast<const float*>(B);
  const float* bi = static_cast<const float*>(bias);
  float* c = static_cast<float*>(C);
  float* w = static_cast<float*>(work);
  const int* r = static_cast<const int*>(rows);
  const int2* pl = static_cast<const int2*>(plan);
  int err;
  if (a_kmajor && b_kmajor)
    err = launch<true, true, true>(a, b, bi, c, M, N, K, lda, ldb, 0, 0, w, r, pl, blocks, s);
  else if (a_kmajor && !b_kmajor)
    err = launch<true, false, true>(a, b, bi, c, M, N, K, lda, ldb, 0, 0, w, r, pl, blocks, s);
  else if (!a_kmajor && !b_kmajor && bias == nullptr)
    err = launch<false, false, true>(a, b, nullptr, c, M, N, K, lda, ldb, 0, 0, w, r, pl, blocks,
                                     s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != 0 || max_splits < 2) return err;
  const long long n4 = (long long)M * N / 4;
  const int threads = 256;
  gemm_splitk_sum_kernel<true><<<(unsigned)((n4 + threads - 1) / threads), threads, 0, s>>>(
      static_cast<const float4*>(work), static_cast<const float4*>(bias),
      static_cast<float4*>(C), n4, N / 4, 0, r, pl, a_kmajor ? kBM : kBK, a_kmajor);
  return (int)cudaGetLastError();
}

// The experts' products over `groups` groups of rows, offsets[groups + 1]
// (int32 on the device) their bounds in the row-sorted operands; every
// operand float32, contiguous, 16-byte aligned, every width a multiple of 4.
//   product 0, forward: Y[r][N] = X[r][K]·W[g]ᵀ, W [groups][N][K];
//   product 1, dgrad:   DX[r][K] = DY[r][N]·W[g], W [groups][N][K];
//   product 2, wgrad:   DW[g][N][K] = Σ_r DY[r][N]ᵀ·X[r][K] over g's rows.
// `rows_bound` bounds a group's rows (forward, dgrad: the grid's row
// extent; blocks past a group's end exit). Returns cudaGetLastError().
int expert_gemm_tf32x3(int product, const void* X, const void* W, void* Y,
                       const void* offsets, int groups, int rows_bound, int N, int K,
                       void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* x = static_cast<const float*>(X);
  const float* w = static_cast<const float*>(W);
  float* y = static_cast<float*>(Y);
  const int* off = static_cast<const int*>(offsets);
  const long long slab = (long long)N * K;
  switch (product) {
    case 0:  // A = X (K-major), B = W[g] (K-major): rows × N over K
      return launch_expert<true, true, true>(x, w, y, off, groups, rows_bound, 0, N, K, K, K,
                                             slab, s);
    case 1:  // A = DY (K-major over N), B = W[g] read N-major: rows × K over N
      return launch_expert<true, false, true>(x, w, y, off, groups, rows_bound, 0, K, N, N, K,
                                              slab, s);
    case 2:  // A = DY read M-major, B = X read M-major: N × K over g's rows
      return launch_expert<false, false, false>(x, w, y, off, groups, N, N, K, 0, N, K, 0, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
