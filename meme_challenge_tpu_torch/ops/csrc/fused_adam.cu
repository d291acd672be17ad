// Fused Adam / AdamW update of every parameter leaf for Hopper (sm_90a)
//
// Replaces no TPU kernel: the JAX package leaves its optax chain
// (meme_challenge_tpu/train/optim.py) to XLA, which fuses it. The port ran
// the same chain as about twenty out-of-place torch._foreach_* ops plus a
// cast of each bf16 moment to fp32 and back, one leaf at a time: ≈ 1 000
// launches (UNITER-base, 212 leaves) or ≈ 2 000 (UNITER-large, 404 leaves) a
// step, a fresh tensor for every leaf of every op, and ≈ 200 bytes of device
// traffic a parameter. This kernel reads each element's parameter, gradient
// and two moments once and writes the parameter and the moments back in
// place: 20 bytes a parameter with fp32 parameters and bf16 moments (28 with
// fp32 moments). At 3.35 TB/s that is ≥ 0.66 ms for UNITER-base's 110 M
// parameters and ≥ 2.0 ms for UNITER-large's 336 M: the update is bound by
// bytes, at well under one operation a byte.
//
// Arithmetic, each element, every operation an IEEE fp32 operation rounded
// to nearest (the __f*_rn intrinsics, so that nvcc contracts nothing into an
// FMA), in the order of the chain in train/optim.py:
//   g = g / div · mul                       (the global-norm clip's factors,
//                                            device scalars; skipped if none)
//   adam:  g = g + p·wd                     (L2 decay on the decayed leaves)
//   mu = mu·b1 + g·(1−b1);  nu = nu·b2 + (g·g)·(1−b2)
//   u = (mu·rc1) / (sqrt(nu·rc2) + eps)      rc = the float reciprocal of
//                                            the bias correction c: on a
//                                            card torch's _foreach_div by a
//                                            scalar multiplies by it
//   adamw: u = u + p·wd
//   u = u · scale · step;  p = p + u
// mu and nu are stored (bf16: __float2bfloat16_rn, as torch's cast) from
// the fp32 values the update used. The scalars are the chain's Python
// doubles, each rounded once to float as torch rounds a scalar for a float
// tensor. The result equals the chain's bit for bit.
//
// The three scalars that change from step to step (c1, c2 and the signed
// step size −lr·schedule) are read from a device buffer of three floats,
// written before the launch in stream order, and not passed by value: a
// CUDA graph that captured the launch replays it with each step's values.
// Each block divides 1 by c1 and c2 itself (__fdiv_rn, the host's float
// division of the same operands).
//
// Layout: one launch for up to kMaxLeaves leaves. The leaf table (pointers,
// sizes, decay flags, update scales and the prefix of each leaf's tiles)
// travels as a kernel parameter of ≈ 25 KB (CUDA 12.1's 32 764-byte limit),
// read through __grid_constant__ so that no thread copies it: no host copy,
// no pinned buffer to recycle, nothing to synchronise. A leaf is cut into
// tiles of kTile elements and each block takes one tile; it finds its leaf by
// a binary search of the tile prefix (uniform across the block, served by
// the constant cache). UNITER-base gives ≈ 27 000 blocks, UNITER-large
// ≈ 82 000, many waves over the 132 SMs. Where all four of a leaf's pointers
// are aligned (16 bytes for fp32, 8 for four bf16 values) a thread moves
// four elements at a time with 16-byte and 8-byte loads, kVec of them
// loaded before any is computed; a leaf's last n mod 4 elements, and every
// element of a leaf with an unaligned pointer, take the scalar path.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>
#include <cstring>

namespace {

constexpr int kMaxLeaves = 512;
constexpr int kThreads = 256;
constexpr int kVec = 4;                       // 4-element vectors a thread a tile
constexpr int kTile = kThreads * 4 * kVec;    // 4 096 elements a block

struct Table {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  void* mu[kMaxLeaves];
  void* nu[kMaxLeaves];
  long long numel[kMaxLeaves];
  int tile0[kMaxLeaves + 1];                  // first tile of each leaf; [n] = all
  float scale[kMaxLeaves];
  unsigned char decay[kMaxLeaves];
  int n;
};

struct Scalars {
  float b1, omb1, b2, omb2, eps, wd;
  const float* sched;                         // c1, c2, step on the device
  const float* clip_div;                      // null: no clip
  const float* clip_mul;
  int adamw;
};

static_assert(sizeof(Table) + sizeof(Scalars) <= 32764,
              "the leaf table must fit CUDA's kernel parameter limit");

template <typename T>
struct Moment;

template <>
struct Moment<float> {
  static constexpr int kAlign = 16;
  static __device__ __forceinline__ float load(const void* b, long long i) {
    return static_cast<const float*>(b)[i];
  }
  static __device__ __forceinline__ void store(void* b, long long i, float v) {
    static_cast<float*>(b)[i] = v;
  }
  static __device__ __forceinline__ void load4(const void* b, long long i,
                                               float* v) {
    const float4 x = *reinterpret_cast<const float4*>(
        static_cast<const float*>(b) + i);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  }
  static __device__ __forceinline__ void store4(void* b, long long i,
                                                const float* v) {
    *reinterpret_cast<float4*>(static_cast<float*>(b) + i) =
        make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Moment<__nv_bfloat16> {
  static constexpr int kAlign = 8;
  static __device__ __forceinline__ float load(const void* b, long long i) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(b)[i]);
  }
  static __device__ __forceinline__ void store(void* b, long long i, float v) {
    static_cast<__nv_bfloat16*>(b)[i] = __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ void load4(const void* b, long long i,
                                               float* v) {
    const uint2 raw = *reinterpret_cast<const uint2*>(
        static_cast<const __nv_bfloat16*>(b) + i);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    v[0] = __low2float(lo); v[1] = __high2float(lo);
    v[2] = __low2float(hi); v[3] = __high2float(hi);
  }
  static __device__ __forceinline__ void store4(void* b, long long i,
                                                const float* v) {
    const __nv_bfloat162 lo = __halves2bfloat162(__float2bfloat16_rn(v[0]),
                                                 __float2bfloat16_rn(v[1]));
    const __nv_bfloat162 hi = __halves2bfloat162(__float2bfloat16_rn(v[2]),
                                                 __float2bfloat16_rn(v[3]));
    uint2 raw;
    raw.x = *reinterpret_cast<const unsigned int*>(&lo);
    raw.y = *reinterpret_cast<const unsigned int*>(&hi);
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(b) + i) = raw;
  }
};

struct Leaf {
  bool clip, decay, adamw;
  float div, mul, scale, rc1, rc2, step;
};

// One element: p, mu, nu updated in registers from g (see the notes above).
__device__ __forceinline__ void update(const Scalars& s, const Leaf& l,
                                       float& p, float g, float& m, float& v) {
  if (l.clip) g = __fmul_rn(__fdiv_rn(g, l.div), l.mul);
  if (l.decay && !l.adamw) g = __fadd_rn(g, __fmul_rn(p, s.wd));
  m = __fadd_rn(__fmul_rn(m, s.b1), __fmul_rn(g, s.omb1));
  v = __fadd_rn(__fmul_rn(v, s.b2), __fmul_rn(__fmul_rn(g, g), s.omb2));
  float u = __fdiv_rn(__fmul_rn(m, l.rc1),
                      __fadd_rn(__fsqrt_rn(__fmul_rn(v, l.rc2)), s.eps));
  if (l.decay && l.adamw) u = __fadd_rn(u, __fmul_rn(p, s.wd));
  u = __fmul_rn(__fmul_rn(u, l.scale), l.step);
  p = __fadd_rn(p, u);
}

// MT, NT: the storage types of mu and nu (float or __nv_bfloat16)
template <typename MT, typename NT>
__global__ void __launch_bounds__(kThreads)
    adam_update_kernel(const __grid_constant__ Table t,
                       const __grid_constant__ Scalars s) {
  using M = Moment<MT>;
  using N = Moment<NT>;
  const int tile = blockIdx.x;
  int lo = 0, hi = t.n - 1;  // the last leaf whose first tile is <= tile
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.tile0[mid] <= tile) lo = mid; else hi = mid - 1;
  }
  const int i = lo;
  const long long base = (long long)(tile - t.tile0[i]) * kTile;
  const long long left = t.numel[i] - base;
  const int count = left < kTile ? (int)left : kTile;
  float* p = t.p[i] + base;
  const float* g = t.g[i] + base;
  // the moments stay untyped void*: offset them in elements by load/store
  void* mu = t.mu[i];
  void* nu = t.nu[i];

  Leaf l;
  l.clip = s.clip_div != nullptr;
  l.div = l.clip ? *s.clip_div : 1.f;
  l.mul = l.clip ? *s.clip_mul : 1.f;
  l.decay = t.decay[i] != 0;
  l.adamw = s.adamw != 0;
  l.scale = t.scale[i];
  l.rc1 = __fdiv_rn(1.f, s.sched[0]);
  l.rc2 = __fdiv_rn(1.f, s.sched[1]);
  l.step = s.sched[2];

  const bool aligned =
      (reinterpret_cast<uintptr_t>(t.p[i]) % 16 == 0) &&
      (reinterpret_cast<uintptr_t>(t.g[i]) % 16 == 0) &&
      (reinterpret_cast<uintptr_t>(mu) % M::kAlign == 0) &&
      (reinterpret_cast<uintptr_t>(nu) % N::kAlign == 0);
  int done = 0;
  if (aligned) {
    const int end = count / 4 * 4;  // base is a multiple of 4: still aligned
    float4 pv[kVec], gv[kVec];
    float mv[kVec][4], vv[kVec][4];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {  // every load in flight before any math
      const int e = (k * kThreads + threadIdx.x) * 4;
      if (e < end) {
        pv[k] = *reinterpret_cast<const float4*>(p + e);
        gv[k] = *reinterpret_cast<const float4*>(g + e);
        M::load4(mu, base + e, mv[k]);
        N::load4(nu, base + e, vv[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int e = (k * kThreads + threadIdx.x) * 4;
      if (e < end) {
        update(s, l, pv[k].x, gv[k].x, mv[k][0], vv[k][0]);
        update(s, l, pv[k].y, gv[k].y, mv[k][1], vv[k][1]);
        update(s, l, pv[k].z, gv[k].z, mv[k][2], vv[k][2]);
        update(s, l, pv[k].w, gv[k].w, mv[k][3], vv[k][3]);
        *reinterpret_cast<float4*>(p + e) = pv[k];
        M::store4(mu, base + e, mv[k]);
        N::store4(nu, base + e, vv[k]);
      }
    }
    done = end;
  }
  for (int e = done + threadIdx.x; e < count; e += kThreads) {
    float pe = p[e], m = M::load(mu, base + e), v = N::load(nu, base + e);
    update(s, l, pe, g[e], m, v);
    p[e] = pe;
    M::store(mu, base + e, m);
    N::store(nu, base + e, v);
  }
}

template <typename M, typename N>
int launch(const Table& t, const Scalars& s, cudaStream_t st) {
  adam_update_kernel<M, N><<<t.tile0[t.n], kThreads, 0, st>>>(t, s);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Largest number of leaves one launch takes; the wrapper splits longer
// lists into launches of at most this many.
int fused_adam_max_leaves(void) { return kMaxLeaves; }

// p, g: n float32 leaves; mu, nu: n leaves of float32 (dtype 0) or bfloat16
// (dtype 1), each as many elements as its p, all contiguous, given as arrays
// of device addresses. numel, scale (the update scale, 1.0 for none) and
// decay (0 or 1) per leaf, on the host. clip_div / clip_mul: device
// addresses of the clip's two fp32 scalars, both null for no clip; sched:
// the device address of c1, c2 and step (three floats). The other scalars
// are those of the notes above. Returns cudaGetLastError() after the
// launch (0 on success), cudaErrorInvalidValue for n outside
// [1, kMaxLeaves], a dtype code other than 0 and 1, or more tiles than a
// grid holds.
int fused_adam(int mu_dtype, int nu_dtype, int adamw, int n,
               const unsigned long long* p, const unsigned long long* g,
               const unsigned long long* mu, const unsigned long long* nu,
               const long long* numel, const float* scale,
               const unsigned char* decay, const void* clip_div,
               const void* clip_mul, const void* sched, float b1, float omb1,
               float b2, float omb2, float eps, float wd, void* stream) {
  if (n < 1 || n > kMaxLeaves || mu_dtype < 0 || mu_dtype > 1 ||
      nu_dtype < 0 || nu_dtype > 1 || sched == nullptr)
    return (int)cudaErrorInvalidValue;
  Table t;
  std::memset(&t, 0, sizeof(t));
  long long tiles = 0;
  for (int i = 0; i < n; ++i) {
    t.p[i] = reinterpret_cast<float*>(p[i]);
    t.g[i] = reinterpret_cast<const float*>(g[i]);
    t.mu[i] = reinterpret_cast<void*>(mu[i]);
    t.nu[i] = reinterpret_cast<void*>(nu[i]);
    t.numel[i] = numel[i];
    t.scale[i] = scale[i];
    t.decay[i] = decay[i];
    t.tile0[i] = (int)tiles;
    tiles += (numel[i] + kTile - 1) / kTile;
    if (tiles > INT_MAX) return (int)cudaErrorInvalidValue;
  }
  t.tile0[n] = (int)tiles;
  t.n = n;
  if (tiles == 0) return 0;
  const Scalars s{b1, omb1, b2, omb2, eps, wd,
                  static_cast<const float*>(sched),
                  static_cast<const float*>(clip_div),
                  static_cast<const float*>(clip_mul), adamw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mu_dtype == 0 && nu_dtype == 0) return launch<float, float>(t, s, st);
  if (mu_dtype == 0) return launch<float, __nv_bfloat16>(t, s, st);
  if (nu_dtype == 0) return launch<__nv_bfloat16, float>(t, s, st);
  return launch<__nv_bfloat16, __nv_bfloat16>(t, s, st);
}

}  // extern "C"
