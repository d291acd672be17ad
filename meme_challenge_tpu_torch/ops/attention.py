"""Fused multi-head attention, ``dropout(softmax(q·kᵀ·scale + bias))·v``, and
its gradient.

Counterpart of ``meme_challenge_tpu/ops/attention.py``. The two Pallas
forward kernels there (``_fwd_kernel``, one program per sample, and
``_blk_fwd_kernel``, ``_largest_block(B·H)`` (sample, head) pairs per grid
step) become one hand-written CUDA kernel for Hopper,
``csrc/fused_attention.cu``, in two seed modes; the two backward kernels
(``_bwd_kernel``, ``_blk_bwd_kernel``) likewise become
``csrc/fused_attention_bwd.cu``. Both keep the scores, the probabilities and
the dropout mask out of device memory, as the TPU kernels did: the backward
recomputes them.

- :func:`fused_attention` and :func:`fused_attention_blocked` keep the JAX
  signatures and layouts: q/k/v ``[B, H, S, D]`` in float32 or bfloat16,
  additive key bias ``[B, 1, 1, S]``, int32 ``seeds`` (per sample, or per
  block of :func:`blocked_seed_count`).
- A tensor on the CPU takes the plain PyTorch version beside each kernel
  (:func:`fused_attention_plain`, :func:`fused_attention_blocked_plain`).
  A CUDA tensor launches the kernel or raises; nothing falls back.
- Dropout bits are the JAX interpret-mode hash (:func:`_hash_bits`), so the
  masks of the kernel, the plain version and JAX on the CPU are equal bit
  for bit. The TPU's hardware PRNG stream is not reproduced.
- The custom-VJP rules (``_fwd_rule``/``_bwd_rule`` and the blocked pair)
  become a ``torch.autograd.Function`` per wrapper. It saves q, k, v, the
  bias rows and the seeds (never P or the mask; on the ``mma_tf32x3`` route
  also the output and its row statistics); its backward launches the
  backward kernel for CUDA tensors and :func:`fused_attention_bwd_plain` for
  CPU tensors. The bias and the seeds get no gradient.
- Each CUDA source holds three bodies, and :func:`attention_route`, a pure
  function of (dtype, S, D), picks one for a launch: ``mma_bf16``
  (bfloat16 on the tensor cores, ``mma.sync``) and ``mma_tf32x3`` (float32
  on the tensor cores, three TF32 products a product) where their register
  tile and shared memory hold the shape, else ``cuda_core`` (fp32 math on
  the CUDA cores). On the ``mma_tf32x3`` route the forward also writes each
  row's max and sum of exp, and the autograd function saves them with the
  output for the backward's single launch.

- ``folds=F`` (default 1) runs F folds of one model in one launch, the folds
  in the kernel's batch axis (``[F·B, H, S, D]``, fold-major): what JAX's
  ``vmap`` of the ``pallas_call`` over a fold axis computes, one grid a fold.
  Per-sample seeds are the folds' ``[B]`` seeds concatenated. The pair
  block is ``_largest_block(B·H)`` of one fold and the seeds are
  ``F × blocked_seed_count(B, H)``, fold-major, so no block, seed or hash
  index straddles two folds. The kernels need no change: the seed group is
  a launch argument.

- ``shard=SeedShard(...)`` runs a slice of each fold's (sample, head) pairs
  with the dropout of the run that holds them all: a rank of a ``data``
  mesh axis holds some rows of each fold's micro-batch, a rank of a
  ``model`` axis some heads. Pair ``(b, h)`` of the launch is hashed as its
  global pair ``(row0 + b)·heads + head0 + h`` of its fold: the seed and the
  in-block index come from that pair, and the pair block is the one of the
  whole fold (``_largest_block(rows·heads)``), so the dropped positions
  equal the whole run's slice (``csrc/attention_common.cuh: SeedMap``).

``LAUNCHES`` counts the kernel launches of each wrapper, forward and backward;
``ROUTE_LAUNCHES`` the same launches by (wrapper, route).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

LAUNCHES = {"fused_attention": 0, "fused_attention_blocked": 0,
            "fused_attention_bwd": 0, "fused_attention_blocked_bwd": 0}
ROUTES = ("mma_bf16", "mma_tf32x3", "cuda_core")
ROUTE_LAUNCHES = {(name, route): 0 for name in LAUNCHES
                  for route in ROUTES}

_MASK32 = 0xFFFFFFFF


# --------------------------------------------------------------------------
# Route: which CUDA body a launch takes (csrc/mma_bf16.cuh, the notes of
# csrc/fused_attention.cu and csrc/fused_attention_bwd.cu)
# --------------------------------------------------------------------------

MMA_MAX_S = 160     # scores of 16 query rows × every key held in registers
MMA_MAX_D = 128
MMA_FWD_TILES = 5   # 16-row query tiles of one forward block
MAX_SMEM = 232448   # shared memory one block may take on Hopper (227 KB)


def _pad16(n: int) -> int:
    return (n + 15) // 16 * 16


def mma_smem_bytes(S: int, D: int, backward: bool = False) -> int:
    """Dynamic shared memory of one ``mma_bf16`` block: K, V (and the
    backward's Q and dout) of the pair and the forward block's Q rows as bf16
    rows padded to ``pad16(D) + 8``, the backward's bf16 pd and ds tiles
    ``[pad16(S)][pad16(S) + 8]``, and the fp32 bias row."""
    s_pad, ld = _pad16(S), _pad16(D) + 8
    if backward:
        elems = 4 * s_pad * ld + 2 * s_pad * (s_pad + 8)
    else:
        elems = (2 * s_pad + 16 * min(MMA_FWD_TILES, s_pad // 16)) * ld
    return 2 * elems + 4 * s_pad


TF32_BWD_MAX_D = 64  # dk and dv of a warp's 16 keys held in registers
TF32_CHUNK = 32      # query rows the backward block takes a step


def tf32_smem_bytes(S: int, D: int, backward: bool = False) -> int:
    """Dynamic shared memory of one ``mma_tf32x3`` block, fp32 throughout.
    Forward: K and the block's Q rows padded to ``pad16(D) + 8``, V to
    ``pad16(D) + 4``, the bias row. Backward: K, V and two stages of the Q
    and dout chunks (``TF32_CHUNK`` rows) padded to ``pad16(D) + 4``, the dS
    chunk ``[TF32_CHUNK][pad16(S) + 8]``, and five rows of ``pad16(S)`` (bias,
    each query's max, sum of exp, its reciprocal and Δ)."""
    s_pad, d_pad = _pad16(S), _pad16(D)
    if backward:
        floats = ((2 * s_pad + 4 * TF32_CHUNK) * (d_pad + 4)
                  + TF32_CHUNK * (s_pad + 8) + 5 * s_pad)
    else:
        q_rows = 16 * min(MMA_FWD_TILES, s_pad // 16)
        floats = ((s_pad + q_rows) * (d_pad + 8) + s_pad * (d_pad + 4)
                  + s_pad)
    return 4 * floats


def attention_route(dtype: torch.dtype, S: int, D: int,
                    backward: bool = False) -> str:
    """The CUDA body a launch on ``[B, H, S, D]`` tensors of ``dtype`` takes,
    from the shape alone: with S <= 160, D <= 128 (the float32 backward:
    D <= 64) and the block's shared memory within 227 KB, ``"mma_bf16"`` for
    bfloat16 (:func:`mma_smem_bytes`) and ``"mma_tf32x3"`` for float32
    (:func:`tf32_smem_bytes`); else ``"cuda_core"``."""
    if S > MMA_MAX_S or D > MMA_MAX_D:
        return "cuda_core"
    if dtype == torch.bfloat16 and mma_smem_bytes(S, D, backward) <= MAX_SMEM:
        return "mma_bf16"
    if (dtype == torch.float32 and (not backward or D <= TF32_BWD_MAX_D)
            and tf32_smem_bytes(S, D, backward) <= MAX_SMEM):
        return "mma_tf32x3"
    return "cuda_core"


# --------------------------------------------------------------------------
# Block-size policy of the pair-blocked kernel (unchanged from the JAX
# package, so the per-block seed contract holds)
# --------------------------------------------------------------------------

def _largest_block(g: int, cap: int = 24) -> int:
    # cap 24: the S=160 backward kernel at block 32 overflows the 16 MB
    # scoped-VMEM stack by 40 KB (measured on v5e); 24 leaves headroom
    for b in range(min(cap, g), 0, -1):
        if g % b == 0:
            return b
    return 1


def _fold_batch(batch: int, folds: int) -> int:
    """The batch of one fold of a fold-stacked ``[folds·B, ...]`` input."""
    if folds < 1 or batch % folds:
        raise ValueError("a batch of %d does not split into %d folds"
                         % (batch, folds))
    return batch // folds


def _fold_block(batch: int, num_heads: int, folds: int) -> int:
    """Pairs a block of :func:`fused_attention_blocked`: the largest block
    of ONE fold's ``B·H`` pairs."""
    return _largest_block(_fold_batch(batch, folds) * num_heads)


class SeedShard(NamedTuple):
    """The slice of each fold's (sample, head) pairs that a launch holds:
    its B / folds rows a fold are rows ``[row0, row0 + B / folds)`` of the
    fold's ``rows``, its H heads are heads ``[head0, head0 + H)`` of
    ``heads``. The launch takes the seeds of the whole run: ``folds × rows``
    per sample, ``blocked_seed_count(folds × rows, heads, folds)`` per
    block."""
    row0: int
    rows: int
    head0: int
    heads: int


# (group, rows a fold in the launch, rows a fold in the run, row0, heads in
# the run, head0): the kernels' SeedMap (csrc/attention_common.cuh)
SeedMapArgs = Tuple[int, int, int, int, int, int]


def _seed_map(batch: int, num_heads: int, folds: int,
              shard: Optional[SeedShard], blocked: bool) -> SeedMapArgs:
    """The seed map of a ``[batch, num_heads, ...]`` launch of ``folds``
    folds: the seed group (a fold's heads per sample; the pair block of a
    whole fold per block) and the slice ``shard`` (None: all of it)."""
    rows = _fold_batch(batch, folds)
    if shard is None:
        shard = SeedShard(0, rows, 0, num_heads)
    if (shard.row0 < 0 or shard.row0 + rows > shard.rows or shard.head0 < 0
            or shard.head0 + num_heads > shard.heads):
        raise ValueError("a launch of %d rows and %d heads a fold does not "
                         "fit %s" % (rows, num_heads, shard))
    group = (_largest_block(shard.rows * shard.heads) if blocked
             else shard.heads)
    return (group, rows, shard.rows, shard.row0, shard.heads, shard.head0)


def _n_seeds(seed_map: SeedMapArgs, folds: int) -> int:
    group, _, rows, _, heads, _ = seed_map
    return folds * rows * heads // group


def blocked_seed_count(batch: int, num_heads: int, folds: int = 1) -> int:
    """Number of per-grid-step dropout seeds :func:`fused_attention_blocked`
    consumes for a ``[batch, num_heads, ...]`` input of ``folds`` folds
    (``folds × blocked_seed_count(batch // folds, num_heads)``).

    The single public home of the block-size policy: callers building seed
    arrays (e.g. the encoder) MUST use this rather than re-deriving from
    ``_largest_block``, so a future cap change or per-shape heuristic cannot
    desynchronize the seed array from the kernel's grid."""
    return batch * num_heads // _fold_block(batch, num_heads, folds)


# --------------------------------------------------------------------------
# Counter-based dropout bits, uint32 arithmetic carried in int64 tensors
# --------------------------------------------------------------------------

def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``(a · b) mod 2³²`` for ``a`` holding uint32 values in int64 and a
    uint32 constant ``b``, in 16-bit halves so that no product leaves int64."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    b_lo, b_hi = b & 0xFFFF, b >> 16
    mid = (a_hi * b_lo + a_lo * b_hi) & 0xFFFF
    return (a_lo * b_lo + (mid << 16)) & _MASK32


def _hash_bits(shape, seed, offset=0) -> torch.Tensor:
    """Murmur3-finalizer bits over the linear index of ``shape`` (3-d) plus
    ``offset``, xor ``seed·2654435761`` — ``_hash_bits`` of the JAX package
    (``offset`` 0), in uint32 values held by int64.

    ``seed`` is an int or an integer tensor of shape ``[n]``, ``offset`` an
    int or an integer tensor of shape ``[n]`` (one a seed); the result is
    ``shape`` or ``[n, *shape]``. The bits of ``shape`` at ``offset`` are
    the slice of a larger index space's bits that starts there."""
    n0, n1, n2 = shape
    seed_t = torch.as_tensor(seed, dtype=torch.int64)
    dev = seed_t.device
    idx = ((torch.arange(n0, dtype=torch.int64, device=dev)[:, None, None]
            * ((n1 * n2) & _MASK32))
           + torch.arange(n1, dtype=torch.int64, device=dev)[None, :, None] * n2
           + torch.arange(n2, dtype=torch.int64, device=dev)[None, None, :])
    off = torch.as_tensor(offset, dtype=torch.int64, device=dev)
    if off.dim() == 1:
        off = off[:, None, None, None]
    idx = (idx + off) & _MASK32
    s = _mul32(seed_t & _MASK32, 2654435761)
    if s.dim() == 1:
        s = s[:, None, None, None]
    x = idx ^ s
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    return x ^ (x >> 16)


def _threshold(rate: float) -> int:
    return min(int(rate * (1 << 32)), (1 << 32) - 1)


def _dropout_scale(rate: float) -> float:
    return float(np.float32(1.0 / (1.0 - rate)))


def _keep_mask(shape, rate: float, seed, offset=0) -> torch.Tensor:
    """Keep iff bits >= rate·2³² (P(drop) = rate to within 2⁻³²)."""
    return _hash_bits(shape, seed, offset) >= _threshold(rate)


def _as_seed_map(seed_map: Union[int, SeedMapArgs], B: int, H: int
                 ) -> SeedMapArgs:
    """A bare seed group stands for the whole batch's map."""
    if isinstance(seed_map, int):
        return (seed_map, B, B, 0, H, 0)
    return tuple(seed_map)


def _pair_keep(B: int, H: int, S: int, rate: float, seeds: torch.Tensor,
               seed_map: Union[int, SeedMapArgs]) -> torch.Tensor:
    """The ``[B, H, S, S]`` keep mask: pair ``g = b·H + h`` at its global
    pair P (``SeedMap::pair``) draws from ``seeds[P // group]`` over the
    hash index ``(P mod group, i, j)``."""
    group, rows, rows_total, row0, heads_total, head0 = _as_seed_map(
        seed_map, B, H)
    g = torch.arange(B * H, dtype=torch.int64, device=seeds.device)
    b, h = g // H, g % H
    P = ((b // rows) * rows_total + row0 + b % rows) * heads_total + head0 + h
    keep = _keep_mask((1, S, S), rate, seeds.to(torch.int64)[P // group],
                      (P % group) * (S * S))
    return keep.reshape(B, H, S, S)


# --------------------------------------------------------------------------
# Plain PyTorch versions
# --------------------------------------------------------------------------

def _bias_rows(bias: torch.Tensor, B: int, S: int) -> torch.Tensor:
    """``[B, 1, 1, S]`` (or ``[B, S]``) additive key bias → ``[B, S]`` fp32."""
    return bias.reshape(B, -1)[:, -S:].to(torch.float32)


def _attention_plain(q, k, v, bias, scale, rate, seeds, seed_map):
    """Shared math of both plain versions. Pair ``g = b·H + h`` draws its
    dropout bits as :func:`_pair_keep` says (``seed_map`` an int: the seed
    group of the whole batch, from ``seeds[g // group]`` over the hash
    index ``(g mod group, i, j)``)."""
    B, H, S, D = q.shape
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s + _bias_rows(bias, B, S)[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    p = e / e.sum(dim=-1, keepdim=True)
    if rate > 0.0:
        keep = _pair_keep(B, H, S, rate, seeds, seed_map)
        p = torch.where(keep, p * _dropout_scale(rate), p.new_zeros(()))
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return o.to(q.dtype)


def _seed_arg(n: int, seeds, device) -> torch.Tensor:
    if seeds is None:
        return torch.zeros((n,), dtype=torch.int32, device=device)
    s = torch.as_tensor(seeds, device=device).to(torch.int32).reshape(-1)
    if s.shape[0] < n:
        raise ValueError("%d seeds given, %d needed" % (s.shape[0], n))
    return s[:n].contiguous()


def fused_attention_plain(q, k, v, bias, scale: float,
                          dropout_rate: float = 0.0, seeds=None,
                          folds: int = 1, shard: Optional[SeedShard] = None):
    """Plain PyTorch version of :func:`fused_attention` (per-sample seeds)."""
    B, H = q.shape[:2]
    seed_map = _seed_map(B, H, folds, shard, blocked=False)
    return _attention_plain(q, k, v, bias, scale, dropout_rate,
                            _seed_arg(_n_seeds(seed_map, folds), seeds,
                                      q.device), seed_map)


def fused_attention_blocked_plain(q, k, v, bias, scale: float,
                                  dropout_rate: float = 0.0, seeds=None,
                                  folds: int = 1,
                                  shard: Optional[SeedShard] = None):
    """Plain PyTorch version of :func:`fused_attention_blocked`
    (per-block seeds, ``_largest_block(B·H)`` pairs of one fold a block)."""
    B, H = q.shape[:2]
    seed_map = _seed_map(B, H, folds, shard, blocked=True)
    return _attention_plain(q, k, v, bias, scale, dropout_rate,
                            _seed_arg(_n_seeds(seed_map, folds), seeds,
                                      q.device), seed_map)


def fused_attention_bwd_plain(q, k, v, bias, do, scale: float, rate: float,
                              seeds, seed_group: Union[int, SeedMapArgs]):
    """Plain PyTorch backward of both kernels: (dq, dk, dv) for the incoming
    gradient ``do``, step for step as ``_bwd_kernel`` with its rounding
    points. ``seed_group`` is a seed map (:func:`_pair_keep`), or for the
    whole batch its group: ``seeds`` then holds ``B·H // seed_group`` int32
    seeds (read iff ``rate > 0``) and pair ``g`` draws from
    ``seeds[g // seed_group]``."""
    B, H, S, D = q.shape
    qf, kf, dof = q.float(), k.float(), do.float()
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    s = s + _bias_rows(bias, B, S)[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    p = e / e.sum(dim=-1, keepdim=True)               # pre-dropout probs
    dp = torch.matmul(dof, v.float().transpose(-1, -2))
    if rate > 0.0:
        keep = _pair_keep(B, H, S, rate, seeds, seed_group)
        c, zero = _dropout_scale(rate), p.new_zeros(())
        pd = torch.where(keep, p * c, zero)            # dropped probs
        dp = torch.where(keep, dp * c, zero)           # chain rule
    else:
        pd = p
    dv = torch.matmul(pd.to(do.dtype).float().transpose(-1, -2), dof)
    # softmax VJP with respect to the pre-dropout p
    ds = (p * (dp - (dp * p).sum(dim=-1, keepdim=True))).to(q.dtype).float()
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# --------------------------------------------------------------------------
# CUDA kernel launch
# --------------------------------------------------------------------------

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _bwd_lib():
    from meme_challenge_tpu_torch.ops import cuda_build

    lib = cuda_build.load("fused_attention_bwd")
    if not getattr(lib, "typed", False):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        u = ctypes.c_uint
        seed_map = [i] * 6  # SeedMap: group, rows, rows_total, row0, ...
        lib.fused_attention_bwd.argtypes = [
            i, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, f, u, f, i,
            *seed_map, vp]
        lib.fused_attention_bwd_mma.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, f, u, f, i,
            *seed_map, vp]
        lib.fused_attention_bwd_tf32.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp, i, i, i, i, f, u, f, i,
            *seed_map, vp]
        lib.fused_attention_bwd_mma_smem.argtypes = [i, i]
        lib.fused_attention_bwd_tf32_smem.argtypes = [i, i]
        for fn in (lib.fused_attention_bwd, lib.fused_attention_bwd_mma,
                   lib.fused_attention_bwd_tf32,
                   lib.fused_attention_bwd_mma_smem,
                   lib.fused_attention_bwd_tf32_smem):
            fn.restype = i
        lib.typed = True
    return lib


def _lib():
    from meme_challenge_tpu_torch.ops import cuda_build

    lib = cuda_build.load("fused_attention")
    if not hasattr(lib, "max_s"):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        u = ctypes.c_uint
        seed_map = [i] * 6  # SeedMap: group, rows, rows_total, row0, ...
        lib.fused_attention_fwd.argtypes = [
            i, vp, vp, vp, vp, vp, vp, i, i, i, i, f, u, f, i, *seed_map, vp]
        lib.fused_attention_fwd_mma.argtypes = [
            vp, vp, vp, vp, vp, vp, i, i, i, i, f, u, f, i, *seed_map, vp]
        lib.fused_attention_fwd_tf32.argtypes = [
            vp, vp, vp, vp, vp, vp, vp, i, i, i, i, f, u, f, i, *seed_map,
            vp]
        lib.fused_attention_mma_smem.argtypes = [i, i]
        lib.fused_attention_tf32_smem.argtypes = [i, i]
        for fn in (lib.fused_attention_max_s, lib.fused_attention_max_d,
                   lib.fused_attention_mma_max_s):
            fn.argtypes = []
        for fn in (lib.fused_attention_fwd, lib.fused_attention_fwd_mma,
                   lib.fused_attention_fwd_tf32, lib.fused_attention_mma_smem,
                   lib.fused_attention_tf32_smem, lib.fused_attention_max_s,
                   lib.fused_attention_max_d, lib.fused_attention_mma_max_s):
            fn.restype = i
        lib.max_s = lib.fused_attention_max_s()
        lib.max_d = lib.fused_attention_max_d()
    return lib


def _check(q, k, v, bias, extra=()):
    """The kernels' contract: q, k, v (and ``extra`` named tensors) of one
    [B, H, S, D] shape and dtype on one device, contiguous and aligned; bias
    of B·S elements; S and D within the kernels' limits."""
    if q.dim() != 4:
        raise ValueError("q must be [B, H, S, D], got %s" % (tuple(q.shape),))
    B, H, S, D = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)) + tuple(extra):
        if t.device != q.device:
            raise ValueError("%s is on %s, q on %s" % (name, t.device,
                                                        q.device))
        if t.dtype not in _DTYPE_CODE or t.dtype != q.dtype:
            raise TypeError("q, k, v must share one dtype of float32 or "
                            "bfloat16; %s is %s, q is %s"
                            % (name, t.dtype, q.dtype))
        if tuple(t.shape) != (B, H, S, D):
            raise ValueError("%s has shape %s, expected %s"
                             % (name, tuple(t.shape), (B, H, S, D)))
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("%s must be contiguous and 16-byte aligned"
                             % name)
    if bias.device != q.device or bias.numel() != B * S:
        raise ValueError("bias must be [B, 1, 1, S] on %s, got %s on %s"
                         % (q.device, tuple(bias.shape), bias.device))
    lib = _lib()
    if S > lib.max_s or D > lib.max_d or D % 4:
        raise ValueError("the kernel takes S <= %d and D <= %d, D a multiple "
                         "of 4; got S=%d, D=%d" % (lib.max_s, lib.max_d, S, D))
    return lib


def _launch(q, k, v, bias_rows, scale, rate, seeds, seed_map, want_stats):
    """Forward kernel on [B, H, S, D] CUDA tensors; ``bias_rows`` [B, S]
    fp32, ``seeds`` int32 (read only with dropout on), ``seed_map`` the
    kernels' SeedMap (:func:`_seed_map`). Returns (out, the
    route taken, the row statistics ``[2, B·H, S]`` fp32 that the
    ``mma_tf32x3`` route writes when ``want_stats``, else None)."""
    lib = _check(q, k, v, bias_rows)
    B, H, S, D = q.shape
    route = attention_route(q.dtype, S, D)
    dropout = rate > 0.0
    out = torch.empty_like(q)
    stats = None
    inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_rows.data_ptr(),
              seeds.data_ptr() if dropout else None, out.data_ptr())
    shape = (B * H, H, S, D, float(scale), _threshold(rate),
             _dropout_scale(rate) if dropout else 1.0, int(dropout),
             *seed_map)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "mma_bf16":
            err = lib.fused_attention_fwd_mma(*inputs, *shape, stream)
        elif route == "mma_tf32x3":
            if want_stats:
                stats = torch.empty((2, B * H, S), dtype=torch.float32,
                                    device=q.device)
            err = lib.fused_attention_fwd_tf32(
                *inputs, stats.data_ptr() if want_stats else None, *shape,
                stream)
        else:
            err = lib.fused_attention_fwd(_DTYPE_CODE[q.dtype], *inputs,
                                          *shape, stream)
    if err != 0:
        raise RuntimeError("fused_attention_fwd (%s) launch failed: CUDA "
                           "error %d" % (route, err))
    return out, route, stats


def _launch_bwd(q, k, v, bias_rows, do, scale, rate, seeds, seed_map,
                out=None, stats=None):
    """Backward kernel on [B, H, S, D] CUDA tensors: one launch on the
    ``mma_bf16`` and ``mma_tf32x3`` routes (the latter from the forward's
    ``out`` and row statistics), two (with a ``[3, B·H, S]`` fp32 workspace)
    on ``cuda_core``. Returns (dq, dk, dv, the route taken)."""
    _check(q, k, v, bias_rows, extra=(("do", do),))
    B, H, S, D = q.shape
    lib = _bwd_lib()
    route = attention_route(q.dtype, S, D, backward=True)
    dropout = rate > 0.0
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    inputs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_rows.data_ptr(),
              seeds.data_ptr() if dropout else None, do.data_ptr())
    grads = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    shape = (B * H, H, S, D, float(scale), _threshold(rate),
             _dropout_scale(rate) if dropout else 1.0, int(dropout),
             *_as_seed_map(seed_map, B, H))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if route == "mma_bf16":
            err = lib.fused_attention_bwd_mma(*inputs, *grads, *shape, stream)
        elif route == "mma_tf32x3":
            if stats is None:
                raise RuntimeError("the mma_tf32x3 backward needs the row "
                                   "statistics of an mma_tf32x3 forward")
            err = lib.fused_attention_bwd_tf32(
                *inputs, out.data_ptr(), stats.data_ptr(), *grads, *shape,
                stream)
        else:
            ws = torch.empty((3, B * H, S), dtype=torch.float32,
                             device=q.device)
            err = lib.fused_attention_bwd(_DTYPE_CODE[q.dtype], *inputs,
                                          *grads, ws.data_ptr(), *shape,
                                          stream)
    if err != 0:
        raise RuntimeError("fused_attention_bwd (%s) launch failed: CUDA "
                           "error %d" % (route, err))
    return dq, dk, dv, route


class _FusedAttention(torch.autograd.Function):
    """Custom VJP of both wrappers (JAX ``_fwd_rule``/``_bwd_rule`` and
    ``_blk_fwd_rule``/``_blk_bwd_rule``): CUDA tensors launch the kernels,
    CPU tensors take the plain versions. ``name`` keys ``LAUNCHES``. On the
    ``mma_tf32x3`` route the output and the row statistics are saved too."""

    @staticmethod
    def forward(ctx, q, k, v, bias_rows, seeds, scale, rate, seed_map,
                name):
        ctx.scale, ctx.rate, ctx.seed_map, ctx.name = (scale, rate,
                                                       seed_map, name)
        if q.device.type == "cpu":
            ctx.save_for_backward(q, k, v, bias_rows, seeds)
            return _attention_plain(q, k, v, bias_rows, scale, rate, seeds,
                                    seed_map)
        out, route, stats = _launch(q, k, v, bias_rows, scale, rate, seeds,
                                    seed_map, any(ctx.needs_input_grad[:3]))
        if stats is None:
            ctx.save_for_backward(q, k, v, bias_rows, seeds)
        else:
            ctx.save_for_backward(q, k, v, bias_rows, seeds, out, stats)
        LAUNCHES[name] += 1
        ROUTE_LAUNCHES[(name, route)] += 1
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias_rows, seeds, *saved = ctx.saved_tensors
        do = do.contiguous()
        args = (ctx.scale, ctx.rate, seeds, ctx.seed_map)
        if q.device.type == "cpu":
            grads = fused_attention_bwd_plain(q, k, v, bias_rows, do, *args)
        else:
            *grads, route = _launch_bwd(q, k, v, bias_rows, do, *args, *saved)
            name = ctx.name + "_bwd"
            LAUNCHES[name] += 1
            ROUTE_LAUNCHES[(name, route)] += 1
        return (*grads, None, None, None, None, None, None)


def _apply(q, k, v, bias, scale, rate, seeds, folds, shard, name):
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError("fused attention runs on cuda or cpu tensors, got %s"
                         % q.device)
    B, H, S = q.shape[:3]
    if bias.numel() != B * S:
        raise ValueError("bias must be [B, 1, 1, S], got %s"
                         % (tuple(bias.shape),))
    seed_map = _seed_map(B, H, folds, shard,
                         blocked=name == "fused_attention_blocked")
    bias_rows = _bias_rows(bias, B, S).contiguous()
    # seeds are read only with dropout on
    seeds = (_seed_arg(_n_seeds(seed_map, folds), seeds, q.device)
             if rate > 0.0 else None)
    return _FusedAttention.apply(q, k, v, bias_rows, seeds, float(scale),
                                 float(rate), seed_map, name)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, scale: float,
                    dropout_rate: float = 0.0,
                    seeds: Optional[torch.Tensor] = None,
                    folds: int = 1,
                    shard: Optional[SeedShard] = None) -> torch.Tensor:
    """dropout(softmax(q·kᵀ·scale + bias))·v, per sample; differentiable in
    q, k and v.

    q/k/v: [B, H, S, D] (``folds`` folds of B // folds samples, fold-major);
    bias: [B, 1, 1, S] additive fp32 mask; seeds: [B] int32 per-sample seeds
    (read iff dropout_rate > 0; with ``shard``, ``folds × shard.rows``: a
    slice of each fold's rows and heads, hashed as in the whole run).
    Returns [B, H, S, D] in q.dtype.
    """
    return _apply(q, k, v, bias, scale, dropout_rate, seeds, folds, shard,
                  "fused_attention")


def fused_attention_blocked(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, bias: torch.Tensor, scale: float,
                            dropout_rate: float = 0.0,
                            seeds: Optional[torch.Tensor] = None,
                            folds: int = 1,
                            shard: Optional[SeedShard] = None
                            ) -> torch.Tensor:
    """Pair-blocked fused attention; same signature as
    :func:`fused_attention` except ``seeds`` is per block
    (``[blocked_seed_count(B, H, folds)]`` int32, fold-major; with
    ``shard``, the blocks of the whole run's ``shard.rows × shard.heads``
    pairs a fold)."""
    return _apply(q, k, v, bias, scale, dropout_rate, seeds, folds, shard,
                  "fused_attention_blocked")
