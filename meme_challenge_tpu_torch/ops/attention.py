"""Fused multi-head attention forward, ``dropout(softmax(q·kᵀ·scale + bias))·v``.

Counterpart of ``meme_challenge_tpu/ops/attention.py``. The two Pallas
forward kernels there (``_fwd_kernel``, one program per sample, and
``_blk_fwd_kernel``, ``_largest_block(B·H)`` (sample, head) pairs per grid
step) become one hand-written CUDA kernel for Hopper,
``csrc/fused_attention.cu``, in two seed modes. It keeps the scores, the
probabilities and the dropout mask out of device memory, as the TPU kernels
did.

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
- There is no backward kernel yet: a CUDA input that requires grad raises
  ``NotImplementedError``.

``LAUNCHES`` counts the kernel launches of each wrapper.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

LAUNCHES = {"fused_attention": 0, "fused_attention_blocked": 0}

_MASK32 = 0xFFFFFFFF


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


def blocked_seed_count(batch: int, num_heads: int) -> int:
    """Number of per-grid-step dropout seeds :func:`fused_attention_blocked`
    consumes for a ``[batch, num_heads, ...]`` input.

    The single public home of the block-size policy: callers building seed
    arrays (e.g. the encoder) MUST use this rather than re-deriving from
    ``_largest_block``, so a future cap change or per-shape heuristic cannot
    desynchronize the seed array from the kernel's grid."""
    g = batch * num_heads
    return g // _largest_block(g)


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


def _hash_bits(shape, seed) -> torch.Tensor:
    """Murmur3-finalizer bits over the linear index of ``shape`` (3-d),
    xor ``seed·2654435761`` — ``_hash_bits`` of the JAX package, in uint32
    values held by int64.

    ``seed`` is an int or an integer tensor of shape ``[n]``; the result is
    ``shape`` or ``[n, *shape]``."""
    n0, n1, n2 = shape
    seed_t = torch.as_tensor(seed, dtype=torch.int64)
    dev = seed_t.device
    idx = ((torch.arange(n0, dtype=torch.int64, device=dev)[:, None, None]
            * ((n1 * n2) & _MASK32))
           + torch.arange(n1, dtype=torch.int64, device=dev)[None, :, None] * n2
           + torch.arange(n2, dtype=torch.int64, device=dev)[None, None, :]
           ) & _MASK32
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


def _keep_mask(shape, rate: float, seed) -> torch.Tensor:
    """Keep iff bits >= rate·2³² (P(drop) = rate to within 2⁻³²)."""
    return _hash_bits(shape, seed) >= _threshold(rate)


# --------------------------------------------------------------------------
# Plain PyTorch versions
# --------------------------------------------------------------------------

def _bias_rows(bias: torch.Tensor, B: int, S: int) -> torch.Tensor:
    """``[B, 1, 1, S]`` (or ``[B, S]``) additive key bias → ``[B, S]`` fp32."""
    return bias.reshape(B, -1)[:, -S:].to(torch.float32)


def _attention_plain(q, k, v, bias, scale, rate, seeds, seed_group):
    """Shared math of both plain versions. Pair ``g = b·H + h`` draws its
    dropout bits from ``seeds[g // seed_group]`` over the hash index
    ``(g mod seed_group, i, j)``."""
    B, H, S, D = q.shape
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    s = s + _bias_rows(bias, B, S)[:, None, None, :]
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    p = e / e.sum(dim=-1, keepdim=True)
    if rate > 0.0:
        G = B * H
        keep = _keep_mask((seed_group, S, S), rate,
                          seeds[:G // seed_group].to(torch.int64))
        keep = keep.reshape(B, H, S, S)
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
                          dropout_rate: float = 0.0, seeds=None):
    """Plain PyTorch version of :func:`fused_attention` (per-sample seeds)."""
    B, H = q.shape[:2]
    return _attention_plain(q, k, v, bias, scale, dropout_rate,
                            _seed_arg(B, seeds, q.device), H)


def fused_attention_blocked_plain(q, k, v, bias, scale: float,
                                  dropout_rate: float = 0.0, seeds=None):
    """Plain PyTorch version of :func:`fused_attention_blocked`
    (per-block seeds, ``_largest_block(B·H)`` pairs a block)."""
    B, H = q.shape[:2]
    blk = _largest_block(B * H)
    return _attention_plain(q, k, v, bias, scale, dropout_rate,
                            _seed_arg(B * H // blk, seeds, q.device), blk)


# --------------------------------------------------------------------------
# CUDA kernel launch
# --------------------------------------------------------------------------

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    from meme_challenge_tpu_torch.ops import cuda_build

    lib = cuda_build.load("fused_attention")
    if not hasattr(lib, "max_s"):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_attention_fwd.argtypes = [
            i, vp, vp, vp, vp, vp, vp, i, i, i, i, f, ctypes.c_uint, f, i, i,
            vp]
        lib.fused_attention_fwd.restype = i
        for fn in (lib.fused_attention_max_s, lib.fused_attention_max_d):
            fn.argtypes, fn.restype = [], i
        lib.max_s = lib.fused_attention_max_s()
        lib.max_d = lib.fused_attention_max_d()
    return lib


def _launch(q, k, v, bias, scale, rate, seeds, seed_group):
    if any(t.requires_grad for t in (q, k, v)) and torch.is_grad_enabled():
        raise NotImplementedError(
            "fused attention has no backward kernel yet (the training "
            "slice in ROADMAP.md); run the forward under torch.no_grad()")
    if q.dim() != 4:
        raise ValueError("q must be [B, H, S, D], got %s" % (tuple(q.shape),))
    B, H, S, D = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
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
    bias_rows = _bias_rows(bias, B, S).contiguous()
    dropout = rate > 0.0
    # seeds are read only with dropout on
    seeds = _seed_arg(B * H // seed_group, seeds, q.device) if dropout \
        else None
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fused_attention_fwd(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            bias_rows.data_ptr(), seeds.data_ptr() if dropout else None,
            out.data_ptr(), B * H, H, S, D, float(scale), _threshold(rate),
            _dropout_scale(rate) if dropout else 1.0, int(dropout),
            seed_group, stream)
    if err != 0:
        raise RuntimeError("fused_attention_fwd launch failed: CUDA error %d"
                           % err)
    return out


def _on_cpu(q) -> bool:
    if q.device.type == "cpu":
        return True
    if q.device.type != "cuda":
        raise ValueError("fused attention runs on cuda or cpu tensors, got %s"
                         % q.device)
    return False


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, scale: float,
                    dropout_rate: float = 0.0,
                    seeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """dropout(softmax(q·kᵀ·scale + bias))·v, per sample.

    q/k/v: [B, H, S, D]; bias: [B, 1, 1, S] additive fp32 mask;
    seeds: [B] int32 per-sample seeds (read iff dropout_rate > 0).
    Returns [B, H, S, D] in q.dtype.
    """
    if _on_cpu(q):
        return fused_attention_plain(q, k, v, bias, scale, dropout_rate, seeds)
    out = _launch(q, k, v, bias, scale, dropout_rate, seeds, q.shape[1])
    LAUNCHES["fused_attention"] += 1
    return out


def fused_attention_blocked(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, bias: torch.Tensor, scale: float,
                            dropout_rate: float = 0.0,
                            seeds: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """Pair-blocked fused attention; same signature as
    :func:`fused_attention` except ``seeds`` is per block
    (``[blocked_seed_count(B, H)]`` int32)."""
    if _on_cpu(q):
        return fused_attention_blocked_plain(q, k, v, bias, scale,
                                             dropout_rate, seeds)
    blk = _largest_block(q.shape[0] * q.shape[1])
    out = _launch(q, k, v, bias, scale, dropout_rate, seeds, blk)
    LAUNCHES["fused_attention_blocked"] += 1
    return out
