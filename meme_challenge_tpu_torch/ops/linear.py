"""The encoder's dense layers, ``x·Wᵀ + b``, and their gradients.

Replaces no TPU kernel: the JAX encoder's ``Dense`` layers are XLA dots
followed by the bias add. On a card the port runs them in float32 through
one hand-written CUDA kernel (``csrc/linear_tf32x3.cu``): three TF32
products a product on the tensor cores (3×TF32, the split of
``csrc/mma_tf32.cuh``), fp32 accumulation, the bias added once in the
epilogue, so float32 keeps float32's accuracy off the CUDA cores.

- :func:`linear` is the route, by what the call observes and nothing else
  (:func:`linear_route`): a CPU tensor takes :func:`linear_plain`, the plain
  version (``F.linear`` then the bias, each rounded to the dtype as in the
  JAX encoder); bfloat16 on a card takes the same two torch calls (cuBLAS,
  already on the tensor cores); float32 on a card takes the custom op
  ``meme::linear_tf32x3`` and raises where the kernel cannot take the shape
  (in or out features not a multiple of 4). Nothing falls back.
- ``torch.ops.meme.linear_tf32x3`` is a ``torch.library`` custom op, so a
  selective checkpoint sees it (``models/uniter.py: _DOTS`` keeps its
  output under ``remat_policy`` "dots"). Its CUDA kernel launches the
  forward; off a card its body is :func:`linear_plain`. Its autograd formula
  takes ``dx = dy·W`` and ``dW = dyᵀ·x`` from the same kernel on a card
  (plain products off it) and ``db`` as the row sum of ``dy``. Where no
  gradient is wanted (scoring), :func:`linear` calls the CUDA body itself,
  without the dispatcher's round trip.
- A launch goes on the current stream, allocates its output (and a split
  product's workspace) with ``torch.empty`` and never synchronises, so a
  CUDA graph captures it. A product whose output fills the card's 132 SMs
  poorly splits its k range over several blocks of a tile and sums the
  partials in a second launch, in a fixed order, adding the bias there
  (:func:`k_splits`, from the shape alone: UNITER-large's 1 024-wide
  outputs and the wgrads; UNITER-base's forward at 2 560 rows never
  splits).

``LAUNCHES`` counts the kernel's launches by product, and the split-K sums;
the plain products off a card count nothing.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

LAUNCHES = {"forward": 0, "dgrad": 0, "wgrad": 0, "splitk_sum": 0}

BLOCK_M = 128   # output rows a block (csrc: 64 × two consumer warpgroups)
BLOCK_N = 128   # output columns a block
BLOCK_K = 32    # k a pipeline stage, the unit of a split (csrc's kBK)
SMS = 132       # streaming multiprocessors of an H100 SXM
# the cost model of k_splits: a block's stage of 128 × 128 × 32 takes
# ≈ 1.5 µs at the encoder's shapes (H100, 700 W: 1.4-1.6 µs over the
# forward's full waves), the partials move at ≈ 3 TB/s
STAGE_US = 1.5
BYTES_PER_US = 3.0e6
MIN_SPLIT_STAGES = 8  # k stages a split keeps at least
MAX_SPLITS = 8


def linear_route(device_type: str, dtype: torch.dtype, in_features: int,
                 out_features: int) -> str:
    """``"plain"`` (off a card), ``"library"`` (bfloat16 or any dtype but
    float32 on a card: ``F.linear``) or ``"kernel"`` (float32 on a card);
    raises where float32 on a card has a shape the kernel cannot take."""
    if device_type != "cuda":
        return "plain"
    if dtype != torch.float32:
        return "library"
    if in_features % 4 or out_features % 4:
        raise ValueError(
            "the 3xTF32 linear kernel takes in and out features that are "
            "multiples of 4; got %d -> %d" % (in_features, out_features))
    return "kernel"


def linear_plain(x: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """``x·Wᵀ + b``: the product, then the bias, each rounded to x's
    dtype (JAX's ``Dense``)."""
    return F.linear(x, weight) + bias


def linear(x: torch.Tensor, weight: torch.Tensor,
           bias: torch.Tensor) -> torch.Tensor:
    """``x·Wᵀ + b`` over x's last axis, by :func:`linear_route`."""
    if linear_route(x.device.type, x.dtype, x.shape[-1],
                    weight.shape[0]) != "kernel":
        return linear_plain(x, weight, bias)
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        return LINEAR_OP(x, weight, bias)
    return _forward_cuda(x, weight, bias)


# --------------------------------------------------------------------------
# Tile plan
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def k_splits(rows: int, cols: int, depth: int) -> Tuple[int, int]:
    """``(splits, stages a split)`` of a ``rows × cols`` product over
    ``depth``: the split of the k range that a simple model of the card
    finds fastest (waves of blocks over the SMs × stages a block, plus the
    partials written and read back), no split below ``MIN_SPLIT_STAGES``
    stages, and never an empty one. A function of the shape alone."""
    tiles = math.ceil(rows / BLOCK_M) * math.ceil(cols / BLOCK_N)
    stages = math.ceil(depth / BLOCK_K)
    best = None
    for want in range(1, MAX_SPLITS + 1):
        per = math.ceil(stages / want)
        if want > 1 and per < MIN_SPLIT_STAGES:
            break
        splits = math.ceil(stages / per)
        cost = math.ceil(tiles * splits / SMS) * per * STAGE_US
        if splits > 1:
            cost += (2 * splits + 1) * rows * cols * 4 / BYTES_PER_US
        if best is None or cost < best[0]:
            best = (cost, splits, per)
    return best[1], best[2]


# --------------------------------------------------------------------------
# The kernel
# --------------------------------------------------------------------------

_GEMM = []


def _gemm_fn():
    if not _GEMM:
        from meme_challenge_tpu_torch.ops import cuda_build

        lib = cuda_build.load("linear_tf32x3")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.gemm_tf32x3.argtypes = [i, i, vp, vp, vp, vp, vp, i, i, i, i, i,
                                    i, i, vp]
        lib.gemm_tf32x3.restype = i
        lib.gemm_tf32x3_stage_k.restype = i
        if lib.gemm_tf32x3_stage_k() != BLOCK_K:
            raise RuntimeError("linear_tf32x3: the library's stage of %d k "
                               "is not BLOCK_K %d, the unit of a split" % (
                                   lib.gemm_tf32x3_stage_k(), BLOCK_K))
        _GEMM.append(lib.gemm_tf32x3)
    return _GEMM[0]


def _check(names: str, *ts: torch.Tensor) -> None:
    """Every tensor a contiguous, 16-byte aligned float32 tensor on the
    first one's card (cheap attribute reads: the forward runs eagerly in
    scoring, one call a product)."""
    index = ts[0].get_device()
    for t in ts:
        if (t.dtype is not torch.float32 or t.get_device() != index
                or index < 0 or not t.is_contiguous() or t.data_ptr() & 15):
            raise ValueError(
                "linear_tf32x3: %s must be contiguous, 16-byte aligned "
                "float32 tensors on one card; got %s" % (names, ", ".join(
                    "%s %s%s" % (u.dtype, u.device, "" if u.is_contiguous()
                                 else " (not contiguous)") for u in ts)))


def _launch(product: str, a_kmajor: bool, b_kmajor: bool, a: torch.Tensor,
            b: torch.Tensor, bias: Optional[torch.Tensor], out: torch.Tensor,
            rows: int, cols: int, depth: int, lda: int, ldb: int,
            split: Tuple[int, int]) -> None:
    """``out[rows][cols] = Σ_depth A·B (+ bias)`` on the current stream,
    the depth in ``split = (splits, stages a split)``."""
    splits, per = split
    work = out.new_empty((splits, rows, cols)) if splits > 1 else None
    stream = torch._C._cuda_getCurrentRawStream(out.get_device())
    err = _gemm_fn()(int(a_kmajor), int(b_kmajor), a.data_ptr(),
                     b.data_ptr(), None if bias is None else bias.data_ptr(),
                     out.data_ptr(), None if work is None else
                     work.data_ptr(), rows, cols, depth, lda, ldb, splits,
                     per, stream)
    if err != 0:
        raise RuntimeError("linear_tf32x3 %s launch failed: CUDA error %d"
                           % (product, err))
    LAUNCHES[product] += 1
    if splits > 1:
        LAUNCHES["splitk_sum"] += 1


def _rows(x: torch.Tensor, k: int) -> torch.Tensor:
    x2 = x.reshape(-1, k)
    return x2 if x2.is_contiguous() else x2.contiguous()


def _forward_cuda(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    n, k = weight.shape
    if k % 4 or n % 4:
        linear_route("cuda", x.dtype, k, n)  # raises
    if x.shape[-1] != k or bias.shape != (n,):
        raise ValueError("linear_tf32x3: x [..., %d], weight [%d, %d] and "
                         "bias [%d] do not match; got x %s, bias %s" % (
                             k, n, k, n, tuple(x.shape), tuple(bias.shape)))
    if not x.is_contiguous():
        x = x.contiguous()
    _check("x, weight and bias", x, weight, bias)
    m = x.numel() // k
    y = x.new_empty((*x.shape[:-1], n))
    if m:
        _launch("forward", True, True, x, weight, bias, y, m, n, k, k, k,
                k_splits(m, n, k))
    return y


def dgrad(dy2: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """``dy·W``: ``[M, N] · [N, K] → [M, K]``, its k range (the N
    features) split by :func:`k_splits`."""
    n, k = weight.shape
    if dy2.device.type != "cuda":
        return dy2 @ weight
    _check("dy and weight", dy2, weight)
    dx = dy2.new_empty((dy2.shape[0], k))
    if dy2.shape[0]:
        _launch("dgrad", True, False, dy2, weight, None, dx, dy2.shape[0], k,
                n, n, k, k_splits(dy2.shape[0], k, n))
    return dx


def wgrad(dy2: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """``dyᵀ·x``: ``[M, N]ᵀ · [M, K] → [N, K]``, its k range (the M rows)
    split by :func:`k_splits`."""
    (m, n), k = dy2.shape, x2.shape[1]
    if dy2.device.type != "cuda":
        return dy2.t() @ x2
    _check("dy and x", dy2, x2)
    if not m:
        return dy2.new_zeros((n, k))
    dw = dy2.new_empty((n, k))
    _launch("wgrad", False, False, dy2, x2, None, dw, n, k, m, n, k,
            k_splits(n, k, m))
    return dw


# --------------------------------------------------------------------------
# The operator and its gradient
# --------------------------------------------------------------------------

@torch.library.custom_op("meme::linear_tf32x3", mutates_args=())
def linear_tf32x3(x: torch.Tensor, weight: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """``x·Wᵀ + b``: off a card the plain version; on a card (registered
    below) the 3×TF32 kernel."""
    return linear_plain(x, weight, bias)


linear_tf32x3.register_kernel("cuda")(_forward_cuda)


def _save(ctx, inputs, output):
    x, weight, _ = inputs
    ctx.save_for_backward(x, weight)


@once_differentiable
def _backward(ctx, dy):
    """dx and dW from :func:`dgrad` and :func:`wgrad`, db as dy's row
    sum."""
    x, weight = ctx.saved_tensors
    n, k = weight.shape
    dy2 = _rows(dy, n)
    dx = dw = db = None
    if ctx.needs_input_grad[0]:
        dx = dgrad(dy2, weight).view(x.shape)
    if ctx.needs_input_grad[1]:
        dw = wgrad(dy2, _rows(x, k))
    if ctx.needs_input_grad[2]:
        db = dy2.sum(0)
    return dx, dw, db


linear_tf32x3.register_autograd(_backward, setup_context=_save)

LINEAR_OP = torch.ops.meme.linear_tf32x3.default
