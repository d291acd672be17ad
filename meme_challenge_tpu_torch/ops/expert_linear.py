"""The experts' matrix products: one product a group of rows, each group
with its own weight, the groups' bounds read on the device.

Replaces no TPU kernel: the JAX package has no mixture-of-experts layer.
An expert layer (``models/moe_mla.py``) sorts its routed rows by the
expert they go to, so expert ``g`` owns rows ``offsets[g] .. offsets[g+1]``
of the sorted operands. How many rows each expert gets is data: reading it
on the host would wait for the device in every layer and break the train
step's CUDA graph (``train/steps.py: _StepGraphs``). So the products take
``offsets`` as an int32 tensor on the device, and the card's kernel
(``csrc/linear_tf32x3.cu: expert_gemm_tf32x3_kernel``, the 3×TF32 tile of
the encoder's dense layers with its stage-sum accuracy fix) reads each
group's bounds itself:

- :func:`forward`: ``Y[r] = X[r]·W[g]ᵀ``, ``W`` ``[groups, N, K]``;
- :func:`dgrad`: ``DX[r] = DY[r]·W[g]``;
- :func:`wgrad`: ``DW[g] = Σ_r DY[r]ᵀ·X[r]`` over g's rows, an empty group
  zero.

Forward and dgrad size their grid for ``rows_bound`` rows a group (no group
has more: a token goes to an expert once); a block past its group's end
exits at once. Rows past the last group's end are left as they are (the
caller never reads them). A CPU tensor takes the plain version, one
``torch`` product a group over the host's copy of ``offsets``: there is no
graph to break there. Nothing falls back on a card.

``LAUNCHES`` counts the kernel's launches by product; the plain products
count nothing.
"""
from __future__ import annotations

import ctypes
from typing import List

import torch

LAUNCHES = {"forward": 0, "dgrad": 0, "wgrad": 0}
_PRODUCTS = {"forward": 0, "dgrad": 1, "wgrad": 2}
_FN = []


def _fn():
    if not _FN:
        from meme_challenge_tpu_torch.ops import cuda_build

        lib = cuda_build.load("linear_tf32x3")
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.expert_gemm_tf32x3.argtypes = [i, vp, vp, vp, vp, i, i, i, i, vp]
        lib.expert_gemm_tf32x3.restype = i
        _FN.append(lib.expert_gemm_tf32x3)
    return _FN[0]


def _check(*ts: torch.Tensor) -> None:
    index = ts[0].get_device()
    for t in ts:
        if (t.dtype is not torch.float32 or t.get_device() != index
                or not t.is_contiguous() or t.data_ptr() & 15):
            raise ValueError(
                "expert_gemm_tf32x3: operands must be contiguous, 16-byte "
                "aligned float32 tensors on one card; got %s" % ", ".join(
                    "%s %s" % (u.dtype, u.device) for u in ts))


def _launch(product: str, a: torch.Tensor, b: torch.Tensor,
            out: torch.Tensor, offsets: torch.Tensor, rows_bound: int,
            n: int, k: int) -> None:
    _check(a, b, out)
    if (offsets.dtype is not torch.int32 or not offsets.is_contiguous()
            or offsets.get_device() != a.get_device()):
        raise ValueError("expert_gemm_tf32x3: offsets must be a contiguous "
                         "int32 tensor on the operands' card")
    if n % 4 or k % 4:
        raise ValueError("expert_gemm_tf32x3: widths must be multiples of "
                         "4; got %d and %d" % (n, k))
    stream = torch._C._cuda_getCurrentRawStream(a.get_device())
    err = _fn()(_PRODUCTS[product], a.data_ptr(), b.data_ptr(),
                out.data_ptr(), offsets.data_ptr(), offsets.numel() - 1,
                rows_bound, n, k, stream)
    if err != 0:
        raise RuntimeError("expert_gemm_tf32x3 %s launch failed: CUDA error "
                           "%d" % (product, err))
    LAUNCHES[product] += 1


def _bounds(offsets: torch.Tensor) -> List[int]:
    return [int(v) for v in offsets.tolist()]


def forward(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
            rows_bound: int) -> torch.Tensor:
    """``[R, K] · [G, N, K]ᵀ → [R, N]``, group g's rows by ``offsets``."""
    groups, n, k = w.shape
    if x.device.type != "cuda":
        y = x.new_zeros((x.shape[0], n))
        b = _bounds(offsets)
        for g in range(groups):
            y[b[g]:b[g + 1]] = x[b[g]:b[g + 1]] @ w[g].t()
        return y
    y = x.new_empty((x.shape[0], n))
    if x.shape[0]:
        _launch("forward", x, w, y, offsets, rows_bound, n, k)
    return y


def dgrad(dy: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor,
          rows_bound: int) -> torch.Tensor:
    """``[R, N] · [G, N, K] → [R, K]``, group g's rows by ``offsets``."""
    groups, n, k = w.shape
    if dy.device.type != "cuda":
        dx = dy.new_zeros((dy.shape[0], k))
        b = _bounds(offsets)
        for g in range(groups):
            dx[b[g]:b[g + 1]] = dy[b[g]:b[g + 1]] @ w[g]
        return dx
    dx = dy.new_empty((dy.shape[0], k))
    if dy.shape[0]:
        _launch("dgrad", dy, w, dx, offsets, rows_bound, n, k)
    return dx


def wgrad(dy: torch.Tensor, x: torch.Tensor, offsets: torch.Tensor
          ) -> torch.Tensor:
    """``Σ_r [R, N]ᵀ · [R, K] → [G, N, K]`` over each group's rows."""
    groups, n, k = offsets.numel() - 1, dy.shape[1], x.shape[1]
    if dy.device.type != "cuda":
        b = _bounds(offsets)
        return torch.stack([dy[b[g]:b[g + 1]].t() @ x[b[g]:b[g + 1]]
                            for g in range(groups)])
    dw = dy.new_empty((groups, n, k))
    _launch("wgrad", dy, x, dw, offsets, 0, n, k)
    return dw
