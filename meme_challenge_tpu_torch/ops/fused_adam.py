"""One Adam / AdamW update of every parameter leaf, in place.

The update that ``train/optim.py: Optimizer.step`` takes for single-model
Adam and AdamW with fp32 parameters: the global-norm clip's factors applied
to the gradient, L2 decay (``adam``: into the gradient; ``adamw``: onto the
update), both moments, the bias-corrected step, the per-leaf update scale,
the learning rate and ``p += u``, in the order and with the roundings of the
optimizer's ``_foreach_*`` chain on each device, so that the two agree bit
for bit. The chain differs between the devices in one place: its division
of the first moment by the bias correction ``c1`` (the second by ``c2``) is
torch's ``_foreach_div`` by a Python scalar, which on a card multiplies by
the scalar's float reciprocal and on the CPU divides. The kernel multiplies
by ``float32(1 / c)``, the plain version divides.

- CUDA tensors launch ``csrc/fused_adam.cu`` (one launch for up to
  :func:`max_leaves` leaves); CPU tensors take :func:`fused_adam_plain`, the
  same update in plain PyTorch, in one call. Any other device raises;
  nothing falls back.
- ``p``, ``mu`` and ``nu`` are written in place: the moments keep their
  tensors and their storage dtype (float32 or bfloat16). ``g`` is read only.
- Nothing synchronises the host: the clip's factors and the step's
  scalars (``sched``: the bias corrections and the step size) are device
  scalars the kernel reads, the leaf table travels as a kernel parameter.
  A CUDA graph that captured a launch replays it with whatever ``sched``
  holds then (``train/steps.py: make_train_step``).

``ADAM_LAUNCHES`` counts the launches (on the CPU, the calls of the plain
version standing in for them): the count that says the route engaged.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

ADAM_LAUNCHES = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _lib():
    from meme_challenge_tpu_torch.ops import cuda_build

    lib = cuda_build.load("fused_adam")
    if not getattr(lib, "typed", False):
        vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.fused_adam.argtypes = [i, i, i, i, vp, vp, vp, vp, vp, vp, vp,
                                   vp, vp, vp, f, f, f, f, f, f, vp]
        lib.fused_adam.restype = i
        lib.fused_adam_max_leaves.argtypes = []
        lib.fused_adam_max_leaves.restype = i
        lib.typed = True
    return lib


def max_leaves() -> int:
    """Leaves one launch takes (the kernel's parameter table); longer lists
    take several launches."""
    return _lib().fused_adam_max_leaves()


def fused_adam_plain(p, g, mu, nu, decay, scales, clip, *, b1, b2, eps,
                     weight_decay, c1, c2, step_size, adamw) -> None:
    """The kernel's update in plain PyTorch, leaf by leaf, each operation a
    separate fp32 op on Python-float scalars (as the ``_foreach_*`` chain's
    per-tensor ops on the CPU, which divide by ``c1`` and ``c2`` where the
    card multiplies by their reciprocals): ``p``, ``mu``, ``nu`` in
    place."""
    with torch.no_grad():
        for pi, gi, mi, ni, d, s in zip(p, g, mu, nu, decay, scales):
            if clip is not None:
                gi = gi.div(clip[0]).mul(clip[1])
            if d and not adamw:
                gi = gi.add(pi.mul(weight_decay))
            m = mi.float().mul(b1).add(gi.mul(1.0 - b1))
            v = ni.float().mul(b2).add(gi.mul(gi).mul(1.0 - b2))
            u = m.div(c1).div(v.div(c2).sqrt().add(eps))
            if d and adamw:
                u = u.add(pi.mul(weight_decay))
            pi.add_(u.mul(s).mul(step_size))
            mi.copy_(m)
            ni.copy_(v)


def _check(p, g, mu, nu, decay, scales) -> Tuple[torch.device, list]:
    """The kernel's contract, on either device: one device; ``p`` and ``g``
    float32, ``mu`` and ``nu`` float32 or bfloat16, one dtype each across
    the leaves; every tensor contiguous, with as many elements as its ``p``.
    Returns (the device, each leaf's element count)."""
    n = len(p)
    if n == 0 or not (len(g) == len(mu) == len(nu) == len(decay)
                      == len(scales) == n):
        raise ValueError("fused Adam takes n >= 1 leaves of p, g, mu, nu, "
                         "decay and scales alike; got %d, %d, %d, %d, %d, %d"
                         % (n, len(g), len(mu), len(nu), len(decay),
                            len(scales)))
    device = p[0].device
    if device.type not in ("cpu", "cuda"):
        raise ValueError("fused Adam runs on cuda or cpu tensors, got %s"
                         % device)
    index = p[0].get_device()
    numel = [t.numel() for t in p]
    for name, ts, dtypes in (("p", p, (torch.float32,)),
                             ("g", g, (torch.float32,)),
                             ("mu", mu, tuple(_DTYPE_CODE)),
                             ("nu", nu, tuple(_DTYPE_CODE))):
        dt = ts[0].dtype
        if dt not in dtypes or any(t.dtype is not dt for t in ts):
            raise TypeError("fused Adam: %s must be %s, one dtype for every "
                            "leaf; got %s" % (name, " or ".join(
                                map(str, dtypes)), sorted({str(t.dtype)
                                                           for t in ts})))
        if any(t.get_device() != index for t in ts):
            raise ValueError("fused Adam: every %s must be on %s"
                             % (name, device))
        if not all(t.is_contiguous() for t in ts):
            raise ValueError("fused Adam: every %s must be contiguous" % name)
        if [t.numel() for t in ts] != numel:
            raise ValueError("fused Adam: each %s must have as many elements "
                             "as its parameter" % name)
    return device, numel


def adam_update(p: Sequence[torch.Tensor], g: Sequence[torch.Tensor],
                mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
                decay: Sequence[bool], scales: Sequence[float],
                clip: Optional[Tuple[torch.Tensor, torch.Tensor]],
                sched: torch.Tensor, *, b1: float, b2: float, eps: float,
                weight_decay: float, adamw: bool) -> None:
    """Update ``p``, ``mu``, ``nu`` in place from ``g``.

    ``decay[i]``: leaf i takes the L2 decay ``weight_decay`` (after the
    moments with ``adamw``); ``scales[i]`` its update scale (1.0 for none);
    ``clip``: the global-norm clip's ``(div, mul)`` fp32 device scalars, or
    None. ``sched``: the step's scalars, a 3-element float32 tensor on the
    leaves' device: the bias corrections ``c1``, ``c2`` and the signed step
    size ``−lr·schedule``. The other scalars are Python floats, rounded once
    to fp32."""
    global ADAM_LAUNCHES
    device, numel = _check(p, g, mu, nu, decay, scales)
    for what, ts, n in (("the clip's factors", clip or (), 1),
                        ("the step's scalars", (sched,), 3)):
        for t in ts:
            if (t.device != device or t.dtype is not torch.float32
                    or t.numel() != n or not t.is_contiguous()):
                raise ValueError("fused Adam: %s must be %d-element float32 "
                                 "tensors on %s" % (what, n, device))
    hyper = dict(b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                 adamw=adamw)
    if device.type == "cpu":
        c1, c2, step_size = sched.tolist()
        fused_adam_plain(p, g, mu, nu, decay, scales, clip, c1=c1, c2=c2,
                         step_size=step_size, **hyper)
        ADAM_LAUNCHES += 1
        return
    chunk = max_leaves()
    for a in range(0, len(p), chunk):
        z = slice(a, a + chunk)
        _launch(p[z], g[z], mu[z], nu[z], numel[z], decay[z], scales[z],
                clip, sched, device, **hyper)
        ADAM_LAUNCHES += 1


def _addresses(ts: List[torch.Tensor]) -> np.ndarray:
    return np.fromiter((t.data_ptr() for t in ts), dtype=np.uint64,
                       count=len(ts))


def _launch(p, g, mu, nu, numel, decay, scales, clip, sched, device, *, b1,
            b2, eps, weight_decay, adamw) -> None:
    lib = _lib()
    table = (_addresses(p), _addresses(g), _addresses(mu), _addresses(nu),
             np.asarray(numel, dtype=np.int64),
             np.asarray(scales, dtype=np.float32),
             np.asarray(decay, dtype=np.uint8))
    div, mul = ((None, None) if clip is None
                else (clip[0].data_ptr(), clip[1].data_ptr()))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fused_adam(
            _DTYPE_CODE[mu[0].dtype], _DTYPE_CODE[nu[0].dtype], int(adamw),
            len(p), *(a.ctypes.data for a in table), div, mul,
            sched.data_ptr(), b1, 1.0 - b1, b2, 1.0 - b2, eps, weight_decay,
            stream)
    if err != 0:
        raise RuntimeError("fused_adam launch failed: CUDA error %d" % err)
