"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU. Asking for
``cuda`` where no card is present raises; nothing carries on silently on the
CPU.

Under ``torchrun`` (one process a card) ``cuda`` is this process's card,
``cuda:$LOCAL_RANK``.

A ``cuda`` device also pins fp32 numerics: TF32 is turned off for matmuls
and for cuDNN (whose default is on), so the convolutions and products of
every entry point compute in fp32, as the JAX package's parity runs do
(matmul precision "highest").
"""
from __future__ import annotations

import os

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    device = torch.device(name)
    if (device.type == "cuda" and device.index is None
            and "LOCAL_RANK" in os.environ):
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device %r asked for, but torch.cuda.is_available() is false; "
            "pass --device cpu (or device='cpu') to run on the CPU" % name)
    if device.type not in ("cuda", "cpu"):
        raise ValueError("device must be cuda[:N] or cpu, got %r" % name)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device
