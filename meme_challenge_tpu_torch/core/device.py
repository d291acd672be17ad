"""Device selection for the port's entry points.

Entry points run on CUDA unless the caller asks for the CPU. Asking for
``cuda`` where no card is present raises; nothing carries on silently on the
CPU.
"""
from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device %r asked for, but torch.cuda.is_available() is false; "
            "pass --device cpu (or device='cpu') to run on the CPU" % name)
    if device.type not in ("cuda", "cpu"):
        raise ValueError("device must be cuda[:N] or cpu, got %r" % name)
    return device
