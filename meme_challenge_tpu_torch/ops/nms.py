"""Batched greedy per-class NMS on the device (torch ops).

The port of ``meme_challenge_tpu/ops/nms.py``. The extraction box-selection
rule (reference utils/extract_utils.py:59-80) runs per-class NMS over all
1600 foreground classes for every image. Here it is one pass of torch ops:

- the proposals are class-agnostic, so the [R, R] IoU matrix is computed
  once and shared by every class;
- per class, exact greedy NMS (stable descending-score order, suppress at
  IoU > thresh, bit-matching csrc/bua_ops.cpp ``nms_max_conf_f32``) runs as
  one loop over the R sorted positions, all classes of a chunk at once;
- ``class_chunk`` classes go through the loop together, so the permuted
  suppression tensor is [chunk, R, R] booleans (all 1600 classes at
  R 300 are 144 MB).

Rows are not padded to a fixed R (the JAX version pads to 304 to reuse one
compiled program): zero-area, zero-score rows change no result.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from meme_challenge_tpu_torch.ops.iou import pairwise_iou as _iou


def pairwise_iou(boxes: torch.Tensor) -> torch.Tensor:
    """Self-IoU, Caffe-NMS conventions (no +1 area, zero-union → 0), through
    the shared primitive (ops/iou.py)."""
    return _iou(boxes, zero_union="zero")


def _chunk_keep(over: torch.Tensor, scores_chunk: torch.Tensor
                ) -> torch.Tensor:
    """Greedy NMS for a chunk of classes. ``over`` [R, R] is IoU > thresh;
    scores_chunk [K, R] → keep [K, R] (original box order)."""
    K, R = scores_chunk.shape
    order = torch.argsort(-scores_chunk, dim=1, stable=True)    # [K, R]
    # position i suppresses a later position j (j > i) it overlaps
    later = torch.ones((R, R), dtype=torch.bool,
                       device=over.device).triu_(1)
    sup = over[order[:, :, None], order[:, None, :]] & later     # [K, R, R]
    suppressed = torch.zeros((K, R), dtype=torch.bool, device=over.device)
    for i in range(R):
        # a position is kept iff no kept earlier position suppressed it;
        # column i is final once positions < i have run
        suppressed |= (~suppressed[:, i])[:, None] & sup[:, i, :]
    keep = torch.zeros_like(suppressed)
    keep.scatter_(1, order, ~suppressed)
    return keep


def batched_max_conf(boxes: torch.Tensor, cls_prob: torch.Tensor, *,
                     thresh: float, class_chunk: int = 128) -> torch.Tensor:
    """Per-box max confidence surviving per-class NMS.

    boxes [R, 4]; cls_prob [R, C] with background at column 0 (skipped,
    reference extract_utils.py:68-74). Returns max_conf [R].
    """
    over = pairwise_iou(boxes) > thresh
    scores = cls_prob[:, 1:].T                                  # [C-1, R]
    best = torch.zeros((cls_prob.shape[0],), dtype=cls_prob.dtype,
                       device=cls_prob.device)
    for start in range(0, scores.shape[0], class_chunk):
        chunk = scores[start:start + class_chunk]
        keep = _chunk_keep(over, chunk)
        zero = torch.zeros((), dtype=chunk.dtype, device=chunk.device)
        best = torch.maximum(best, torch.where(keep, chunk, zero).amax(0))
    return best


def max_conf_device(boxes: np.ndarray, cls_prob: np.ndarray, thresh: float,
                    device="cuda", class_chunk: Optional[int] = None
                    ) -> np.ndarray:
    """Host wrapper: run :func:`batched_max_conf` on ``device``, return
    numpy. ``class_chunk`` None takes all classes in one chunk."""
    b = torch.as_tensor(np.asarray(boxes, np.float32), device=device)
    p = torch.as_tensor(np.asarray(cls_prob, np.float32), device=device)
    chunk = class_chunk or max(p.shape[1] - 1, 1)
    return batched_max_conf(b, p, thresh=float(thresh),
                            class_chunk=chunk).cpu().numpy()
