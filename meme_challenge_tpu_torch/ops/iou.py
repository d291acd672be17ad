"""The single home of the pairwise box-IoU primitive (torch ops).

The port of ``meme_challenge_tpu/ops/iou.py``. Its callers need IoU with two
zero-union conventions:

- ``zero_union="zero"``: IoU forced to exactly 0.0 where the union is 0
  (degenerate boxes). Bit-matches the native NMS path, where a zero-area
  box must suppress nothing and be suppressed by nothing (per-class
  selection NMS, ``ops/nms.py``).
- ``zero_union="eps"``: ``inter / (union + 1e-12)``, the detectron2
  matcher/NMS convention (``extract/ops.py: nms``).

Areas have no +1 (Caffe extraction NMS and detectron2 agree here).
"""
from __future__ import annotations

from typing import Optional

import torch


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """[N] areas of xyxy boxes, negative extents clamped to 0."""
    return ((boxes[:, 2] - boxes[:, 0]).clamp(min=0.0)
            * (boxes[:, 3] - boxes[:, 1]).clamp(min=0.0))


def pairwise_iou(boxes1: torch.Tensor, boxes2: Optional[torch.Tensor] = None,
                 *, zero_union: str = "zero", eps: float = 1e-12
                 ) -> torch.Tensor:
    """IoU matrix [N, M] for xyxy boxes (M = N when ``boxes2`` is None).

    ``zero_union`` picks the degenerate-union convention (module docstring).
    """
    if zero_union not in ("zero", "eps"):
        raise ValueError(f"unknown zero_union convention: {zero_union!r}")
    if boxes2 is None:
        boxes2 = boxes1
    area1 = box_area(boxes1)
    area2 = box_area(boxes2)
    lt = torch.maximum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.minimum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[:, None] + area2[None, :] - inter
    if zero_union == "zero":
        return torch.where(union > 0, inter / union,
                           torch.zeros((), dtype=inter.dtype,
                                       device=inter.device))
    return inter / (union + eps)
