"""Operations and bytes of the detector's train step, counted from shapes.

- :func:`forward_flops`: the model FLOPs of one image's forward at a blob
  of ``H × W``, two a multiply-add, of every convolution and Linear: the
  backbone through res4 (stem, res2-res4), the RPN's 3 × 3 and its two
  1 × 1 convolutions over the res4 map, res5 on each ROI at the pooler's
  resolution, and the class, box and attribute predictors on each ROI.
  Biases, the frozen batch norms' affines, pooling, ROIAlign, the losses
  and the class embedding's lookup are not counted. A training step costs
  three forwards (the backward twice the forward), whatever parts of the
  backward the program skips (the image's own gradient).
- :func:`roi_align_bytes`: the least bytes of ROIAlign at the step's
  shapes, each read or written once, in float32: forward, the res4 map
  read and the pooled output written; backward as many, the pooled
  output's cotangent read and the map's gradient written.
"""
from __future__ import annotations

from typing import Tuple

from portbench.reference.detector import stages

ITEM_BYTES = 4


def conv_out(n: int, kernel: int, stride: int = 1, padding: int = 0,
             dilation: int = 1) -> int:
    return (n + 2 * padding - dilation * (kernel - 1) - 1) // stride + 1


def conv_flops(cin: int, cout: int, kernel: int, h: int, w: int,
               stride: int = 1, padding: int = 0, dilation: int = 1
               ) -> Tuple[float, int, int]:
    """(FLOPs, output height, output width) of one convolution."""
    ho = conv_out(h, kernel, stride, padding, dilation)
    wo = conv_out(w, kernel, stride, padding, dilation)
    return 2.0 * cin * cout * kernel * kernel * ho * wo, ho, wo


def stage_flops(blocks: int, cin: int, cout: int, mid: int, h: int, w: int,
                stride: int, dilation: int = 1) -> Tuple[float, int, int]:
    """A stage of Caffe bottlenecks (stride on the first 1 × 1)."""
    total = 0.0
    for i in range(blocks):
        s = stride if i == 0 else 1
        if i == 0 and (cin != cout or s != 1):
            total += conv_flops(cin, cout, 1, h, w, s)[0]
        f1, h1, w1 = conv_flops(cin if i == 0 else cout, mid, 1, h, w, s)
        f2, h2, w2 = conv_flops(mid, mid, 3, h1, w1, 1, dilation, dilation)
        f3, h, w = conv_flops(mid, cout, 1, h2, w2)
        total += f1 + f2 + f3
    return total, h, w


def backbone_flops(cfg: dict, h: int, w: int) -> Tuple[float, int, int]:
    """(FLOPs, map height, map width) of the stem and res2-res4."""
    total, h, w = conv_flops(3, cfg["stem_out_channels"], 7, h, w, 2, 3)
    h, w = conv_out(h, 3, 2, 1), conv_out(w, 3, 2, 1)          # max pool
    for _, blocks, cin, cout, mid, stride, dilation in stages(cfg)[:3]:
        f, h, w = stage_flops(blocks, cin, cout, mid, h, w, stride, dilation)
        total += f
    return total, h, w


def rpn_flops(cfg: dict, fh: int, fw: int) -> float:
    A = len(cfg["anchor_scales"]) * len(cfg["anchor_ratios"])
    c = cfg["rpn_channels"]
    return (conv_flops(stages(cfg)[2][3], c, 3, fh, fw, 1, 1)[0]
            + conv_flops(c, 2 * A, 1, fh, fw)[0]
            + conv_flops(c, 4 * A, 1, fh, fw)[0])


def roi_flops(cfg: dict, rois: int) -> float:
    """res5 and the predictors on ``rois`` ROIs."""
    r = cfg["pooler_resolution"]
    _, blocks, cin, top, mid, stride, dilation = stages(cfg)[3]
    res5 = stage_flops(blocks, cin, top, mid, r, r, stride, dilation)[0]
    k, a = cfg["num_classes"], cfg["num_attributes"]
    emb, hid = cfg["cls_embed_dim"], cfg["attr_hidden_dim"]
    heads = 2.0 * (top * k + top * 4 * k + (top + emb) * hid + hid * a)
    return rois * (res5 + heads)


def forward_flops(cfg: dict, h: int, w: int, rois: int) -> float:
    """Model FLOPs of one image's forward at a blob of ``h × w`` with
    ``rois`` ROIs."""
    f, fh, fw = backbone_flops(cfg, h, w)
    return f + rpn_flops(cfg, fh, fw) + roi_flops(cfg, rois)


def step_flops(cfg: dict, h: int, w: int, rois: int) -> float:
    """A train step on one image: three forwards."""
    return 3.0 * forward_flops(cfg, h, w, rois)


def roi_align_bytes(cfg: dict, h: int, w: int, rois: int) -> float:
    """The least bytes of ROIAlign's forward, or of its backward, at a
    blob of ``h × w`` with ``rois`` ROIs (see the module's note)."""
    _, fh, fw = backbone_flops(cfg, h, w)
    r = cfg["pooler_resolution"]
    return ITEM_BYTES * stages(cfg)[2][3] * (fh * fw + rois * r * r)
