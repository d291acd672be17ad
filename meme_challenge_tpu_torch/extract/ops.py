"""Device versions of the extraction ops, as torch ops.

The port of ``meme_challenge_tpu/extract/ops.py``. The C++ ops in
``extract/native.py`` are the host implementations; these run on the
detector's device: greedy NMS with a fixed output size, the vectorised
bilinear ROIAlign, and the Caffe ROIPool whose bins are quantized on the
host (:func:`roi_bin_quantize`, numpy, a copy of the JAX helper).

The ROIPool is formulated anew. The JAX version takes its max through a
masked select over ``[R, ph, H, W, C]``, which XLA fuses into the reduction;
eager torch would materialise it (tens of GB at one 600 × 800 image). Here
each bin is the max of four lookups in a 2-D range-max table of the map
(levels of power-of-two window sizes, only as many as the widest bin
needs). Max is exact, so the result is bit-equal to the masked form and to
``native.roi_pool``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from meme_challenge_tpu_torch.ops.iou import pairwise_iou


def nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
        max_out: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy NMS with a fixed output size.

    Returns (keep_idx [max_out] int32, keep_mask [max_out] bool): indices of
    kept boxes in descending-score order, padded with −1.
    """
    n = boxes.shape[0]
    dev = boxes.device
    keep_idx = torch.full((max_out,), -1, dtype=torch.int32, device=dev)
    keep_mask = torch.zeros((max_out,), dtype=torch.bool, device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype, device=dev)
    for k in range(min(max_out, n)):
        masked = torch.where(alive, scores, neg_inf)
        i = torch.argmax(masked)
        valid = masked[i] > neg_inf
        keep_idx[k] = torch.where(valid, i.to(torch.int32), -1)
        keep_mask[k] = valid
        # one row at a time: the full [n, n] matrix would be prohibitive at
        # proposal counts
        row = pairwise_iou(boxes.index_select(0, i.view(1)), boxes,
                           zero_union="eps")[0]
        alive = alive & ~(row > iou_threshold) & valid
        alive[i] = False
    return keep_idx, keep_mask


def roi_align(feat: torch.Tensor, rois: torch.Tensor, spatial_scale: float,
              output_size: Tuple[int, int], sampling_ratio: int = 2,
              aligned: bool = True) -> torch.Tensor:
    """ROIAlign forward, vectorised. feat [C,H,W], rois [R,4] → [R,C,ph,pw].

    ``sampling_ratio`` is fixed and positive (the adaptive mode of the
    native op is data-dependent; 2 matches detectron2's defaults closely for
    typical box sizes)."""
    C, H, W = feat.shape
    ph, pw = output_size
    offset = 0.5 if aligned else 0.0
    sr = max(int(sampling_ratio), 1)
    dev, f32 = feat.device, torch.float32
    x1 = rois[:, 0] * spatial_scale - offset
    y1 = rois[:, 1] * spatial_scale - offset
    x2 = rois[:, 2] * spatial_scale - offset
    y2 = rois[:, 3] * spatial_scale - offset
    roi_w = x2 - x1
    roi_h = y2 - y1
    if not aligned:
        roi_w = roi_w.clamp(min=1.0)
        roi_h = roi_h.clamp(min=1.0)
    bin_h = (roi_h / ph)[:, None, None]
    bin_w = (roi_w / pw)[:, None, None]
    # sample grid [ph*sr] x [pw*sr]: y = y1 + py·bin_h + (iy+0.5)·bin_h/sr
    isr = (torch.arange(sr, dtype=f32, device=dev) + 0.5)[None, None, :]
    ys = (y1[:, None, None]
          + torch.arange(ph, dtype=f32, device=dev)[None, :, None] * bin_h
          + isr * bin_h / sr).reshape(-1, ph * sr)             # [R, ph·sr]
    xs = (x1[:, None, None]
          + torch.arange(pw, dtype=f32, device=dev)[None, :, None] * bin_w
          + isr * bin_w / sr).reshape(-1, pw * sr)             # [R, pw·sr]

    def axis(v, size):
        # detectron2 border rules along one axis
        outside = (v < -1.0) | (v > size)
        v = v.clamp(min=0.0)
        v0 = torch.floor(v).to(torch.int64).clamp(0, size - 1)
        v = torch.where(v0 >= size - 1, torch.full_like(v, size - 1), v)
        v1 = (v0 + 1).clamp(max=size - 1)
        lv = v - v0
        return outside, v0, v1, lv, 1.0 - lv

    out_y, y0, y1i, ly, hy = axis(ys, H)
    out_x, x0, x1i, lx, hx = axis(xs, W)
    # [C, R, ph·sr, pw·sr] corners
    p00 = feat[:, y0[:, :, None], x0[:, None, :]]
    p01 = feat[:, y0[:, :, None], x1i[:, None, :]]
    p10 = feat[:, y1i[:, :, None], x0[:, None, :]]
    p11 = feat[:, y1i[:, :, None], x1i[:, None, :]]
    hy, ly = hy[:, :, None], ly[:, :, None]
    hx, lx = hx[:, None, :], lx[:, None, :]
    v = hy * hx * p00 + hy * lx * p01 + ly * hx * p10 + ly * lx * p11
    outside = out_y[:, :, None] | out_x[:, None, :]
    v = torch.where(outside, torch.zeros((), dtype=v.dtype, device=dev), v)
    v = v.reshape(C, rois.shape[0], ph, sr, pw, sr).mean(dim=(3, 5))
    return v.permute(1, 0, 2, 3).contiguous()


def roi_bin_quantize(rois, spatial_scale: float,
                     output_size: Tuple[int, int]):
    """Caffe ROIPool bin quantization in exact HOST fp32.

    Round-half-away box quantization, +1 box size, and the fp32 bin-size
    division of csrc/bua_ops.cpp (``roi_pool_f32``), in numpy: the
    division stays on the host, as in the JAX package, so the device does
    only the products ``floor(py·bin_h)`` and ``ceil((py+1)·bin_h)``. A copy
    of the JAX helper, shared by :func:`roi_pool_device` and the detector's
    ROI stage.

    Returns ``(x1, y1, bin_h, bin_w)`` numpy arrays.
    """
    ph, pw = output_size
    rois = np.asarray(rois, np.float32)
    q = np.floor(rois * np.float32(spatial_scale) + np.float32(0.5)
                 ).astype(np.int32)
    x1, y1 = q[:, 0], q[:, 1]
    roi_w = np.maximum(q[:, 2] - x1 + 1, 1).astype(np.float32)
    roi_h = np.maximum(q[:, 3] - y1 + 1, 1).astype(np.float32)
    return x1, y1, roi_h / np.float32(ph), roi_w / np.float32(pw)


def _levels(max_bin: float, size: int) -> int:
    """Range-max levels (window sizes 1, 2, 4, ...) enough for the widest
    bin: a bin spans at most ceil(bin) + 2 cells (the fp32 products of its
    edges included) and never more than the map."""
    widest = min(size, int(np.ceil(max_bin)) + 2) if size else 1
    return max(widest, 1).bit_length()


def _range_max_table(feat_hwc: torch.Tensor, ky: int, kx: int
                     ) -> torch.Tensor:
    """[ky, kx, H, W, C]: entry (a, b, y, x) is the max of the map over rows
    y .. y+2^a−1 and columns x .. x+2^b−1 (indices clipped at the border;
    the clipped entries are never read)."""
    H, W, C = feat_hwc.shape
    dev = feat_hwc.device
    table = torch.empty((ky, kx, H, W, C), dtype=feat_hwc.dtype, device=dev)
    table[0, 0] = feat_hwc
    for b in range(1, kx):
        idx = (torch.arange(W, device=dev) + (1 << (b - 1))).clamp(max=W - 1)
        torch.maximum(table[0, b - 1], table[0, b - 1][:, idx],
                      out=table[0, b])
    for a in range(1, ky):
        idx = (torch.arange(H, device=dev) + (1 << (a - 1))).clamp(max=H - 1)
        torch.maximum(table[a - 1], table[a - 1][:, idx], out=table[a])
    return table


def _floor_log2(length: torch.Tensor, levels: int) -> torch.Tensor:
    """floor(log2(length)) for lengths 1 .. 2^levels − 1, in integers."""
    k = torch.zeros_like(length)
    for j in range(1, levels):
        k += (length >= (1 << j)).to(length.dtype)
    return k


def roi_pool_device(feat: torch.Tensor, rois, spatial_scale: float,
                    output_size: Tuple[int, int]) -> torch.Tensor:
    """Caffe ROIPool, exact csrc/bua_ops.cpp ``roi_pool_f32`` semantics; the
    max pooling runs on ``feat``'s device.

    feat [C, H, W] (the res4 map of one image); rois [R, 4] HOST numpy in
    image coordinates (the proposal stage is host-side anyway); bins from
    :func:`roi_bin_quantize`. Returns [R, C, ph, pw]; an empty bin is 0.
    """
    C, H, W = feat.shape
    ph, pw = output_size
    x1, y1, bin_h, bin_w = roi_bin_quantize(rois, spatial_scale, output_size)
    R = len(x1)
    dev = feat.device
    ky = _levels(float(bin_h.max()) if R else 0.0, H)
    kx = _levels(float(bin_w.max()) if R else 0.0, W)

    def edges(start, size, n, length):
        start = torch.from_numpy(start.astype(np.int64)).to(dev)[:, None]
        size = torch.from_numpy(size).to(dev)[:, None]
        p = torch.arange(n, dtype=torch.float32, device=dev)[None]
        lo = (start + torch.floor(p * size).to(torch.int64)).clamp(0, length)
        hi = (start + torch.ceil((p + 1) * size).to(torch.int64)).clamp(
            0, length)
        return lo, hi                                        # [R, n]

    hs, he = edges(y1, bin_h, ph, H)
    ws, we = edges(x1, bin_w, pw, W)
    empty = (hs >= he)[:, :, None] | (ws >= we)[:, None, :]   # [R, ph, pw]
    # each non-empty bin: four (overlapping) power-of-two windows cover it
    a = _floor_log2((he - hs).clamp(min=1), ky)
    b = _floor_log2((we - ws).clamp(min=1), kx)
    rows = [hs.clamp(max=H - 1), (he - (1 << a)).clamp(min=0)]
    cols = [ws.clamp(max=W - 1), (we - (1 << b)).clamp(min=0)]
    level = (a * kx)[:, :, None] + b[:, None, :]              # [R, ph, pw]
    table = _range_max_table(feat.permute(1, 2, 0).contiguous(), ky, kx
                             ).reshape(-1, C)
    out = None
    for r in rows:
        for c in cols:
            lin = (level * H + r[:, :, None]) * W + c[:, None, :]
            got = table.index_select(0, lin.reshape(-1))
            out = got if out is None else torch.maximum(out, got, out=out)
    out.masked_fill_(empty.reshape(-1, 1), 0.0)
    return out.reshape(R, ph, pw, C).permute(0, 3, 1, 2).contiguous()
