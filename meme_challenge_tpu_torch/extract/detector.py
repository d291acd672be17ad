"""BUA Faster R-CNN detector: RPN, ROI heads, and the extraction pipeline.

The port of ``meme_challenge_tpu/extract/detector.py``. Parity target: the
reference's ``GeneralizedBUARCNN`` inference path
(bottom-up-attention.pytorch, configs/bua-caffe/extract-bua-caffe-r101.yaml):

- **BUA RPN** (StandardBUARPNHead): 3×3 conv (512 ch) → objectness +
  box deltas over 12 anchors (scales [4, 8, 16, 32] × stride 16, ratios
  [0.5, 1, 2]); proposal selection pre-NMS topk 6000 → NMS 0.7 → topk 300,
  min size 16 (PROPOSAL_GENERATOR.MIN_SIZE).
- **BUACaffeRes5ROIHeads**: ROIPool 14×14 on res4 → res5 (dilation 2) →
  global average pool (2048-d region features) → 1601-way classifier +
  bbox regression + 401-way attribute head.
- **Extraction post-processing** (reference utils/extract_utils.py:59-110):
  per-class NMS (IoU 0.3) over the 1600 foreground classes, per-box max
  confidence, conf-threshold ∩ [MIN_BOXES=10, MAX_BOXES=100] box budget,
  npz export {x, bbox, num_bbox, image_h/w, info{objects_id, objects_conf,
  attrs_id, attrs_conf}}.
- **Modes** (reference extract_features.py:100-129): 1 = ROI features,
  2 = bboxes only, 3 = features from given (gt) bboxes.

Image preprocessing is Caffe-style: BGR, per-channel mean subtraction
(PIXEL_MEAN [102.9801, 115.9465, 122.7717]), shortest side 600 / longest
1000 (utils/extract_utils.py:28-57); the host helpers are numpy copies of
the JAX package's.

The backbone, RPN and ROI heads run on the extractor's device in NCHW; the
proposal stage and the selection NMS run on the host through the native
C++ ops (``extract/native.py``), with torch versions in ``extract/ops.py``
and ``ops/nms.py``. Parameters carry detectron2's key layout
(``backbone.*``, ``proposal_generator.rpn_head.*``, ``roi_heads.res5.*``,
``roi_heads.box_predictor.*``), so the reference checkpoint loads almost as
it stands (``extract/convert_detector.py``).
"""
from __future__ import annotations

import dataclasses
import logging
import math
from collections import deque
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from meme_challenge_tpu_torch.core.device import resolve_device
from meme_challenge_tpu_torch.extract import native
from meme_challenge_tpu_torch.extract.ops import roi_pool_device
from meme_challenge_tpu_torch.extract.resnet import (
    CaffeResNetBackbone,
    FrozenBN,
    Res5Head,
)

logger = logging.getLogger("meme_challenge_tpu_torch.extract")

PIXEL_MEAN_BGR = np.array([102.9801, 115.9465, 122.7717], np.float32)
NMS_IMPLS = ("native_batched", "device", "host_loop")


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    depth: int = 101
    anchor_scales: Tuple[int, ...] = (4, 8, 16, 32)
    anchor_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    anchor_base: int = 16                 # feature stride
    rpn_channels: int = 512
    pre_nms_topk: int = 6000
    post_nms_topk: int = 300
    rpn_nms_thresh: float = 0.7
    rpn_min_size: float = 16.0
    num_classes: int = 1601               # incl. background at index 0
    num_attributes: int = 401
    pooler_resolution: int = 14
    test_nms_thresh: float = 0.3
    min_boxes: int = 10
    max_boxes: int = 100
    conf_thresh: float = 0.2
    min_size: int = 600
    max_size: int = 1000
    # pad blobs to multiples (detectron2 pads the same way); the padded
    # border changes the features near it, so it stays
    size_divisibility: int = 64
    # host->device blob transfer dtype: "float32" (the parity default),
    # "bfloat16" (host cast, rounded to nearest even; compute stays fp32 on
    # the device) or "uint8" (the RESIZED image before mean subtraction;
    # the device subtracts the mean: bilinear resize and the constant
    # mean-shift commute, so only the <=0.5/255 rounding differs)
    blob_transfer_dtype: str = "float32"


def make_anchors(cfg: DetectorConfig, feat_h: int, feat_w: int) -> np.ndarray:
    """Dense anchors [H*W*A, 4] in image coordinates (x1,y1,x2,y2).

    py-faster-rcnn/Caffe convention (the BUA checkpoints' anchors): cell
    anchors derive from the base box [0, 0, base−1, base−1], i.e. centered
    at (base−1)/2 = 7.5 for stride 16, then shifted by stride·(x, y)."""
    base = cfg.anchor_base
    ctr = (base - 1) / 2.0
    anchors = []
    for ratio in cfg.anchor_ratios:
        # ratio enumerated first (caffe generate_anchors order), rounded
        # like the original implementation
        size = base * base
        ws = np.round(np.sqrt(size / ratio))
        hs = np.round(ws * ratio)
        for scale in cfg.anchor_scales:
            w, h = ws * scale, hs * scale
            anchors.append([ctr - 0.5 * (w - 1), ctr - 0.5 * (h - 1),
                            ctr + 0.5 * (w - 1), ctr + 0.5 * (h - 1)])
    cell = np.asarray(anchors, np.float32)                 # [A, 4]
    ys = (np.arange(feat_h, dtype=np.float32)) * base
    xs = (np.arange(feat_w, dtype=np.float32)) * base
    shift_x, shift_y = np.meshgrid(xs, ys)
    shifts = np.stack([shift_x, shift_y, shift_x, shift_y],
                      axis=-1).reshape(-1, 1, 4)
    return (shifts + cell[None]).reshape(-1, 4)


def decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> torch.Tensor:
    """Faster R-CNN box decoding (BBOX_REG_WEIGHTS (1,1,1,1))."""
    wx, wy, ww, wh = weights
    widths = anchors[:, 2] - anchors[:, 0]
    heights = anchors[:, 3] - anchors[:, 1]
    cx = anchors[:, 0] + 0.5 * widths
    cy = anchors[:, 1] + 0.5 * heights
    dx, dy, dw, dh = (deltas[:, 0] / wx, deltas[:, 1] / wy,
                      deltas[:, 2] / ww, deltas[:, 3] / wh)
    dw = dw.clamp(max=4.135)  # log(1000/16): detectron2 clamp
    dh = dh.clamp(max=4.135)
    pcx = dx * widths + cx
    pcy = dy * heights + cy
    pw = torch.exp(dw) * widths
    ph = torch.exp(dh) * heights
    return torch.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                        pcx + 0.5 * pw, pcy + 0.5 * ph], dim=1)


class BUARPNHead(nn.Module):
    """3×3 conv → objectness + deltas (StandardBUARPNHead, 512 channels).

    Caffe RPN convention: objectness is **2 channels per anchor**
    (``[A background | A foreground]``) scored by softmax over the pair,
    matching the BUA checkpoints' ``2A``-channel conv."""

    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        A = len(cfg.anchor_scales) * len(cfg.anchor_ratios)
        self.conv = nn.Conv2d(1024, cfg.rpn_channels, 3, padding=1)
        self.objectness_logits = nn.Conv2d(cfg.rpn_channels, 2 * A, 1)
        self.anchor_deltas = nn.Conv2d(cfg.rpn_channels, 4 * A, 1)

    def forward(self, feat: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        t = F.relu(self.conv(feat))
        return self.objectness_logits(t), self.anchor_deltas(t)


class BoxPredictor(nn.Module):
    """Classification, regression and the BUA attribute head (class
    embedding ⊕ pooled feature → fc → attributes)."""

    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        self.cls_score = nn.Linear(2048, cfg.num_classes)
        self.bbox_pred = nn.Linear(2048, cfg.num_classes * 4)
        self.cls_embedding = nn.Embedding(cfg.num_classes, 256)
        self.attr_linear1 = nn.Linear(2048 + 256, 512)
        self.attr_linear2 = nn.Linear(512, cfg.num_attributes)

    def forward(self, feats: torch.Tensor) -> Dict[str, torch.Tensor]:
        cls_prob = torch.softmax(self.cls_score(feats), dim=-1)
        deltas = self.bbox_pred(feats)
        top_class = torch.argmax(cls_prob[:, 1:], dim=-1) + 1
        attr_in = torch.cat([feats, self.cls_embedding(top_class)], dim=-1)
        attr_logits = self.attr_linear2(F.relu(self.attr_linear1(attr_in)))
        return {
            "features": feats,
            "cls_prob": cls_prob,
            "bbox_deltas": deltas,
            "attr_prob": torch.softmax(attr_logits, dim=-1),
        }


class BUAROIHead(nn.Module):
    """res5 + classification/regression/attribute outputs over pooled ROIs."""

    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        self.res5 = Res5Head(cfg.depth)
        self.box_predictor = BoxPredictor(cfg)

    def forward(self, pooled: torch.Tensor) -> Dict[str, torch.Tensor]:
        """pooled: [R, 1024, ph, pw] (NCHW) → heads."""
        feats = self.res5(pooled).mean(dim=(2, 3))        # [R, 2048]
        return self.box_predictor(feats)


class BUADetector(nn.Module):
    """Backbone + RPN head + ROI head, in detectron2's key layout."""

    def __init__(self, cfg: DetectorConfig):
        super().__init__()
        self.cfg = cfg
        self.backbone = CaffeResNetBackbone(cfg.depth)
        self.proposal_generator = nn.Module()
        self.proposal_generator.rpn_head = BUARPNHead(cfg)
        self.roi_heads = BUAROIHead(cfg)

    def backbone_rpn(self, images: torch.Tensor):
        """images [B, 3, H, W] → res4 map, objectness [B, 2A, h, w], deltas
        [B, 4A, h, w]."""
        feat = self.backbone(images)
        logits, deltas = self.proposal_generator.rpn_head(feat)
        return feat, logits, deltas

    def roi_forward(self, pooled: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.roi_heads(pooled)


def init_detector(cfg: DetectorConfig, generator: torch.Generator
                  ) -> BUADetector:
    """A detector with random weights from ``generator`` (on the CPU), drawn
    from the JAX package's initializers (``init_detector_params``): flax's
    lecun-normal for conv and dense kernels (a normal truncated at two
    deviations, variance 1 / fan_in), zero biases, FrozenBN weight 1 and
    bias 0, and flax ``Embed``'s normal(1 / sqrt(256)) for the class
    embedding."""
    model = BUADetector(cfg)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
                std = math.sqrt(1.0 / fan_in) / .87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std,
                                      2.0 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Embedding):
                m.weight.normal_(0.0, 1.0 / math.sqrt(m.embedding_dim),
                                 generator=generator)
            elif isinstance(m, FrozenBN):
                m.weight.fill_(1.0)
                m.bias.zero_()
    return model.eval()


# --------------------------------------------------------------------- utils

def _resize_bilinear_np(im: np.ndarray, new_h: int, new_w: int) -> np.ndarray:
    """Host bilinear resize, cv2.INTER_LINEAR semantics: half-pixel sample
    centers, edge clamp, no antialiasing (reference utils/extract_utils.py:
    51-52 resizes the mean-subtracted float image the same way)."""
    h, w = im.shape[:2]
    if (new_h, new_w) == (h, w):
        return np.asarray(im, np.float32)
    ys = (np.arange(new_h, dtype=np.float64) + 0.5) * (h / new_h) - 0.5
    xs = (np.arange(new_w, dtype=np.float64) + 0.5) * (w / new_w) - 0.5
    y0f, x0f = np.floor(ys), np.floor(xs)
    wy = (ys - y0f).astype(np.float32)[:, None, None]
    wx = (xs - x0f).astype(np.float32)[None, :, None]
    y0 = np.clip(y0f, 0, h - 1).astype(np.int64)
    x0 = np.clip(x0f, 0, w - 1).astype(np.int64)
    y1 = np.clip(y0f + 1, 0, h - 1).astype(np.int64)
    x1 = np.clip(x0f + 1, 0, w - 1).astype(np.int64)
    im = np.asarray(im, np.float32)
    r0, r1 = im[y0], im[y1]
    top = r0[:, x0] * (1.0 - wx) + r0[:, x1] * wx
    bot = r1[:, x0] * (1.0 - wx) + r1[:, x1] * wx
    return top * (1.0 - wy) + bot * wy


def _blob_scale(img_shape, cfg: DetectorConfig) -> Tuple[float, int, int]:
    """Shortest side ``min_size`` capped at ``max_size`` (reference
    utils/extract_utils.py:28-57) — shared by every blob-transfer mode so
    the geometry can never desynchronize between them."""
    h, w = img_shape[:2]
    scale = cfg.min_size / min(h, w)
    if scale * max(h, w) > cfg.max_size:
        scale = cfg.max_size / max(h, w)
    return scale, int(round(h * scale)), int(round(w * scale))


def _pad_divisible(im: np.ndarray, cfg: DetectorConfig,
                   pad_values=(0, 0, 0)) -> np.ndarray:
    """Zero-/constant-pad up to ``size_divisibility`` multiples (detectron2
    pads the same way)."""
    div = max(cfg.size_divisibility, 1)
    pad_h = -im.shape[0] % div
    pad_w = -im.shape[1] % div
    if not (pad_h or pad_w):
        return im
    if pad_values == (0, 0, 0):
        return np.pad(im, ((0, pad_h), (0, pad_w), (0, 0)))
    return np.stack([np.pad(im[..., c], ((0, pad_h), (0, pad_w)),
                            constant_values=pad_values[c])
                     for c in range(3)], axis=-1)


def get_image_blob(img_bgr: np.ndarray, cfg: DetectorConfig
                   ) -> Tuple[np.ndarray, float, Tuple[int, int]]:
    """Caffe preprocessing: BGR float − pixel mean, shortest-side resize
    (:func:`_blob_scale`), divisibility padding (:func:`_pad_divisible`).
    Returns (blob [1, Hp, Wp, 3], scale, (true_h, true_w))."""
    im = img_bgr.astype(np.float32) - PIXEL_MEAN_BGR
    scale, new_h, new_w = _blob_scale(im.shape, cfg)
    # host bilinear resize, cv2.INTER_LINEAR convention (half-pixel
    # centers, no antialias), as the reference's cv2.resize
    # (utils/extract_utils.py:51-52)
    im = _resize_bilinear_np(im, new_h, new_w)
    return _pad_divisible(im, cfg)[None], scale, (new_h, new_w)


def get_image_blob_u8(img_bgr: np.ndarray, cfg: DetectorConfig
                      ) -> Tuple[np.ndarray, float, Tuple[int, int]]:
    """uint8 transfer variant of :func:`get_image_blob`: resize the RAW
    image (no mean-sub), round to uint8; the device subtracts the pixel
    mean (see ``DetectorConfig.blob_transfer_dtype``). Same scale/padding
    helpers; differs from the fp32 blob only by the <=0.5 resize rounding.
    Padding uses the rounded pixel mean so it becomes ~0 after the
    on-device mean subtraction (fp32 blobs pad with exact zeros)."""
    scale, new_h, new_w = _blob_scale(img_bgr.shape, cfg)
    im = _resize_bilinear_np(img_bgr.astype(np.float32), new_h, new_w)
    im = np.clip(np.rint(im), 0, 255).astype(np.uint8)
    mean_u8 = tuple(int(round(m)) for m in PIXEL_MEAN_BGR)
    return _pad_divisible(im, cfg, mean_u8)[None], scale, (new_h, new_w)


def transfer_blob(img_bgr: np.ndarray, cfg: DetectorConfig
                  ) -> Tuple[torch.Tensor, float, Tuple[int, int]]:
    """The host blob in ``cfg.blob_transfer_dtype`` as a CPU tensor
    [1, Hp, Wp, 3]: float32 and uint8 as the helpers above make them,
    bfloat16 cast on the host (round to nearest even, as ml_dtypes casts
    it in the JAX package)."""
    if cfg.blob_transfer_dtype == "uint8":
        blob, scale, hw = get_image_blob_u8(img_bgr, cfg)
        return torch.from_numpy(blob), scale, hw
    blob, scale, hw = get_image_blob(img_bgr, cfg)
    t = torch.from_numpy(blob)
    if cfg.blob_transfer_dtype == "bfloat16":
        t = t.to(torch.bfloat16)
    elif cfg.blob_transfer_dtype != "float32":
        raise ValueError("blob_transfer_dtype must be float32, bfloat16 or "
                         "uint8, got %r" % cfg.blob_transfer_dtype)
    return t, scale, hw


def _decode_boxes_np(anchors: np.ndarray, deltas: np.ndarray,
                     weights=(1.0, 1.0, 1.0, 1.0)) -> np.ndarray:
    """Host copy of :func:`decode_boxes`: keeps the proposal stage free of
    device round trips."""
    wx, wy, ww, wh = weights
    widths = anchors[:, 2] - anchors[:, 0]
    heights = anchors[:, 3] - anchors[:, 1]
    cx = anchors[:, 0] + 0.5 * widths
    cy = anchors[:, 1] + 0.5 * heights
    dx, dy = deltas[:, 0] / wx, deltas[:, 1] / wy
    dw = np.minimum(deltas[:, 2] / ww, 4.135)
    dh = np.minimum(deltas[:, 3] / wh, 4.135)
    pcx = dx * widths + cx
    pcy = dy * heights + cy
    pw = np.exp(dw) * widths
    ph = np.exp(dh) * heights
    return np.stack([pcx - 0.5 * pw, pcy - 0.5 * ph,
                     pcx + 0.5 * pw, pcy + 0.5 * ph], axis=1)


class FeatureExtractor:
    """End-to-end extraction driver (reference extract_features.py:41-130).

    Streaming design: ``extract_batch`` keeps up to ``lookahead`` images'
    backbones queued on the device while the host runs an earlier image's
    proposal stage; the small RPN outputs come back through pinned memory
    and an event, so the host waits only for the image it works on. The
    ROI stage runs on exactly the image's R rows.
    """

    def __init__(self, cfg: DetectorConfig, state: Dict[str, torch.Tensor],
                 nms_impl: str = "native_batched", device="cuda"):
        """``state``: a ``BUADetector`` state dict (``init_detector(...)
        .state_dict()``, ``convert_detector.load_detector_weights``), or a
        live ``BUADetector``, used as it stands (detector training
        evaluates its module without a copy of the weights).
        ``nms_impl``: strategy for the 1600-class selection NMS —
        "native_batched" (one C++ call, shared IoU matrix), "device"
        (ops/nms.py on ``device``), or "host_loop" (per-class C++ calls,
        the reference's shape). All three are exact-equal."""
        if nms_impl not in NMS_IMPLS:
            raise ValueError("nms_impl must be one of %s, got %r"
                             % (NMS_IMPLS, nms_impl))
        self.cfg = cfg
        self.device = resolve_device(str(device))
        self.nms_impl = nms_impl
        if isinstance(state, nn.Module):
            self.model = state
        else:
            self.model = BUADetector(cfg)
            self.model.load_state_dict(state, strict=True)
        self.model.to(self.device).eval()
        self._pixel_mean = torch.from_numpy(PIXEL_MEAN_BGR).to(
            self.device)[None, :, None, None]

    # ----------------------------------------------------------- device side

    def _to_host(self, *tensors):
        """Copies of ``tensors`` on the host and the event after which they
        are complete (None on the CPU, where they already are)."""
        if self.device.type != "cuda":
            return [t.contiguous() for t in tensors], None
        out = []
        for t in tensors:
            buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            buf.copy_(t, non_blocking=True)
            out.append(buf)
        event = torch.cuda.Event()
        event.record()
        return out, event

    def _backbone_rpn(self, blob: torch.Tensor):
        """Queue the backbone and RPN of one host blob [1, Hp, Wp, 3];
        returns the res4 map (device), the host objectness [1, h, w, 2A]
        and deltas [1, h, w, 4A] (NHWC, the order ``_proposals`` reads) and
        their event."""
        x = blob.to(self.device, non_blocking=True).permute(0, 3, 1, 2)
        x = x.float()
        if blob.dtype == torch.uint8:
            x = x - self._pixel_mean
        feat, logits, deltas = self.model.backbone_rpn(x.contiguous())
        (logits, deltas), event = self._to_host(logits.permute(0, 2, 3, 1),
                                                deltas.permute(0, 2, 3, 1))
        return feat, logits, deltas, event

    def _roi_stage(self, feat: torch.Tensor, proposals: np.ndarray):
        """ROIPool (exact Caffe bins, extract/ops.py) of the R proposals on
        the image's res4 map [1, 1024, h, w], then the ROI heads."""
        P = self.cfg.pooler_resolution
        pooled = roi_pool_device(feat[0], proposals,
                                 1.0 / self.cfg.anchor_base, (P, P))
        return self.model.roi_forward(pooled)

    # -------------------------------------------------------------- proposals

    def _proposals(self, logits: np.ndarray, deltas: np.ndarray,
                   im_h: int, im_w: int) -> np.ndarray:
        cfg = self.cfg
        fh, fw = logits.shape[1], logits.shape[2]
        A = logits.shape[3] // 2
        anchors = make_anchors(cfg, fh, fw)
        # caffe channel layout: [A background | A foreground]; fg prob via
        # pairwise softmax, all host numpy
        bg = np.asarray(logits[0, :, :, :A], np.float64)
        fg = np.asarray(logits[0, :, :, A:], np.float64)
        z = (fg - bg).reshape(-1)
        scores = np.where(z >= 0, 1.0 / (1.0 + np.exp(-np.abs(z))),
                          np.exp(-np.abs(z)) / (1.0 + np.exp(-np.abs(z)))
                          ).astype(np.float32)
        deltas = np.asarray(deltas[0]).reshape(fh, fw, A, 4).reshape(-1, 4)
        boxes = _decode_boxes_np(anchors, deltas)
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, im_w - 1)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, im_h - 1)
        scores = np.asarray(scores)
        # min-size filter (PROPOSAL_GENERATOR.MIN_SIZE 16)
        keep = ((boxes[:, 2] - boxes[:, 0] >= cfg.rpn_min_size)
                & (boxes[:, 3] - boxes[:, 1] >= cfg.rpn_min_size))
        boxes, scores = boxes[keep], scores[keep]
        order = np.argsort(-scores)[: cfg.pre_nms_topk]
        boxes, scores = boxes[order], scores[order]
        keep_idx = native.nms(boxes, scores, cfg.rpn_nms_thresh)
        keep_idx = keep_idx[: cfg.post_nms_topk]
        return boxes[keep_idx]

    # -------------------------------------------------------------- pipeline

    def extract(self, img_bgr: np.ndarray, mode: int = 1,
                gt_boxes: Optional[np.ndarray] = None
                ) -> Dict[str, np.ndarray]:
        """mode 1 = features (+boxes), 2 = boxes only, 3 = features for
        ``gt_boxes`` (image coordinates)."""
        return self.extract_batch(
            [img_bgr], mode=mode,
            gt_boxes_list=None if gt_boxes is None else [gt_boxes])[0]

    def extract_batch(self, images, mode: int = 1, gt_boxes_list=None,
                      lookahead: int = 1):
        """Streaming multi-image extraction: up to ``lookahead`` backbones
        queued on the device while earlier images run their host stages
        (proposal NMS, box selection). Results match per-image ``extract``
        exactly."""
        pending = deque()
        results = [None] * len(images)
        with torch.inference_mode():
            for i, img in enumerate(images):
                blob, scale, hw = transfer_blob(img, self.cfg)
                feat, logits, deltas, event = self._backbone_rpn(blob)
                gt = gt_boxes_list[i] if gt_boxes_list is not None else None
                pending.append((i, img, gt, feat, logits, deltas, event,
                                scale, hw))
                while len(pending) > lookahead:
                    j, out = self._finish(*pending.popleft(), mode=mode)
                    results[j] = out
            while pending:
                j, out = self._finish(*pending.popleft(), mode=mode)
                results[j] = out
        return results

    def _finish(self, idx, img_bgr, gt_boxes, feat, logits, deltas, event,
                scale, im_hw, mode):
        im_h, im_w = im_hw
        if mode == 3:
            if gt_boxes is None:
                raise ValueError("mode 3 needs gt bboxes")
            proposals = np.asarray(gt_boxes, np.float32) * scale
        else:
            if event is not None:
                event.synchronize()
            proposals = self._proposals(logits.numpy(), deltas.numpy(),
                                        im_h, im_w)
        dev_out = self._roi_stage(feat, proposals)
        needed = (("cls_prob", "bbox_deltas") if mode == 2
                  else ("features", "cls_prob", "attr_prob"))
        out = {k: dev_out[k].cpu().numpy() for k in needed}
        return idx, self._postprocess(img_bgr, out, proposals, scale,
                                      im_h, im_w, mode)

    def _postprocess(self, img_bgr, out, proposals, scale, im_h, im_w,
                     mode):
        cfg = self.cfg

        boxes_img = proposals / scale                         # back to image
        if mode == 2:
            # save_bbox semantics (reference extract_utils.py:114-144):
            # second-stage per-class regressed boxes, each proposal reduced
            # to its argmax-foreground-class box, per-class NMS, then the
            # top MAX_BOXES by confidence (no threshold/min)
            cls_prob = out["cls_prob"]
            R, C = cls_prob.shape
            deltas_rc = out["bbox_deltas"].reshape(R, C, 4)
            all_boxes = _decode_boxes_np(
                np.repeat(proposals, C, axis=0),
                deltas_rc.reshape(R * C, 4)).reshape(R, C, 4)
            all_boxes[..., 0::2] = all_boxes[..., 0::2].clip(0, im_w - 1)
            all_boxes[..., 1::2] = all_boxes[..., 1::2].clip(0, im_h - 1)
            top_cls = cls_prob[:, 1:].argmax(axis=1) + 1
            cls_boxes = all_boxes[np.arange(R), top_cls] / scale
            max_conf = self._max_conf(cls_prob, cls_boxes)
            keep = np.argsort(-max_conf, kind="stable")[: cfg.max_boxes]
            return {"bbox": cls_boxes[keep], "cls_prob": cls_prob[keep]}
        sel = (np.arange(len(boxes_img)) if mode == 3
               else self._select_boxes(out["cls_prob"], boxes_img))
        cls_prob = out["cls_prob"][sel]
        attr_prob = out["attr_prob"][sel]
        objects = cls_prob[:, 1:].argmax(axis=1)
        return {
            "x": out["features"][sel],
            "bbox": boxes_img[sel],
            "num_bbox": len(sel) if np.ndim(sel) else len(boxes_img),
            "image_h": img_bgr.shape[0],
            "image_w": img_bgr.shape[1],
            "info": {
                "objects_id": objects,
                "objects_conf": cls_prob[np.arange(len(objects)),
                                         objects + 1],
                "attrs_id": attr_prob[:, 1:].argmax(axis=1),
                "attrs_conf": attr_prob[np.arange(len(attr_prob)),
                                        attr_prob[:, 1:].argmax(axis=1) + 1],
                "image_h": img_bgr.shape[0],
                "image_w": img_bgr.shape[1],
            },
        }

    def _max_conf(self, cls_prob: np.ndarray, boxes: np.ndarray) -> np.ndarray:
        """Per-box max confidence surviving per-class NMS (reference
        utils/extract_utils.py:68-74). All implementations are exact-greedy
        equal to native.nms."""
        if self.nms_impl == "native_batched":
            return native.nms_max_conf(boxes, cls_prob,
                                       self.cfg.test_nms_thresh)
        if self.nms_impl == "device":
            from meme_challenge_tpu_torch.ops.nms import max_conf_device

            return max_conf_device(boxes, cls_prob,
                                   self.cfg.test_nms_thresh, self.device)
        n = cls_prob.shape[0]
        max_conf = np.zeros(n, np.float32)
        for cls_idx in range(1, cls_prob.shape[1]):
            scores = cls_prob[:, cls_idx]
            keep = native.nms(boxes, scores, self.cfg.test_nms_thresh)
            max_conf[keep] = np.maximum(max_conf[keep], scores[keep])
        return max_conf

    def _select_boxes(self, cls_prob: np.ndarray,
                      boxes: np.ndarray) -> np.ndarray:
        """save_roi_features box selection (reference utils/extract_utils.py:
        76-80): boxes with max_conf >= CONF_THRESH in ORIGINAL proposal
        order; fall back to confidence-sorted top-MIN/-MAX only when the
        threshold set is out of the [min_boxes, max_boxes] budget."""
        cfg = self.cfg
        max_conf = self._max_conf(cls_prob, boxes)
        keep = np.nonzero(max_conf >= cfg.conf_thresh)[0]
        if len(keep) < cfg.min_boxes:
            keep = np.argsort(-max_conf, kind="stable")[: cfg.min_boxes]
        elif len(keep) > cfg.max_boxes:
            keep = np.argsort(-max_conf, kind="stable")[: cfg.max_boxes]
        return keep
