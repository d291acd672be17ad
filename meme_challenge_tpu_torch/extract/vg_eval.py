"""Visual Genome detection evaluation (mAP@0.5 + weighted mAP).

A copy of ``meme_challenge_tpu/extract/vg_eval.py`` (numpy only). Parity:
reference bottom-up-attention.pytorch/evaluation/vg_eval.py +
vg_evaluation.py (VGEvaluator.do_python_eval) — the metric behind the
detector numbers in BASELINE.md (objects mAP@0.5 / weighted mAP@0.5):

- per-class greedy matching of score-sorted detections to unclaimed ground
  truths at IoU>0.5 with the VOC **+1** box-size convention
  (vg_eval.py:85-100);
- AP via the post-2010 precision-envelope integral (voc_ap,
  vg_eval.py:124-152);
- mAP = mean AP over classes with ground truth; weighted mAP weights each
  class AP by its ground-truth count (vg_evaluation.py:273-281).

In-memory API (no detection files): detections/ground truth as arrays.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def voc_ap(rec: np.ndarray, prec: np.ndarray,
           use_07_metric: bool = False) -> float:
    """VOC AP (11-point or precision-envelope; reference vg_eval.py:124-152)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.sum(rec >= t) > 0 else 0.0
            ap += p / 11.0
        return float(ap)
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def eval_class(
    det_image_ids: Sequence,
    det_scores: np.ndarray,
    det_boxes: np.ndarray,
    gt_boxes_by_image: Dict,
    ovthresh: float = 0.5,
    use_07_metric: bool = False,
) -> Tuple[np.ndarray, np.ndarray, float, np.ndarray, int]:
    """One class: (rec, prec, ap, sorted_scores, npos).

    ``gt_boxes_by_image``: image_id → [n, 4] gt boxes of this class.
    Matching semantics exactly as reference vg_eval.py:66-112 (incl. the
    already-claimed-gt → FP rule and the +1 IoU convention).
    """
    class_recs = {
        img: {"bbox": np.asarray(b, float),
              "det": [False] * len(b)}
        for img, b in gt_boxes_by_image.items()
    }
    npos = sum(len(b) for b in gt_boxes_by_image.values())
    if npos == 0:
        return 0, 0, 0, 0, 0
    if len(det_scores) == 0:
        return 0, 0, 0, 0, npos

    order = np.argsort(-np.asarray(det_scores))
    sorted_scores = -np.sort(-np.asarray(det_scores))
    BB = np.asarray(det_boxes, float)[order]
    image_ids = [det_image_ids[i] for i in order]

    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        if image_ids[d] not in class_recs:
            continue
        R = class_recs[image_ids[d]]
        bb = BB[d]
        BBGT = R["bbox"]
        ovmax, jmax = -np.inf, -1
        if BBGT.size > 0:
            ixmin = np.maximum(BBGT[:, 0], bb[0])
            iymin = np.maximum(BBGT[:, 1], bb[1])
            ixmax = np.minimum(BBGT[:, 2], bb[2])
            iymax = np.minimum(BBGT[:, 3], bb[3])
            iw = np.maximum(ixmax - ixmin + 1.0, 0.0)
            ih = np.maximum(iymax - iymin + 1.0, 0.0)
            inters = iw * ih
            uni = ((bb[2] - bb[0] + 1.0) * (bb[3] - bb[1] + 1.0)
                   + (BBGT[:, 2] - BBGT[:, 0] + 1.0)
                   * (BBGT[:, 3] - BBGT[:, 1] + 1.0) - inters)
            overlaps = inters / uni
            ovmax = np.max(overlaps)
            jmax = int(np.argmax(overlaps))
        if ovmax > ovthresh:
            if not R["det"][jmax]:
                tp[d] = 1.0
                R["det"][jmax] = True
            else:
                fp[d] = 1.0
        else:
            fp[d] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(npos)
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric), sorted_scores, npos


def evaluate_detections(
    predictions: List[dict],
    ground_truth: List[dict],
    num_classes: int,
    ovthresh: float = 0.5,
) -> Dict[str, float]:
    """VGEvaluator.do_python_eval equivalent.

    predictions: per image {"image_id", "boxes" [n,4], "scores" [n],
    "labels" [n]} (labels are 0-based foreground class ids, as the reference
    writes ``labels + 1`` against 1-based class indices).
    ground_truth: per image {"image_id", "boxes", "classes"} (same 0-based).
    Returns {"mAP", "weighted_mAP", "per_class_ap"}.
    """
    aps, nposs = [], []
    per_class = {}
    for cls in range(num_classes):
        det_ids, det_scores, det_boxes = [], [], []
        for item in predictions:
            mask = np.asarray(item["labels"]) == cls
            for b, s in zip(np.asarray(item["boxes"])[mask],
                            np.asarray(item["scores"])[mask]):
                det_ids.append(item["image_id"])
                det_scores.append(float(s))
                det_boxes.append(b)
        gt_by_image = {}
        for item in ground_truth:
            mask = np.asarray(item["classes"]) == cls
            gt_by_image[item["image_id"]] = np.asarray(item["boxes"])[mask]
        rec, prec, ap, _scores, npos = eval_class(
            det_ids, np.asarray(det_scores),
            np.asarray(det_boxes).reshape(-1, 4), gt_by_image,
            ovthresh=ovthresh)
        if npos == 0:
            continue  # classes without gt are skipped (reference behavior)
        aps.append(ap)
        nposs.append(float(npos))
        per_class[cls] = float(ap)

    if not aps:
        return {"mAP": 0.0, "weighted_mAP": 0.0, "per_class_ap": {}}
    weights = np.asarray(nposs) / np.sum(nposs)
    return {
        "mAP": float(np.mean(aps)),
        "weighted_mAP": float(np.sum(np.asarray(aps) * weights)),
        "per_class_ap": per_class,
    }
