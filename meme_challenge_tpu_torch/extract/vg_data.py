"""Visual Genome detection data reader for detector training.

A copy of ``meme_challenge_tpu/extract/vg_data.py`` on the port's own
``extract/detector.get_image_blob`` and ``DetectorConfig``: for the same
seed its batches are byte-identical to the JAX package's (every numpy draw
in the same place: the shuffle, the flip before the blob is made). The
replacement for the reference's detectron2 data stack
(bottom-up-attention.pytorch/dataloader/: load_vg_json.py parses COCO-format
VG annotations via pycocotools, dataset_mapper.py:42-164 reads/resizes/flips
images and builds Instances). Here:

- :func:`load_vg_json` parses the same COCO-format json with the stdlib
  (images / annotations / categories tables; XYWH_ABS boxes → XYXY;
  1-based ``category_id`` remapped to contiguous ids exactly like
  load_vg_json.py:60-85; per-instance ``attribute`` lists 1-based → 0-based
  like load_vg_json.py:155-160);
- :class:`VGDetectionLoader` yields STATIC-SHAPE training batches for
  ``make_detector_train_step`` (extract/detector_train.py): images go
  through the same Caffe blob preprocessing as extraction
  (``get_image_blob``: BGR − mean, shortest-side resize, divisibility
  padding), boxes are scaled to blob coordinates, flipped with the image
  (train-time random horizontal flip, dataset_mapper ResizeShortestEdge +
  RandomFlip), and ground truth is padded to a fixed ``max_gt`` with a
  validity mask instead of detectron2's variable-length Instances.

Documented simplification: ``gt_attrs`` carries ONE attribute id per
instance (the first annotated; −1 = none) because the ROI attribute loss
(detector_train.roi_losses) is single-label CE — the reference stores up to
16 attribute ids per instance but its BUA attribute head also trains on a
single sampled attribute.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from meme_challenge_tpu_torch.extract.detector import (
    DetectorConfig,
    get_image_blob,
)

logger = logging.getLogger("meme_challenge_tpu_torch.extract.vg_data")


def load_vg_json(json_file: str, image_root: str) -> List[dict]:
    """COCO-format VG annotations → per-image records.

    Returns dicts: {file_name, image_id, height, width,
    boxes [G, 4] float32 XYXY (image coords), classes [G] int32 (contiguous,
    0-based), attrs [G] int32 (first attribute, 0-based, −1 = none)}.
    """
    with open(json_file) as f:
        coco = json.load(f)
    cat_ids = sorted(c["id"] for c in coco.get("categories", []))
    id_map = {v: i for i, v in enumerate(cat_ids)}  # contiguous remap
    by_image: Dict[int, List[dict]] = {}
    for ann in coco.get("annotations", []):
        if ann.get("ignore", 0) or ann.get("iscrowd", 0):
            continue
        by_image.setdefault(ann["image_id"], []).append(ann)

    records = []
    for img in sorted(coco["images"], key=lambda d: d["id"]):
        anns = by_image.get(img["id"], [])
        boxes, classes, attrs = [], [], []
        for a in anns:
            x, y, w, h = a["bbox"]                  # XYWH_ABS
            if w <= 0 or h <= 0:
                continue
            boxes.append([x, y, x + w, y + h])
            if a["category_id"] not in id_map:
                # silent fallback to the raw id would emit out-of-range
                # class labels that the one-hot CE quietly trains to zeros
                raise ValueError(
                    f"annotation {a.get('id')} references category_id "
                    f"{a['category_id']} absent from the categories table")
            classes.append(id_map[a["category_id"]])
            attr = a.get("attribute") or []
            attrs.append(int(attr[0]) - 1 if attr else -1)
        records.append({
            "file_name": os.path.join(image_root, img["file_name"]),
            "image_id": img["id"],
            "height": img["height"],
            "width": img["width"],
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "classes": np.asarray(classes, np.int32),
            "attrs": np.asarray(attrs, np.int32),
        })
    logger.info("Loaded %d images from %s (%d categories)",
                len(records), json_file, len(cat_ids))
    return records


def _read_image_bgr(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path)
    assert img is not None, f"failed to read {path}"
    return img


class VGDetectionLoader:
    """Static-shape training/eval batch stream over VG records.

    Parameters
    ----------
    records : list from :func:`load_vg_json`
    cfg : DetectorConfig (blob sizing)
    max_gt : fixed ground-truth slot count (pad/truncate + mask)
    is_train : random order + random horizontal flip (dataset_mapper.py:
        build_transform_gen RandomFlip) when True
    image_reader : override for tests (record → BGR uint8 array)
    """

    def __init__(self, records: List[dict], cfg: DetectorConfig,
                 max_gt: int = 64, is_train: bool = True,
                 seed: int = 0,
                 image_reader: Optional[Callable[[dict], np.ndarray]] = None):
        self.records = records
        self.cfg = cfg
        self.max_gt = max_gt
        self.is_train = is_train
        self.rng = np.random.RandomState(seed)
        self.image_reader = image_reader or (
            lambda rec: _read_image_bgr(rec["file_name"]))

    def __len__(self) -> int:
        return len(self.records)

    def _one(self, rec: dict) -> Dict[str, np.ndarray]:
        img = self.image_reader(rec)
        boxes = rec["boxes"].copy()
        if self.is_train and self.rng.rand() < 0.5:
            # horizontal flip, detectron2 box convention
            img = img[:, ::-1]
            w = img.shape[1]
            flipped = boxes.copy()
            flipped[:, 0] = w - boxes[:, 2]
            flipped[:, 2] = w - boxes[:, 0]
            boxes = flipped
        blob, scale, _ = get_image_blob(img, self.cfg)
        boxes = boxes * scale

        G = self.max_gt
        n = min(len(boxes), G)
        if len(boxes) > G:
            logger.warning("image %s has %d gt boxes > max_gt %d; truncating",
                           rec["image_id"], len(boxes), G)
        gt_boxes = np.zeros((G, 4), np.float32)
        gt_classes = np.zeros((G,), np.int32)
        gt_attrs = np.full((G,), -1, np.int32)
        gt_mask = np.zeros((G,), bool)
        gt_boxes[:n] = boxes[:n]
        gt_classes[:n] = rec["classes"][:n]
        gt_attrs[:n] = rec["attrs"][:n]
        gt_mask[:n] = True
        return {"images": blob, "gt_boxes": gt_boxes,
                "gt_classes": gt_classes, "gt_attrs": gt_attrs,
                "gt_mask": gt_mask, "image_id": rec["image_id"]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.records))
        if self.is_train:
            self.rng.shuffle(order)
        for i in order:
            rec = self.records[i]
            if self.is_train and len(rec["boxes"]) == 0:
                continue  # filter_empty_instances (dataset_mapper.py:158)
            yield self._one(rec)
