"""Detection box-overlay visualizer (headless).

The port of ``meme_challenge_tpu/tools/visualize_boxes.py``. Capability
parity with the reference's notebook-style
bottom-up-attention.pytorch/utils/visualize.py: run the detector on images,
select boxes by per-class NMS max-confidence (CONF_THRESH 0.4, 10–20 boxes —
visualize.py:78-80,107-119), and write ``*_annotated.*`` copies with red box
rectangles and class(+attribute) labels (visualize.py:131-154).

The detector is the port's FeatureExtractor (mode 1 already performs the
per-class-NMS selection), and drawing is PIL — no matplotlib/display
needed, output is always a file.

    python -m meme_challenge_tpu_torch.tools.visualize_boxes \\
        --image-dir imgs --weights bua.pth [--out-dir out] \\
        [--classes bbox_classes.json] [--device cuda|cpu]
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

ATTR_THRESH = 0.1  # reference visualize.py:128


def load_class_names(path: str) -> Dict[int, str]:
    """``bbox_classes.json``-style {0-based fg id: word} map (reference
    config/bbox_classes.json)."""
    with open(path) as f:
        raw = json.load(f)
    return {int(k): v for k, v in raw.items()}


def draw_boxes(img_rgb: np.ndarray, boxes: np.ndarray,
               labels: Sequence[str]):
    """Overlay red rectangles + blue label tags; returns a PIL image."""
    from PIL import Image, ImageDraw

    im = Image.fromarray(np.ascontiguousarray(img_rgb.astype(np.uint8)))
    draw = ImageDraw.Draw(im, "RGBA")
    for bbox, label in zip(np.asarray(boxes), labels):
        x1, y1, x2, y2 = [float(v) for v in bbox[:4]]
        # the reference nudges boxes off the exact image border
        # (visualize.py:133-136)
        x1, y1 = max(x1, 1.0), max(y1, 1.0)
        draw.rectangle([x1, y1, x2, y2], outline=(255, 0, 0, 128), width=2)
        if label:
            tw = draw.textlength(label) if hasattr(draw, "textlength") \
                else 6 * len(label)
            ty = max(y1 - 12, 0)
            draw.rectangle([x1, ty, x1 + tw + 4, ty + 12],
                           fill=(0, 0, 255, 128))
            draw.text((x1 + 2, ty), label, fill=(255, 255, 255, 255))
    return im


def box_labels(info: dict, classes: Optional[Dict[int, str]] = None,
               attributes: Optional[Dict[int, str]] = None,
               attr_thresh: float = ATTR_THRESH) -> List[str]:
    """Class(+attribute) tag per box from an extractor ``info`` dict
    (reference visualize.py:126-139: attribute prefixed when its confidence
    clears 0.1)."""
    labels = []
    objs = np.asarray(info["objects_id"])
    attrs = np.asarray(info.get("attrs_id", np.full_like(objs, -1)))
    attr_conf = np.asarray(info.get("attrs_conf", np.zeros(len(objs))))
    for i in range(len(objs)):
        name = (classes or {}).get(int(objs[i]), f"cls{int(objs[i])}")
        if attr_conf[i] > attr_thresh and int(attrs[i]) >= 0:
            aname = (attributes or {}).get(int(attrs[i]),
                                           f"attr{int(attrs[i])}")
            name = f"{aname} {name}"
        labels.append(name)
    return labels


def annotate_image(extractor, img_bgr: np.ndarray,
                   classes: Optional[Dict[int, str]] = None,
                   attributes: Optional[Dict[int, str]] = None):
    """Detector mode 1 → selected boxes → PIL overlay (RGB)."""
    out = extractor.extract(img_bgr, mode=1)
    labels = box_labels(out["info"], classes, attributes)
    img_rgb = img_bgr[..., ::-1]  # reference converts BGR→RGB for display
    return draw_boxes(img_rgb, out["bbox"], labels), out


def annotated_path(im_file: str, out_dir: Optional[str] = None) -> str:
    """``foo.png`` → ``foo_annotated.png`` (reference visualize.py:153)."""
    stem, ext = im_file.rsplit(".", 1)
    path = f"{stem}_annotated.{ext}"
    if out_dir:
        path = os.path.join(out_dir, os.path.basename(path))
    return path


def main(argv=None):
    import argparse
    from glob import glob

    parser = argparse.ArgumentParser(
        description="Overlay detected boxes on images (headless)")
    parser.add_argument("--image-dir", required=True,
                        help="directory of images (png/jpg)")
    parser.add_argument("--out-dir", default=None,
                        help="output directory (default: next to inputs)")
    parser.add_argument("--weights", required=True,
                        help="detector weights (.pth torch or .msgpack)")
    parser.add_argument("--classes", default=None,
                        help="bbox_classes.json path (id→word)")
    parser.add_argument("--conf-thresh", type=float, default=0.4)
    parser.add_argument("--min-boxes", type=int, default=10)
    parser.add_argument("--max-boxes", type=int, default=20)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from meme_challenge_tpu_torch.core.device import resolve_device

    device = resolve_device(args.device)

    import cv2

    from meme_challenge_tpu_torch.extract.convert_detector import (
        load_detector_weights)
    from meme_challenge_tpu_torch.extract.detector import (
        DetectorConfig, FeatureExtractor)

    # reference visualize.py:78-80 selection budget
    cfg = dataclasses.replace(DetectorConfig(),
                              conf_thresh=args.conf_thresh,
                              min_boxes=args.min_boxes,
                              max_boxes=args.max_boxes)
    ex = FeatureExtractor(cfg, load_detector_weights(args.weights, cfg),
                          device=device)
    classes = load_class_names(args.classes) if args.classes else None
    if args.out_dir:
        os.makedirs(args.out_dir, exist_ok=True)

    files = sorted(f for pat in ("*.png", "*.jpg", "*.jpeg")
                   for f in glob(os.path.join(args.image_dir, pat)))
    for im_file in files:
        img = cv2.imread(im_file)
        if img is None:
            continue
        im, out = annotate_image(ex, img, classes)
        dest = annotated_path(im_file, args.out_dir)
        im.save(dest)
        print(f"{dest}: boxes={out['num_bbox']}")


if __name__ == "__main__":
    main()
