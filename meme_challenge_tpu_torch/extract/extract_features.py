"""Feature-extraction CLI.

The port of ``meme_challenge_tpu/extract/extract_features.py``. Parity:
reference bottom-up-attention.pytorch/extract_features.py:41-130 — walk an
image directory, run the detector, write one npz per image (``{stem}.npz``
with x/bbox/num_bbox/image_h/image_w/info), skipping images whose output
already exists (resumability, extract_features.py:92-93). Modes:
1 = features, 2 = bbox-only, 3 = features from gt bboxes loaded from
``--bbox-dir`` npz files (the two-stage recipe, subrepo README.md:10-21).

    python -m meme_challenge_tpu_torch.extract.extract_features \\
        --image-dir imgs --out-dir feats [--weights bua.pth] [--mode 1|2|3] \\
        [--bbox-dir boxes] [--device cuda|cpu]

Afterwards ``python -m meme_challenge_tpu_torch.tools.convert_feature_export``
turns the npz files into the ``{id}.npy`` + ``{id}_info.npy`` pairs
``MemeDataset`` reads.
"""
from __future__ import annotations

import argparse
import logging
import os
import time
from glob import glob

import numpy as np

from meme_challenge_tpu_torch.core.device import resolve_device
from meme_challenge_tpu_torch.extract.convert_detector import (
    load_detector_weights,
)
from meme_challenge_tpu_torch.extract.detector import (
    DetectorConfig,
    FeatureExtractor,
)

logger = logging.getLogger("meme_challenge_tpu_torch.extract_features")


def load_image_bgr(path: str) -> np.ndarray:
    from PIL import Image

    with open(path, "rb") as f:
        img = Image.open(f).convert("RGB")
    return np.asarray(img)[:, :, ::-1].copy()  # RGB → BGR (Caffe order)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--image-dir", required=True)
    parser.add_argument("--out-dir", required=True)
    parser.add_argument("--weights", default="",
                        help="torch .pth checkpoint (Caffe-converted)")
    parser.add_argument("--mode", type=int, default=1,
                        help="1=feats, 2=bbox only, 3=feats from gt bbox")
    parser.add_argument("--bbox-dir", default="",
                        help="npz dir with precomputed bboxes (mode 3)")
    parser.add_argument("--depth", type=int, default=101)
    parser.add_argument("--min-boxes", type=int, default=10)
    parser.add_argument("--max-boxes", type=int, default=100)
    parser.add_argument("--conf-thresh", type=float, default=0.2)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    cfg = DetectorConfig(depth=args.depth, min_boxes=args.min_boxes,
                         max_boxes=args.max_boxes,
                         conf_thresh=args.conf_thresh)
    if not args.weights:
        logger.warning("No --weights given: using random-init detector "
                       "(features will be meaningless; OK for smoke tests).")
    extractor = FeatureExtractor(cfg, load_detector_weights(args.weights, cfg),
                                 device=device)
    os.makedirs(args.out_dir, exist_ok=True)

    images = sorted(
        p for ext in ("*.png", "*.jpg", "*.jpeg")
        for p in glob(os.path.join(args.image_dir, ext)))
    logger.info("Extracting %i images...", len(images))
    t0 = time.time()
    done = 0
    for path in images:
        stem = os.path.splitext(os.path.basename(path))[0]
        out_path = os.path.join(args.out_dir, stem + ".npz")
        if os.path.isfile(out_path):   # resumable skip
            continue
        img = load_image_bgr(path)
        gt = None
        if args.mode == 3:
            bbox_file = os.path.join(args.bbox_dir, stem + ".npz")
            gt = np.load(bbox_file, allow_pickle=True)["bbox"]
        out = extractor.extract(img, mode=args.mode, gt_boxes=gt)
        if args.mode == 2:
            np.savez_compressed(out_path, bbox=out["bbox"],
                                cls_prob=out["cls_prob"])
        else:
            np.savez_compressed(
                out_path, x=out["x"], bbox=out["bbox"],
                num_bbox=out["num_bbox"], image_h=out["image_h"],
                image_w=out["image_w"],
                info=np.array(out["info"], dtype=object))
        done += 1
        if done % 50 == 0:
            logger.info("%i images, %.2f s/img", done,
                        (time.time() - t0) / done)
    logger.info("Finished %i images in %.1fs", done, time.time() - t0)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
