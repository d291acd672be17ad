"""The detector cells' traffic: Visual Genome-style images and boxes, written
from the seed.

:func:`generate` writes, under ``out_dir``, ``images`` JPEG files of the
mix's ``width × height`` and one COCO-format annotation file in the layout
the program's ``extract/vg_data.load_vg_json`` reads (images,
annotations with XYWH boxes, a ``category_id`` from 1 and an optional
``attribute`` list from 1, categories). Every draw comes from
``numpy.random.default_rng(seed)``: the same seed writes the same files.

- An image is smooth random texture: normal noise at three coarse grids,
  upsampled bicubically and summed, plus a fine grain tiled from a small
  block, so that its JPEG (quality ``jpeg_quality``) decodes at the cost of
  a photograph's, not of a flat image's.
- Ground-truth boxes an image: log-normal (``median``, ``sigma``), rounded
  and clipped to ``[min, max]``. A box's sides: each log-uniform over
  ``box_side`` (clipped to the image), its corner uniform inside the image.
- Classes: Zipf-ranked with exponent ``zipf_s`` over ``classes``; a share
  ``attribute_share`` of the instances carry one attribute, Zipf-ranked
  over ``attributes``.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

# (cells across the short side, amplitude) of each octave of the texture
OCTAVES = ((6, 90.0), (24, 45.0), (96, 20.0))
GRAIN = 6.0
# the block the grain is tiled from (sides prime to JPEG's 8 × 8 blocks)
GRAIN_BLOCK = (61, 67)


@dataclass
class Corpus:
    json_file: str
    image_root: str


def zipf(n: int, s: float) -> np.ndarray:
    """Probabilities of ranks 1 .. n, proportional to rank^−s."""
    p = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** s
    return p / p.sum()


def texture(rng, height: int, width: int) -> np.ndarray:
    """A [height, width, 3] uint8 image of smooth random texture: the
    octaves summed on the finest octave's grid, that sum resized once to
    the image, and a grain tiled from one small block of normal noise."""
    import cv2

    def grid(cells):
        return cells, max(1, int(round(cells * width / height)))

    gh, gw = grid(OCTAVES[-1][0])
    low = np.full((gh, gw, 3), 128.0, np.float32)
    for cells, amp in OCTAVES:
        ch, cw = grid(cells)
        coarse = rng.standard_normal((ch, cw, 3), dtype=np.float32)
        if (ch, cw) != (gh, gw):
            coarse = cv2.resize(coarse, (gw, gh),
                                interpolation=cv2.INTER_CUBIC)
        low += amp * coarse
    img = cv2.resize(np.clip(low, 0, 255).astype(np.uint8), (width, height),
                     interpolation=cv2.INTER_CUBIC)
    th, tw = GRAIN_BLOCK
    grain = np.rint(GRAIN * rng.standard_normal((th, tw, 3),
                                                dtype=np.float32))
    grain = np.tile(grain.astype(np.int16),
                    (-(-height // th), -(-width // tw), 1))
    return cv2.add(img, np.ascontiguousarray(grain[:height, :width]),
                   dtype=cv2.CV_8U)


def boxes(rng, mix: dict, height: int, width: int) -> np.ndarray:
    """[n, 4] XYWH boxes of one image."""
    g, side = mix["gt_boxes"], mix["box_side"]
    n = int(np.clip(np.rint(np.exp(rng.normal(np.log(g["median"]),
                                              g["sigma"]))),
                    g["min"], g["max"]))
    lo = np.log(side["min"])
    w = np.exp(rng.uniform(lo, np.log(min(side["max"], width)), n))
    h = np.exp(rng.uniform(lo, np.log(min(side["max"], height)), n))
    x = rng.uniform(0.0, width - w)
    y = rng.uniform(0.0, height - h)
    return np.round(np.stack([x, y, w, h], axis=1), 2)


def generate(mix: dict, seed: int, out_dir: str) -> Corpus:
    import cv2

    rng = np.random.default_rng(int(seed))
    W, H = mix["image_size"]["width"], mix["image_size"]["height"]
    image_root = os.path.join(out_dir, "images")
    os.makedirs(image_root, exist_ok=True)
    p_cls = zipf(mix["classes"], mix["zipf_s"])
    p_attr = zipf(mix["attributes"], mix["zipf_s"])
    images, annotations = [], []
    for i in range(mix["images"]):
        name = "%06d.jpg" % (i + 1)
        ok, data = cv2.imencode(".jpg", texture(rng, H, W),
                                [cv2.IMWRITE_JPEG_QUALITY,
                                 mix["jpeg_quality"]])
        if not ok:
            raise RuntimeError("JPEG encoding failed")
        with open(os.path.join(image_root, name), "wb") as f:
            f.write(data.tobytes())
        images.append({"id": i + 1, "file_name": name, "height": H,
                       "width": W})
        bb = boxes(rng, mix, H, W)
        cls = rng.choice(mix["classes"], size=len(bb), p=p_cls) + 1
        has = rng.random(len(bb)) < mix["attribute_share"]
        attr = rng.choice(mix["attributes"], size=len(bb), p=p_attr) + 1
        for b, c, h_, a in zip(bb, cls, has, attr):
            ann = {"id": len(annotations) + 1, "image_id": i + 1,
                   "bbox": [float(v) for v in b], "category_id": int(c)}
            if h_:
                ann["attribute"] = [int(a)]
            annotations.append(ann)
    coco = {"images": images, "annotations": annotations,
            "categories": [{"id": k + 1, "name": "class%d" % (k + 1)}
                           for k in range(mix["classes"])]}
    json_file = os.path.join(out_dir, "vg_train.json")
    with open(json_file, "w") as f:
        json.dump(coco, f)
    return Corpus(json_file, image_root)
