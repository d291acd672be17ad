"""Feature-file converter: extractor ``.npz`` → MMF-style ``.npy`` pairs.

A copy of ``meme_challenge_tpu/tools/convert_feature_export.py``.

Parity: reference data/convert_feature_export.py:8-17 — each npz (keys
``x``/``bbox``/``info``) becomes ``{id}.npy`` (features) and
``{id}_info.npy`` (dict with bbox, image_width/height, objects,
objects_conf), the layout MemeDataset consumes.
"""
from __future__ import annotations

import argparse
import os
from glob import glob

import numpy as np


def parse_numpy_file(input_file: str, output_dir: str) -> str:
    arr = np.load(input_file, allow_pickle=True)
    info = arr["info"].item()
    info["image_height"] = info["image_h"]
    info["image_width"] = info["image_w"]
    info["bbox"] = arr["bbox"]
    info["objects"] = info["objects_id"]
    base = os.path.join(output_dir,
                        input_file.split("/")[-1].rsplit(".", 1)[0])
    np.save(base + "_info.npy", info)
    np.save(base + ".npy", arr["x"])
    return base


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--input_dir", type=str, required=True,
                        help="Directory of FasterRCNN-extracted .npz files")
    parser.add_argument("--output_dir", type=str, required=True)
    args = parser.parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    for f in sorted(glob(os.path.join(args.input_dir, "*.npz"))):
        parse_numpy_file(f, args.output_dir)


if __name__ == "__main__":
    main()
