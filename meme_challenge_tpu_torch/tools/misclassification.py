"""Misclassification analysis tool.

A copy of ``meme_challenge_tpu/tools/misclassification.py``.

Parity: reference utils/misclassification.py — from a results CSV
(``id,proba,label,gt``), print misclassified ids and optionally copy their
images into ``save_dir/{hateful,not_hateful}``.
"""
from __future__ import annotations

import argparse
import os
import shutil
from typing import List

import numpy as np

from meme_challenge_tpu_torch.core.artifacts import load_predictions


def misclassified_ids(results: dict) -> np.ndarray:
    return results["id"][results["label"] != results["gt"]]


def copy_misclassified_imgs(results: dict, img_dir: str,
                            save_dir: str) -> List[str]:
    """Copy misclassified images into hateful/not_hateful subfolders
    (reference misclassification.py:13-22)."""
    copied = []
    wrong = results["label"] != results["gt"]
    for i in np.where(wrong)[0]:
        img_name = str(int(results["id"][i])).zfill(5)
        img_file = os.path.join(img_dir, img_name + ".png")
        assert os.path.isfile(img_file), (
            "image file missing: {}".format(img_file))
        label = "hateful" if results["gt"][i] == 1 else "not_hateful"
        dest = os.path.join(save_dir, label, img_name + ".png")
        shutil.copy(img_file, dest)
        copied.append(dest)
    return copied


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--results_file", type=str, required=True,
                        help="prediction CSV to analyze")
    parser.add_argument("--img_dir", type=str,
                        help="source image directory")
    parser.add_argument("--save_dir", type=str,
                        help="output directory for the misclassified copies")
    args = parser.parse_args(argv)

    results = load_predictions(args.results_file)
    assert "gt" in results, "results CSV needs a gt column"
    ids = misclassified_ids(results)
    print("The following %i image IDs are misclassified:" % len(ids))
    print(ids)

    if args.save_dir is not None:
        assert args.img_dir, "an image directory is required to copy images"
        assert os.path.isdir(args.img_dir), "image directory not found"
        os.makedirs(os.path.join(args.save_dir, "hateful"), exist_ok=True)
        os.makedirs(os.path.join(args.save_dir, "not_hateful"), exist_ok=True)
        copy_misclassified_imgs(results, args.img_dir, args.save_dir)


if __name__ == "__main__":
    main()
