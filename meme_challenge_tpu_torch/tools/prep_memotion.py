"""Memotion auxiliary-dataset preparation.

A copy of ``meme_challenge_tpu/tools/prep_memotion.py``.

Parity: reference utils/prep_memotion.py — converts the Memotion
``labels.csv`` into ``all.jsonl`` with ids offset by 1e5 (past the meme
dataset's id range), URL scrubbing on the corrected text, and renames the
extracted feature files with the same offset.
"""
from __future__ import annotations

import argparse
import csv
import logging
import os
import re

import numpy as np

from meme_challenge_tpu_torch.core.artifacts import export_jsonl

logger = logging.getLogger("meme_challenge_tpu_torch.prep_memotion")

OFFSET_IDX = 1e5  # start past the meme dataset's max id


def scrub_text(text: str) -> str:
    """URL scrubbing parity (reference prep_memotion.py:38-44)."""
    text = text.replace("\n", " ")
    text = re.sub(
        r"\b(?:https?://|www\.)[a-z0-9-]+(\.[a-z0-9-]+)+(?:[/?].*)?", "",
        text)
    text = re.sub(r"(w{3}\.)*[a-zA-Z0-9]+\.{1}(co){1}[m]{0,1}\s{0,1}", "",
                  text)
    text = re.sub(r"(w{3}\.)*[a-zA-Z0-9]+\.{1}(net){1}\s{0,1}", "", text)
    return text


def generate_jsonl_file(data_path: str) -> str:
    """labels.csv → all.jsonl (reference prep_memotion.py:21-49).

    Samples without extracted features are skipped; every Memotion sample is
    labeled 0 (used only as extra not-hateful pretraining text+image pairs).
    """
    data_list = []
    read_path = os.path.join(data_path, "labels.csv")
    img_feat_dir = os.path.join(data_path, "img_feats")
    with open(read_path, "r", encoding="utf8") as f:
        for row in csv.DictReader(f):
            sample_id = int(row[""]) + 1 + int(OFFSET_IDX)
            feat = os.path.join(img_feat_dir, f"{sample_id}.npy")
            feat_info = os.path.join(img_feat_dir, f"{sample_id}_info.npy")
            if not (os.path.isfile(feat) and os.path.isfile(feat_info)):
                continue
            data_list.append({
                "id": str(sample_id),
                "img": "images\\/" + row["image_name"].replace("image_", ""),
                "label": 0,
                "text": scrub_text(row["text_corrected"]),
            })
    logger.info("Total data points = %i", len(data_list))
    out = os.path.join(data_path, "all.jsonl")
    export_jsonl(out, data_list)
    return out


def rename_img_feats(feat_dir: str) -> int:
    """Offset feature filenames by OFFSET_IDX (reference :59-69)."""
    count = 0
    for root, _dirs, files in os.walk(feat_dir):
        for fname in files:
            match = re.findall(r"\d+", fname)
            if not match:
                continue
            sample_id = int(match[0]) + int(OFFSET_IDX)
            suffix = "_info.npy" if "info" in fname else ".npy"
            contents = np.load(os.path.join(root, fname), allow_pickle=True)
            np.save(os.path.join(root, f"{sample_id}{suffix}"), contents,
                    allow_pickle=True)
            count += 1
    return count


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--data_path", type=str,
                        default="./dataset/memotion_dataset")
    args, _ = parser.parse_known_args(argv)
    assert os.path.exists(args.data_path), (
        "memotion data path does not exist")
    generate_jsonl_file(args.data_path)
    rename_img_feats(os.path.join(args.data_path, "img_feats"))


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
