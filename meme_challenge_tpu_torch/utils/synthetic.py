"""Synthetic dataset fixtures: tiny jsonl + .npy feature pairs + vocab.

A copy of ``meme_challenge_tpu/utils/synthetic.py``.

Stands in for the Hateful Memes data (which cannot be redistributed) in
tests, verification drives, and benchmarks. The on-disk layout matches what
the reference's feature-extraction pipeline produces after
data/convert_feature_export.py:8-17: ``{id:05d}.npy`` (features [nbb, 2048])
and ``{id:05d}_info.npy`` (dict with bbox/image_width/image_height/objects/
objects_conf).
"""
from __future__ import annotations

import json
import os
from typing import List, Optional

import numpy as np

from meme_challenge_tpu_torch.core.constants import IMG_DIM
from meme_challenge_tpu_torch.data.tokenizer import BERT_SPECIAL_TOKENS, write_vocab

_WORDS = [
    "the", "a", "meme", "cat", "dog", "hat", "love", "hate", "funny", "wow",
    "person", "smile", "day", "good", "bad", "really", "trust", "me", "you",
    "look", "at", "this", "pure", "chaos", "energy", "vibes", "monday",
]


def make_vocab(path: str) -> str:
    """Write a small WordPiece vocab covering the synthetic corpus."""
    tokens = list(BERT_SPECIAL_TOKENS) + _WORDS + [
        "##s", "##ing", "##ed", "!", "?", ".", ","]
    write_vocab(path, tokens)
    return path


def make_synthetic_dataset(
    root: str,
    n_train: int = 40,
    n_dev: int = 16,
    n_test: int = 12,
    img_dim: int = IMG_DIM,
    max_boxes: int = 12,
    seed: int = 0,
    n_confounder_pairs: int = 4,
    label_signal: float = 2.0,
) -> dict:
    """Create train/dev_seen/test_seen/{unseen} jsonl + features under root.

    The label is (weakly) decodable from the mean region feature so tiny
    models can overfit — useful for end-to-end training smoke tests.
    Returns paths dict.
    """
    rng = np.random.RandomState(seed)
    feat_dir = os.path.join(root, "img_feats")
    os.makedirs(feat_dir, exist_ok=True)

    next_id = [10000]

    def sample_text(label: int, confounder_text: Optional[str]) -> str:
        if confounder_text is not None:
            return confounder_text
        k = rng.randint(3, 8)
        words = [_WORDS[i] for i in rng.randint(0, len(_WORDS), k)]
        return " ".join(words)

    def write_sample(label: int, confounder_text: Optional[str] = None) -> dict:
        sid = next_id[0]
        next_id[0] += 1
        nbb = int(rng.randint(3, max_boxes + 1))
        feats = rng.randn(nbb, img_dim).astype(np.float32)
        if label >= 0:
            feats += label_signal * (2 * label - 1) / np.sqrt(img_dim)
        W, H = int(rng.randint(300, 800)), int(rng.randint(300, 800))
        x1 = rng.uniform(0, W * 0.6, nbb)
        y1 = rng.uniform(0, H * 0.6, nbb)
        bw = rng.uniform(10, W * 0.4, nbb)
        bh = rng.uniform(10, H * 0.4, nbb)
        bbox = np.stack([x1, y1, np.minimum(x1 + bw, W),
                         np.minimum(y1 + bh, H)], axis=1)
        info = {
            "bbox": bbox.astype(np.float32),
            "image_width": W,
            "image_height": H,
            "objects": rng.randint(0, 1600, nbb),
            "objects_conf": rng.uniform(0.1, 1.0, nbb).astype(np.float32),
        }
        sid5 = str(sid).zfill(5)
        np.save(os.path.join(feat_dir, f"{sid5}.npy"), feats)
        np.save(os.path.join(feat_dir, f"{sid5}_info.npy"),
                np.array(info, dtype=object))
        rec = {"id": sid, "img": f"img/{sid5}.png",
               "text": sample_text(label, confounder_text)}
        if label >= 0:
            rec["label"] = int(label)
        return rec

    def make_split(n: int, labeled: bool, with_confounders: bool = False):
        recs: List[dict] = []
        if with_confounders:
            for _ in range(n_confounder_pairs):
                text = sample_text(0, None) + " !"
                recs.append(write_sample(0, text))
                recs.append(write_sample(1, text))
        while len(recs) < n:
            label = int(rng.randint(0, 2)) if labeled else -1
            recs.append(write_sample(label))
        return recs[:n] if not with_confounders else recs

    splits = {
        "train": make_split(n_train, labeled=True, with_confounders=True),
        "dev_seen": make_split(n_dev, labeled=True),
        "dev_unseen": make_split(n_dev, labeled=True),
        "test_seen": make_split(n_test, labeled=False),
        "test_unseen": make_split(n_test, labeled=False),
    }
    paths = {"root": root, "feature_dir": feat_dir}
    for name, recs in splits.items():
        path = os.path.join(root, f"{name}.jsonl")
        with open(path, "w") as f:
            f.write("\n".join(json.dumps(r) for r in recs))
        paths[name] = path
    paths["vocab"] = make_vocab(os.path.join(root, "vocab.txt"))
    return paths
