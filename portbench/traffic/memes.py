"""Hateful-meme traffic made from a seed.

A rewrite of the port's ``utils/synthetic.py`` kept with the benchmark, so
that no change to the program moves the yardstick. One function,
:func:`generate`, reads a mix's parameters and writes a corpus in the
layouts the reference pipeline produces:

- ``<split>.jsonl`` with ``id``, ``img``, ``text`` and ``label``;
- ``img_feats/<id:05d>.npy`` (region features ``[n, 2048]``, non-negative)
  and ``img_feats/<id:05d>_info.npy`` (``bbox``, ``image_width``,
  ``image_height``, ``objects``, ``objects_conf``), the bottom-up-attention
  export after ``convert_feature_export``;
- ``vocab.txt``, a WordPiece vocabulary of the configuration's size.

Every word of the vocabulary is a token of its own that the BERT tokenizer
neither splits nor lower-cases, so a meme's text is known as token ids
(:attr:`Corpus.words`) and lookups spread over the whole table.

The mix's keys (see ``traffic/*.json``):

- ``memes``: how many memes the split holds;
- ``text_tokens``: ``median``, ``sigma``, ``min``, ``max`` of the BERT
  tokens a text takes with ``[CLS]`` and ``[SEP]`` (log-normal, clipped);
- ``regions``: ``min`` and ``max`` regions an image (uniform);
- ``hateful_share``: the share of memes labelled 1;
- ``confounder_share``: the share of memes in confounder pairs, two memes
  with one text and opposite labels;
- ``feature_dtype``: the dtype of the feature files.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
PAD_ID, CLS_ID, SEP_ID = 0, 2, 3
IMG_DIM = 2048
FIRST_ID = 10000


@dataclass
class Corpus:
    """What :func:`generate` wrote, with the token ids of each text."""
    root: str
    split: str            # path of the split's jsonl
    feature_dir: str
    vocab: str            # path of vocab.txt
    ids: np.ndarray       # [N] meme ids
    labels: np.ndarray    # [N]
    words: List[np.ndarray]  # each text's word ids, without [CLS] / [SEP]
    n_regions: np.ndarray  # [N]
    n_confounders: int    # memes in confounder pairs

    def index(self) -> Dict[int, int]:
        return {int(i): n for n, i in enumerate(self.ids)}


def word(i: int) -> str:
    """The vocabulary entry of id ``i`` past the specials."""
    return "w%05d" % i


def write_vocab(path: str, size: int) -> None:
    tokens = list(SPECIALS) + [word(i) for i in range(len(SPECIALS), size)]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(tokens) + "\n")


def _text_lengths(rng, p: dict, n: int) -> np.ndarray:
    raw = rng.lognormal(np.log(p["median"]), p["sigma"], n)
    return np.clip(np.rint(raw), p["min"], p["max"]).astype(np.int64)


def generate(mix: dict, seed: int, root: str, vocab_size: int,
             split: str = "memes") -> Corpus:
    """Write the corpus of ``mix`` for ``seed`` under ``root``; the same
    seed writes the same bytes."""
    rng = np.random.Generator(np.random.PCG64(int(seed)))
    n = int(mix["memes"])
    feat_dir = os.path.join(root, "img_feats")
    os.makedirs(feat_dir, exist_ok=True)
    vocab = os.path.join(root, "vocab.txt")
    write_vocab(vocab, vocab_size)

    # confounder pairs first in draw order, then shuffled into place
    n_pairs = int(round(mix["confounder_share"] * n / 2))
    lengths = _text_lengths(rng, mix["text_tokens"], n - n_pairs)
    texts = [rng.integers(len(SPECIALS), vocab_size, int(t) - 2)
             for t in lengths]
    # plain memes take the labels that bring the whole split to the share
    p_plain = (mix["hateful_share"] * n - n_pairs) / max(n - 2 * n_pairs, 1)
    plain_labels = (rng.random(n - 2 * n_pairs) < p_plain).astype(np.int64)
    words = texts[:n_pairs] * 2 + texts[n_pairs:]
    labels = np.concatenate([np.zeros(n_pairs, np.int64),
                             np.ones(n_pairs, np.int64), plain_labels])
    order = rng.permutation(n)
    words = [words[i] for i in order]
    labels = labels[order]
    ids = np.arange(FIRST_ID, FIRST_ID + n, dtype=np.int64)

    reg = mix["regions"]
    n_regions = rng.integers(reg["min"], reg["max"] + 1, n)
    dtype = np.dtype(mix.get("feature_dtype", "float16"))
    records = []
    for i in range(n):
        nbb = int(n_regions[i])
        feats = np.maximum(rng.standard_normal((nbb, IMG_DIM),
                                               dtype=np.float32), 0.0)
        w, h = int(rng.integers(300, 801)), int(rng.integers(300, 801))
        x1 = rng.uniform(0, 0.6 * w, nbb)
        y1 = rng.uniform(0, 0.6 * h, nbb)
        x2 = np.minimum(x1 + rng.uniform(10, 0.4 * w, nbb), w)
        y2 = np.minimum(y1 + rng.uniform(10, 0.4 * h, nbb), h)
        info = {"bbox": np.stack([x1, y1, x2, y2], 1).astype(np.float32),
                "image_width": w, "image_height": h,
                "objects": rng.integers(0, 1600, nbb),
                "objects_conf": rng.uniform(0.2, 1.0, nbb).astype(np.float32)}
        sid = "%05d" % ids[i]
        np.save(os.path.join(feat_dir, sid + ".npy"), feats.astype(dtype))
        np.save(os.path.join(feat_dir, sid + "_info.npy"),
                np.array(info, dtype=object))
        records.append({"id": int(ids[i]), "img": "img/%s.png" % sid,
                        "text": " ".join(word(int(t)) for t in words[i]),
                        "label": int(labels[i])})
    path = os.path.join(root, split + ".jsonl")
    with open(path, "w") as f:
        f.write("\n".join(json.dumps(r) for r in records) + "\n")
    return Corpus(root, path, feat_dir, vocab, ids, labels, words,
                  n_regions.astype(np.int64), 2 * n_pairs)


def load_region_features(corpus: Corpus, meme_id: int):
    """One meme's features ``[n, 2048]`` as stored and its 7-d box
    encoding ``(x1, y1, x2, y2, w, h, w·h)`` over the image's size, read
    back from the files."""
    sid = "%05d" % meme_id
    feats = np.load(os.path.join(corpus.feature_dir, sid + ".npy"))
    info = np.load(os.path.join(corpus.feature_dir, sid + "_info.npy"),
                   allow_pickle=True).item()
    b = np.asarray(info["bbox"], dtype=np.float64)
    x1, x2 = b[:, 0] / info["image_width"], b[:, 2] / info["image_width"]
    y1, y2 = b[:, 1] / info["image_height"], b[:, 3] / info["image_height"]
    w, h = x2 - x1, y2 - y1
    pos = np.stack([x1, y1, x2, y2, w, h, w * h], 1).astype(np.float32)
    return feats, pos
