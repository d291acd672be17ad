"""Object-text meme traffic made from a seed: a meme's text and the
detector's object words, as the object-text trainer reads them.

One function, :func:`generate`, reads a mix's parameters and writes a
corpus in the layouts ``data/object_text.py`` of the program reads:

- ``<split>.jsonl`` with ``id``, ``img``, ``text`` and ``label``;
- ``objects.npz``: ``ids``, ``objects`` ``[N, max regions]`` (a class id a
  region, padded) and ``probs`` (each region's confidence, uniform over
  0-1; padding 0, below any threshold);
- ``object_classes.json``: class id → its word;
- ``vocab.txt``, a WordPiece vocabulary of the configuration's size in
  which every word is one token, with the separator's and the joiner's
  pieces (``<``, ``/``, ``s``, ``>``, ``,``) as tokens of their own.

The mix's keys (see ``traffic/objtext_*.json``): ``memes``;
``text_tokens`` (``median``, ``sigma``, ``min``, ``max`` of the tokens a
text takes with ``[CLS]`` and ``[SEP]``, log-normal, clipped); ``regions``
(``min``, ``max`` regions an image, uniform); ``object_classes``;
``hateful_share``; and ``objects`` (``threshold_min``, ``threshold_max``,
``swap_prob``), which the driver hands to the dataset.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass

import numpy as np

SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "<", "/", "s",
            ">", ",")
FIRST_ID = 10000
CLASS_STRIDE = 97   # class c's word is vocabulary id len(SPECIALS) + 97·c


@dataclass
class Corpus:
    root: str
    split: str           # path of the split's jsonl
    objects: str         # path of objects.npz
    classes: str         # path of object_classes.json
    vocab: str           # path of vocab.txt
    ids: np.ndarray      # [N] meme ids
    labels: np.ndarray   # [N]


def word(i: int) -> str:
    return "w%06d" % i


def generate(mix: dict, seed: int, root: str, vocab_size: int,
             split: str = "memes") -> Corpus:
    """Write the corpus of ``mix`` for ``seed`` under ``root``; the same
    seed writes the same bytes."""
    rng = np.random.Generator(np.random.PCG64(int(seed)))
    n = int(mix["memes"])
    first = len(SPECIALS)
    vocab = os.path.join(root, "vocab.txt")
    with open(vocab, "w", encoding="utf-8") as f:
        f.write("\n".join(list(SPECIALS) + [word(i) for i in
                                             range(first, vocab_size)]) + "\n")
    n_classes = int(mix["object_classes"])
    if first + CLASS_STRIDE * (n_classes - 1) >= vocab_size:
        raise ValueError("%d object classes do not fit a vocabulary of %d"
                         % (n_classes, vocab_size))
    classes = os.path.join(root, "object_classes.json")
    with open(classes, "w") as f:
        json.dump({str(c): word(first + CLASS_STRIDE * c)
                   for c in range(n_classes)}, f)

    p = mix["text_tokens"]
    lengths = np.clip(np.rint(rng.lognormal(np.log(p["median"]), p["sigma"],
                                            n)), p["min"], p["max"]).astype(
                                                np.int64)
    labels = (rng.random(n) < mix["hateful_share"]).astype(np.int64)
    ids = np.arange(FIRST_ID, FIRST_ID + n, dtype=np.int64)
    reg = mix["regions"]
    n_regions = rng.integers(reg["min"], reg["max"] + 1, n)
    objects = np.zeros((n, reg["max"]), np.int64)
    probs = np.zeros((n, reg["max"]), np.float32)
    records = []
    for i in range(n):
        text = rng.integers(first, vocab_size, int(lengths[i]) - 2)
        r = int(n_regions[i])
        objects[i, :r] = rng.integers(0, n_classes, r)
        probs[i, :r] = rng.random(r, dtype=np.float32)
        records.append({"id": int(ids[i]), "img": "img/%05d.png" % ids[i],
                        "text": " ".join(word(int(t)) for t in text),
                        "label": int(labels[i])})
    path = os.path.join(root, split + ".jsonl")
    with open(path, "w") as f:
        f.write("\n".join(json.dumps(r) for r in records) + "\n")
    obj_path = os.path.join(root, "objects.npz")
    np.savez(obj_path, ids=ids, objects=objects, probs=probs)
    return Corpus(root, path, obj_path, classes, vocab, ids, labels)
