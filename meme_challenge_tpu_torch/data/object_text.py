"""Object-text dataset: meme text ⊕ detected-object words.

A copy of ``meme_challenge_tpu/data/object_text.py`` (plain python and
numpy), kept so that the port imports nothing of the JAX package.

Parity: reference data/object_text_dataset.py — meme text joined with
"<sep> obj1, obj2, …" built from detector classes; train-time augmentation:
a confidence threshold drawn uniformly from a (min, max) range per sample
(object_text_dataset.py:109-115) and random adjacent swaps of object words
with probability ``swap_prob`` (:120-127). Object-id → word mapping loaded
from a ``bbox_classes.json``-style dict.

Because the augmentations are *per-epoch random*, tokenization can't be
fully precomputed: texts are re-assembled per batch host-side and tokenized
then (numpy RNG, reference seed discipline).
"""
from __future__ import annotations

import json
import os
from typing import Dict, Sequence, Tuple, Union

import numpy as np


class ObjectTextDataset:
    """BatchLoader-compatible; tokenizes per batch (augmentations are live)."""

    def __init__(
        self,
        meme_filepath: str,
        object_filepath: str,
        object_to_text_filepath: str,
        tokenizer=None,
        max_txt_len: int = 128,
        confidence_threshold: Union[float, Tuple[float, float]] = 0.5,
        swap_prob: float = 0.0,
        sep_token: str = "</s>",
        join_token: str = ", ",
        return_ids: bool = False,
    ):
        assert os.path.isfile(meme_filepath), (
            'No meme jsonl at "%s".' % meme_filepath)
        assert os.path.isfile(object_filepath), (
            'No object annotation file at "%s".' % object_filepath)
        assert os.path.isfile(object_to_text_filepath), (
            'No object-to-text mapping at "%s".'
            % object_to_text_filepath)
        assert meme_filepath.endswith(".jsonl")
        assert object_filepath.endswith(".npz")
        assert object_to_text_filepath.endswith(".json")
        self.name = meme_filepath.split("/")[-1].split(".")[0]
        self.return_ids = return_ids
        self.tokenizer = tokenizer
        self.max_txt_len = max_txt_len
        self.swap_prob = swap_prob
        self.sep_token = sep_token
        self.join_token = join_token
        if (isinstance(confidence_threshold, tuple)
                and confidence_threshold[0] == confidence_threshold[1]):
            confidence_threshold = confidence_threshold[0]
        self.confidence_threshold = confidence_threshold

        with open(meme_filepath, "r") as f:
            records = [json.loads(l) for l in f if l.strip()]
        self.ids = np.array([int(r["id"]) for r in records], dtype=np.int64)
        self.labels = np.array([r.get("label", -1) for r in records],
                               dtype=np.int64)
        self.texts = [r["text"] for r in records]
        assert self.ids.shape[0] == self.labels.shape[0] == len(self.texts)

        arr = np.load(object_filepath)
        arr_ids, arr_objects, arr_probs = (
            arr["ids"], arr["objects"], arr["probs"])
        arr_idx = np.zeros(self.ids.shape[0], dtype=np.int32)
        for i, data_id in enumerate(self.ids):
            idx_list = np.where(arr_ids == data_id)[0]
            assert len(idx_list) > 0, (
                "Object annotations missing for id %i." % data_id)
            arr_idx[i] = idx_list[0]
        self.objects = arr_objects[arr_idx]
        self.object_probs = arr_probs[arr_idx]

        with open(object_to_text_filepath, "r") as f:
            obj2text = json.load(f)
        self.object2text = {int(k): v for k, v in obj2text.items()}

    def __len__(self) -> int:
        return len(self.ids)

    def _create_object_text(self, idx: int) -> str:
        """Reference object_text_dataset.py:105-133."""
        if isinstance(self.confidence_threshold, tuple):
            thresh = np.random.uniform(low=self.confidence_threshold[0],
                                       high=self.confidence_threshold[1])
        else:
            thresh = self.confidence_threshold
        objs = self.objects[idx, np.where(self.object_probs[idx] > thresh)[0]]
        words = [self.object2text[int(o)] for o in objs]
        if self.swap_prob > 0.0 and len(words) > 1:
            order = np.random.permutation(len(words) - 1)
            for pos in order:
                if np.random.uniform() < self.swap_prob:
                    words[pos], words[pos + 1] = words[pos + 1], words[pos]
        return self.join_token.join(words)

    def sample_text(self, idx: int) -> str:
        return (self.texts[idx] + " %s " % self.sep_token
                + self._create_object_text(idx))

    def batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        idx = np.asarray(indices)
        texts = [self.sample_text(int(i)) for i in idx]
        enc = self.tokenizer(texts, max_length=self.max_txt_len)
        n, T = len(texts), self.max_txt_len
        return {
            "input_ids": np.asarray(enc["input_ids"], np.int32),
            "position_ids": np.tile(np.arange(T, dtype=np.int32), (n, 1)),
            "txt_mask": np.asarray(enc["attention_mask"], np.int32),
            "labels": self.labels[idx],
            "ids": self.ids[idx],
        }
