"""Twitter hate-speech dataset (auxiliary text-domain warm-up).

A copy of ``meme_challenge_tpu/data/hatespeech.py`` (plain python and
numpy), kept so that the port imports nothing of the JAX package.

Parity: reference data/hatespeech_dataset.py — CSV with ``label``/``text``
columns, tweet scrubbing (the #MKR removal, URL/hashtag/retweet/user-mention
stripping, emoji removal, quote trimming, data/hatespeech_dataset.py:93-111),
label vocabulary derived from the data (sorted unique values).
"""
from __future__ import annotations

import csv
import os
import re
from typing import Dict, Sequence

import numpy as np

EMOJI_PATTERN = re.compile(
    "["
    "\U0001F1E0-\U0001F1FF"
    "\U0001F300-\U0001F5FF"
    "\U0001F600-\U0001F64F"
    "\U0001F680-\U0001F6FF"
    "\U0001F700-\U0001F77F"
    "\U0001F780-\U0001F7FF"
    "\U0001F800-\U0001F8FF"
    "\U0001F900-\U0001F9FF"
    "\U0001FA00-\U0001FA6F"
    "\U0001FA70-\U0001FAFF"
    "\U00002702-\U000027B0"
    "\U000024C2-\U0001F251"
    "]+"
)


def preprocess_tweet(tweet: str) -> str:
    """Scrubbing parity: reference hatespeech_dataset.py:93-111."""
    tweet = tweet.replace("#MKR", "")
    tweet = re.sub(r"https?://\S+", "", tweet)
    tweet = re.sub(r"#[\w-]+", "", tweet)
    tweet = re.sub(r'^["\']?RT @\S+:', "", tweet)
    tweet = re.sub(r"RT @\S+:", "RT:", tweet)
    tweet = re.sub(r"@\S+", "", tweet)
    tweet = EMOJI_PATTERN.sub(r"", tweet)
    tweet = tweet.replace("  ", " ")
    tweet = tweet.replace("\\'", "'")
    return tweet.strip("\"' \t\n")


class TwitterHatespeechDataset:
    """CSV → static tokenized arrays, BatchLoader-compatible."""

    def __init__(self, filepath: str, tokenizer=None, max_txt_len: int = 64,
                 return_ids: bool = False):
        assert os.path.isfile(filepath), (
            'No dataset file at "%s".' % filepath)
        assert filepath.endswith(".csv"), (
            'Dataset file is expected to be a CSV file: "%s".' % filepath)
        self.filepath = filepath
        self.name = filepath.split("/")[-1].split(".")[0]
        self.return_ids = return_ids

        with open(filepath, "r", newline="") as f:
            rows = list(csv.reader(f, delimiter=","))
        keys = rows[0]
        label_idx, text_idx = keys.index("label"), keys.index("text")
        raw_labels = [r[label_idx] for r in rows[1:] if r]
        self.texts = [preprocess_tweet(r[text_idx]) for r in rows[1:] if r]
        self.label_names = sorted(set(raw_labels))
        self.num_classes = len(self.label_names)
        self.labels = np.array(
            [self.label_names.index(l) for l in raw_labels], dtype=np.int64)
        self.ids = np.arange(len(self.texts), dtype=np.int64)

        if tokenizer is not None:
            enc = tokenizer(self.texts, max_length=max_txt_len)
            self.input_ids = np.asarray(enc["input_ids"], np.int32)
            self.txt_mask = np.asarray(enc["attention_mask"], np.int32)
        else:
            self.input_ids = np.zeros((len(self.texts), max_txt_len), np.int32)
            self.txt_mask = np.ones_like(self.input_ids)
        n, T = self.input_ids.shape
        self.position_ids = np.tile(np.arange(T, dtype=np.int32), (n, 1))

    def __len__(self) -> int:
        return len(self.texts)

    def batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        idx = np.asarray(indices)
        return {
            "input_ids": self.input_ids[idx],
            "position_ids": self.position_ids[idx],
            "txt_mask": self.txt_mask[idx],
            "labels": self.labels[idx],
            "ids": self.ids[idx],
        }
