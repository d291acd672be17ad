"""Stratified cross-validation split generation.

A copy of ``meme_challenge_tpu/data/crossval_splits.py`` (plain python and
numpy), kept so that the port imports nothing of the JAX package.

Parity: reference utils/crossval.py:24-129 (``generate_crossval_splits``).
The exported ``train_XX.jsonl`` / ``dev_XX.jsonl`` / ``dev_seen_XX.jsonl``
files must be *identical* to the reference's for bitwise-comparable
downstream CSVs, so this function reproduces the reference's RNG call
sequence exactly (``random.seed(42)``/``np.random.seed(42)``, the same
``shuffle``/``np.random.choice`` calls in the same order, including the
short-circuit around the per-confounder coin flip and the odd
reversed-argsort on rare-sample selection).
"""
from __future__ import annotations

import json
import logging
import math
import os
import random
from collections import defaultdict
from typing import List

import numpy as np

from meme_challenge_tpu_torch.core.artifacts import export_jsonl

logger = logging.getLogger("meme_challenge_tpu_torch.crossval")


def crossval_dir(data_path: str, dev_size: int, use_dev_set: bool) -> str:
    return os.path.join(
        data_path,
        "crossval_%i%s" % (dev_size, "" if not use_dev_set else "_usedevtest"))


def generate_crossval_splits(data_path: str, dev_size: int = 300,
                             use_dev_set: bool = False) -> str:
    """Write per-fold jsonl splits; returns the crossval directory.

    ``use_dev_set=True``: half of dev_seen joins each fold's training set and
    the other half becomes that fold's test set, with occurrence balancing
    and confounder-aware assignment (reference utils/crossval.py:48-109).
    """
    random.seed(42)
    np.random.seed(42)
    data_list: List[dict] = []
    dev_list: List[dict] = []
    for filename in ["train.jsonl", "dev_seen.jsonl"]:
        path = os.path.join(data_path, filename)
        assert os.path.isfile(path), (
            "Cross-validation source file missing: %s" % path)
        with open(path, "r") as f:
            json_list = [json.loads(line) for line in f if line.strip()]
        if filename == "dev_seen.jsonl" and use_dev_set:
            dev_list = json_list
        else:
            random.shuffle(json_list)
            data_list += json_list

    data_by_label = {l: [d for d in data_list if d["label"] == l] for l in [0, 1]}
    num_splits = min(len(v) for v in data_by_label.values()) // dev_size

    train_by_split: List[List[dict]] = []
    dev_by_split_records: List[List[dict]] = []
    if use_dev_set:
        full_dev_size = len(dev_list)
        half_dev_size = full_dev_size // 2
        counts = np.zeros(full_dev_size, dtype=np.float32) + int(
            math.ceil(num_splits / 2.0))

        # text confounders inside dev_seen
        exmp_by_text = defaultdict(list)
        for idx, exmp in enumerate(dev_list):
            exmp_by_text[exmp["text"]].append(idx)
        confounder_list = [np.array(v, dtype=np.int32)
                           for v in exmp_by_text.values() if len(v) > 1]
        confounder_idxs = np.array(
            [v for vl in confounder_list for v in vl], dtype=np.int32)
        logger.info("Confounder groups: %i (members: %i)",
                    len(confounder_list), confounder_idxs.shape[0])

        dev_idx_by_split: List[list] = []
        for split_id in range(num_splits):
            split_counts = np.copy(counts)

            # confounder groups go to test together, with a balanced coin flip
            conf_to_include = np.array([], dtype=np.int32)
            splits_left = num_splits - split_id
            for cl in confounder_list:
                # float64, unlike the reference's float32 counts: numpy's
                # p-sum tolerance rejects [1/3, 2/3] at float32 precision and
                # crashes the reference outright on numpy>=1.25 — same RNG
                # stream consumption (one draw), no crash.
                conf_count = float(counts[cl[0]])
                # NOTE: short-circuit preserved — no RNG draw when the count
                # already forces inclusion (reference crossval.py:72-74).
                if conf_count >= splits_left or np.random.choice(
                        2, size=1,
                        p=[(splits_left - conf_count) / splits_left,
                           conf_count / splits_left]) == 1:
                    conf_to_include = np.concatenate([conf_to_include, cl])
                    counts[cl[0]] -= 1

            split_counts[confounder_idxs] = 0

            # samples that must appear in every remaining split
            samples_required = np.where(split_counts >= (num_splits - split_id))[0]
            spots_left = half_dev_size - conf_to_include.shape[0]
            if samples_required.shape[0] > spots_left:
                np.random.shuffle(samples_required)
                # reference quirk preserved: argsort over the *reversed* count
                # view, then truncate (crossval.py:85-87)
                samples_required = samples_required[
                    np.argsort(counts[samples_required][::-1])]
                samples_required = samples_required[:spots_left]
            spots_left -= samples_required.shape[0]
            split_counts[samples_required] = 0
            if split_counts.sum() == 0:
                samples = np.zeros((0,))
            else:
                samples = np.random.choice(
                    counts.shape[0], size=spots_left, replace=False,
                    p=split_counts / split_counts.sum())
                counts[samples] = counts[samples] - 1
            counts[samples_required] = counts[samples_required] - 1
            samples = (samples.tolist()
                       + np.arange(counts.shape[0])[samples_required].tolist()
                       + conf_to_include.tolist())
            dev_idx_by_split.append(samples)

        train_idx_by_split = [
            [i for i in range(len(dev_list)) if i not in d]
            for d in dev_idx_by_split
        ]
        dev_by_split_records = [[dev_list[int(i)] for i in d]
                                for d in dev_idx_by_split]
        train_by_split = [[dev_list[int(i)] for i in d]
                          for d in train_idx_by_split]
        label_avgs = [sum(d["label"] for d in dlist) * 1.0 / len(dlist)
                      for dlist in dev_by_split_records]
        logger.info("Per-test-set label means: %s", label_avgs)
        logger.info("Per-test-set sizes: %s",
                    [len(d) for d in dev_by_split_records])

    out_dir = crossval_dir(data_path, dev_size, use_dev_set)
    os.makedirs(out_dir, exist_ok=True)
    for split_id in range(num_splits):
        start, end = split_id * (dev_size // 2), (split_id + 1) * (dev_size // 2)
        dev_set = data_by_label[0][start:end] + data_by_label[1][start:end]
        train_set = (data_by_label[0][:start] + data_by_label[0][end:]
                     + data_by_label[1][:start] + data_by_label[1][end:])
        if use_dev_set:
            train_set = train_set + train_by_split[split_id]
            export_jsonl(
                os.path.join(out_dir,
                             "dev_seen_%s.jsonl" % str(split_id).zfill(2)),
                dev_by_split_records[split_id])
        export_jsonl(
            os.path.join(out_dir, "train_%s.jsonl" % str(split_id).zfill(2)),
            train_set)
        export_jsonl(
            os.path.join(out_dir, "dev_%s.jsonl" % str(split_id).zfill(2)),
            dev_set)
        label_avg = sum(d["label"] for d in dev_set) * 1.0 / len(dev_set)
        logger.info("Split %i written (validation positive rate %4.2f%%).",
                    split_id, 100.0 * label_avg)
    return out_dir
