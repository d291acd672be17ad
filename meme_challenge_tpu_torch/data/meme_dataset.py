"""Meme dataset: jsonl labels + precomputed region features → static batches.

A copy of ``meme_challenge_tpu/data/meme_dataset.py`` (plain numpy). Batches
stay numpy; the trainer turns them into tensors on the device.

Capability parity with reference data/meme_dataset.py + data/dataset_template.py,
re-architected for the TPU input pipeline:

- **Tokenize once, at load.** The reference tokenizes inside ``collate_fn``
  per batch (meme_dataset.py:175-177); here all texts are encoded to fixed
  ``[N, max_txt_len]`` arrays up front.
- **Dense preloaded feature arrays.** The reference np.loads two files per
  sample per epoch in DataLoader workers (dataset_template.py:92-114);
  here features land once in ``[N, max_bb, img_dim]`` host arrays (fp16
  storage by default) and batching is pure fancy-indexing — the host never
  becomes the bottleneck for the jitted train step.
- **Static shapes.** Samples are padded to ``max_bb`` boxes with an explicit
  ``img_mask``; batches are fixed ``batch_size`` with a ``sample_mask`` for
  the (padded) final batch. This replaces dynamic per-batch padding +
  ``gather_index`` compaction (meme_dataset.py:185-207).

Semantics preserved: 7-d bbox encoding with normalized coordinates
(dataset_template.py:98-113 with ``normalize=True`` as in
meme_dataset.py:117), per-sample confidence-threshold filtering of boxes
(meme_dataset.py:121-126), labels default −1 when absent
(meme_dataset.py:53-55), zero-filled 5-digit feature ids
(dataset_template.py:88-89).
"""
from __future__ import annotations

import json
import logging
import os
from random import shuffle
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from meme_challenge_tpu_torch.core.constants import IMG_DIM, MAX_BB, MAX_TXT_LEN, POS_DIM
from meme_challenge_tpu_torch.train.observability import span

logger = logging.getLogger("meme_challenge_tpu_torch.data")


def expand_id(img_id: int) -> str:
    """5-digit zero-fill (reference dataset_template.py:88-89)."""
    return str(int(img_id)).zfill(5)


def load_img_feature(feature_dir: str, img_id: int, normalize: bool = True):
    """Load one sample's region features + 7-d bbox position encoding.

    Parity: reference dataset_template.py:92-114 (``_load_img_feature``).
    Returns (img_feat [nbb, 2048], img_pos_feat [nbb, 7], objects, objects_conf).
    """
    sid = expand_id(img_id)
    img_feat = np.load(os.path.join(feature_dir, f"{sid}.npy"))
    info = np.load(os.path.join(feature_dir, f"{sid}_info.npy"),
                   allow_pickle=True).item()
    x1, y1, x2, y2 = np.split(np.asarray(info["bbox"], dtype=np.float64), 4, axis=1)
    if normalize:
        x1 = x1 / info["image_width"]
        x2 = x2 / info["image_width"]
        y1 = y1 / info["image_height"]
        y2 = y2 / info["image_height"]
    w = x2 - x1
    h = y2 - y1
    img_pos_feat = np.concatenate((x1, y1, x2, y2, w, h, w * h), axis=1)
    objects = np.asarray(info["objects"])
    if "objects_conf" in info:
        objects_conf = np.asarray(info["objects_conf"])
    else:
        objects_conf = np.asarray(info["cls_prob"]).max(axis=-1)
    return (np.asarray(img_feat, dtype=np.float32),
            img_pos_feat.astype(np.float32), objects, objects_conf)


class MemeDataset:
    """In-memory static-shape dataset over a jsonl split."""

    def __init__(
        self,
        filepath: str,
        feature_dir: Optional[str] = None,
        tokenizer=None,
        max_txt_len: int = MAX_TXT_LEN,
        max_bb: int = MAX_BB,
        confidence_threshold: float = 0.0,
        text_only: bool = False,
        return_ids: bool = False,
        feature_dtype=np.float16,
        img_dim: int = IMG_DIM,
    ):
        records = None
        if isinstance(filepath, (list, tuple)):
            # merged corpus (pretraining: train + dev_seen [+ memotion],
            # reference data/pretrain_meme_dataset.py:65-92)
            records = []
            for path in filepath:
                assert os.path.isfile(path), (
                    'No dataset file at "%s".' % path)
                assert path.endswith(".jsonl"), (
                    'The filepath requires a JSON list file (".jsonl"): '
                    '"%s"' % path)
                with open(path, "r") as f:
                    records.extend(json.loads(l) for l in f if l.strip())
            self.filepath = filepath[0]
            self.name = "+".join(
                p.split("/")[-1].split(".")[0] for p in filepath)
        else:
            assert os.path.isfile(filepath), (
                'No dataset file at "%s".' % filepath)
            assert filepath.endswith(".jsonl"), (
                'The filepath requires a JSON list file (".jsonl"): "%s"'
                % filepath)
            self.filepath = filepath
            self.name = filepath.split("/")[-1].split(".")[0]
        self.feature_dir = feature_dir
        self.text_only = text_only
        self.return_ids = return_ids
        self.max_txt_len = max_txt_len
        self.max_bb = max_bb
        self.img_dim = img_dim
        self.confidence_threshold = confidence_threshold

        if records is None:
            with open(filepath, "r") as f:
                records = [json.loads(line) for line in f if line.strip()]
        self.ids = np.array([int(r["id"]) for r in records], dtype=np.int64)
        self.labels = np.array([r.get("label", -1) for r in records],
                               dtype=np.int64)
        self.texts: List[str] = [r["text"] for r in records]
        self.img_paths = [r.get("img", "") for r in records]
        n = len(records)
        assert len(self.texts) == n == self.labels.shape[0]

        # --- text: tokenize once ---
        if tokenizer is not None:
            enc = tokenizer(self.texts, max_length=max_txt_len)
            self.input_ids = np.asarray(enc["input_ids"], dtype=np.int32)
            self.txt_mask = np.asarray(enc["attention_mask"], dtype=np.int32)
            self.txt_len = np.asarray(enc["length"], dtype=np.int32)
        else:
            self.input_ids = np.zeros((n, max_txt_len), dtype=np.int32)
            self.txt_mask = np.ones((n, max_txt_len), dtype=np.int32)
            self.txt_len = np.full(n, max_txt_len, dtype=np.int32)
        self.position_ids = np.tile(
            np.arange(max_txt_len, dtype=np.int32), (n, 1))

        # --- image features: preload dense ---
        if not text_only:
            assert feature_dir is not None, "feature_dir required unless text_only"
            for img_id in self.ids:
                sid = expand_id(img_id)
                for suffix in (".npy", "_info.npy"):
                    path = os.path.join(feature_dir, sid + suffix)
                    assert os.path.isfile(path), (
                        "Feature file for image %s does not exist." % sid)
            self.img_feat = np.zeros((n, max_bb, img_dim), dtype=feature_dtype)
            self.img_pos_feat = np.zeros((n, max_bb, POS_DIM), dtype=np.float32)
            self.num_bb = np.zeros(n, dtype=np.int32)
            self.objects = []
            for i, img_id in enumerate(self.ids):
                feat, pos, objs, conf = load_img_feature(
                    feature_dir, img_id, normalize=True)
                if confidence_threshold > 0.0:
                    valid = conf > confidence_threshold
                    feat, pos, objs = feat[valid], pos[valid], objs[valid]
                nbb = min(feat.shape[0], max_bb)
                self.img_feat[i, :nbb] = feat[:nbb]
                self.img_pos_feat[i, :nbb] = pos[:nbb]
                self.num_bb[i] = nbb
                self.objects.append(objs[:nbb])
            self.img_mask = (
                np.arange(max_bb)[None, :] < self.num_bb[:, None]
            ).astype(np.int32)
        else:
            self.img_feat = None
            self.img_pos_feat = None
            self.num_bb = None
            self.img_mask = None

    def __len__(self) -> int:
        return self.ids.shape[0]

    def get_by_id(self, data_id: int) -> Optional[dict]:
        """Access a data point by its dataset id (dataset_template.py:138-147)."""
        where = np.where(self.ids == data_id)[0]
        if where.shape[0] == 0:
            logger.warning('Unknown sample id "%s" for this dataset.',
                           data_id)
            return None
        return self.batch(where[:1])

    def device_arrays(self) -> Dict[str, np.ndarray]:
        """Full-dataset model-input arrays for the device-resident pipeline.

        Upload ONCE to the device and let the eval step gather
        micro-batches from indices on device (train/steps.py:gather_micro)
        — the HM corpus is ~4 GB fp16 and fits in HBM, so per-step
        host→device traffic drops from feature megabytes to index bytes
        (SURVEY.md §7 hard-part 8).
        """
        out = {
            "input_ids": self.input_ids,
            "position_ids": self.position_ids,
            "txt_mask": self.txt_mask,
            "labels": self.labels,
        }
        if not self.text_only:
            assert self.img_feat is not None, (
                "device_arrays requires preloaded features")
            out.update(img_feat=self.img_feat,
                       img_pos_feat=self.img_pos_feat,
                       img_mask=self.img_mask)
        return out

    def batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        """Assemble a static-shape batch by fancy indexing."""
        idx = np.asarray(indices)
        out: Dict[str, np.ndarray] = {
            "input_ids": self.input_ids[idx],
            "position_ids": self.position_ids[idx],
            "txt_mask": self.txt_mask[idx],
            "labels": self.labels[idx],
            "ids": self.ids[idx],
        }
        if not self.text_only:
            # emit the STORED dtype (fp16 by default): features are fp16 on
            # disk/RAM anyway, the model upcasts in-graph, and shipping fp32
            # would double the dominant host→device stream of every train
            # and eval step (13 MB vs 26 MB per b16×a2 batch)
            out["img_feat"] = self.img_feat[idx]
            out["img_pos_feat"] = self.img_pos_feat[idx]
            out["img_mask"] = self.img_mask[idx]
        return out


class BatchLoader:
    """Static-batch iterator with final-batch padding + sample mask.

    The TPU replacement for torch DataLoader + collate_fn: every batch has
    identical shapes (one XLA compilation); the padded tail of the final
    batch is flagged via ``sample_mask`` and dropped host-side by consumers.
    """

    def __init__(self, dataset: MemeDataset, batch_size: int,
                 sampler=None, shuffle_data: bool = False,
                 index_batches: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.shuffle_data = shuffle_data
        # index_batches: yield only {indices, sample_mask, ids, labels}
        # (same ordering/padding); the consumer gathers model inputs on
        # device from dataset.device_arrays() — see train/steps.gather_micro
        self.index_batches = index_batches

    def _order(self) -> np.ndarray:
        if self.sampler is not None:
            return np.asarray(list(iter(self.sampler)), dtype=np.int64)
        order = np.arange(len(self.dataset), dtype=np.int64)
        if self.shuffle_data:
            idx = list(order)
            shuffle(idx)  # python RNG: same seed discipline as reference
            order = np.asarray(idx, dtype=np.int64)
        return order

    def __len__(self) -> int:
        n = (len(self.sampler) if self.sampler is not None
             else len(self.dataset))
        return (n + self.batch_size - 1) // self.batch_size

    def example_batch(self) -> Dict[str, np.ndarray]:
        """One host MODEL-INPUT batch for parameter-shape init.

        Works in index mode too — index batches carry no model inputs, so
        ``next(iter(loader))`` is NOT a usable init example there. Every
        trainer entry point inits from this helper instead of hand-rolling
        the index-mode materialization. Host mode goes through ``__iter__``
        so subclass batch transforms (e.g. Oscar's 2054-d feature assembly)
        are preserved."""
        if not self.index_batches:
            ex = dict(next(iter(self)))
        else:
            n = min(self.batch_size, len(self.dataset))
            ex = dict(self.dataset.batch(np.arange(n)))
            ex["sample_mask"] = np.ones(n, np.int32)
        ex.pop("ids", None)
        return ex

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        with span("meme.loader.order"):
            order = self._order()
        bs = self.batch_size
        for start in range(0, order.shape[0], bs):
            # the range closes before the yield: the consumer's work is
            # not the loader's
            with span("meme.loader.batch"):
                chunk = order[start:start + bs]
                valid = chunk.shape[0]
                if valid < bs:  # pad final batch by repeating its first sample
                    chunk = np.concatenate(
                        [chunk, np.full(bs - valid, chunk[0], dtype=np.int64)])
                mask = np.zeros(bs, dtype=np.int32)
                mask[:valid] = 1
                if self.index_batches:
                    batch = {"indices": chunk.astype(np.int32),
                             "sample_mask": mask,
                             "ids": self.dataset.ids[chunk],
                             "labels": self.dataset.labels[chunk]}
                else:
                    batch = self.dataset.batch(chunk)
                    batch["sample_mask"] = mask
            yield batch


class ConfounderSampler:
    """Benign-text-confounder upsampling.

    Parity: reference ConfounderSampler (data/meme_dataset.py:221-271) —
    texts that appear with *both* labels are repeated ``repeat_factor`` times
    per epoch; non-confounders are split across the repeats; every sublist is
    shuffled with the global python RNG (same seed discipline).
    """

    def __init__(self, dataset: MemeDataset, repeat_factor: int = 1):
        self.dataset = dataset
        self.repeat_factor = repeat_factor
        self._find_confounders()
        self._generate_sample_list()

    def _find_confounders(self) -> None:
        label_per_text: Dict[str, list] = {}
        for idx, text in enumerate(self.dataset.texts):
            label_per_text.setdefault(text, []).append(
                int(self.dataset.labels[idx]))
        confounder_text = {
            t for t, ls in label_per_text.items()
            if sorted(set(ls)) == [0, 1]
        }
        self.confounders: List[int] = []
        self.non_confounders: List[int] = []
        for idx, text in enumerate(self.dataset.texts):
            (self.confounders if text in confounder_text
             else self.non_confounders).append(idx)
        logger.info(
            "Dataset %s: %i confounder-text members vs %i others out of %i "
            "examples (%4.2f%%)",
            self.dataset.name, len(self.confounders),
            len(self.non_confounders), len(self.dataset),
            100.0 * len(self.confounders) / max(len(self.dataset), 1))

    def _generate_sample_list(self) -> None:
        plain = self.non_confounders[:]
        shuffle(plain)
        rf = self.repeat_factor
        splits = [(len(plain) // rf) * i for i in range(rf)] + [len(plain)]
        sample_list: List[int] = []
        for i in range(rf):
            sub = plain[splits[i]:splits[i + 1]] + self.confounders
            shuffle(sub)
            sample_list += sub
        self.sample_list = sample_list

    def __iter__(self):
        self._generate_sample_list()
        return iter(self.sample_list)

    def __len__(self) -> int:
        return len(self.sample_list)
