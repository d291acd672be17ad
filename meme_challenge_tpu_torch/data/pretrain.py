"""Pretraining task datasets + multi-task loader.

A copy of ``meme_challenge_tpu/data/pretrain.py`` (plain python and numpy):
for the same ``random.seed`` / ``np.random.seed`` it makes the same batches,
draw for draw. One deliberate difference: :meth:`MetaLoader.set_state`
starts a fresh shuffled epoch for a task whose record has no epoch order
(``TaskLoader.reset_position``), where the JAX package keeps the loader's
position from earlier consumption in the same process.

Capability parity with reference data/pretrain_{meme_dataset,mlm,itm,mrfr}.py
in static-shape form:

- **corpus**: train.jsonl + dev_seen.jsonl (+ Memotion all.jsonl with
  ``use_memotion``) merged into one ``MemeDataset``
  (reference pretrain_meme_dataset.py:65-92).
- **MLM** (pretrain_mlm.py:35-69): BERT-style masking — 15% of non-special
  tokens; among those 80% → [MASK], 10% → random vocab id, 10% kept; labels
  −1 elsewhere; at least one masked position guaranteed (positions [1]).
  The nested-probability trick (``prob /= mask_prob``) is reproduced so the
  RNG stream matches the reference draw-for-draw.
- **ITM** (pretrain_itm.py:27-47): with ``replace_prob``, swap in a
  *different* sample's text (resampling on text collisions), label 0/1. The
  vestigial ``ot_inputs`` placeholder is dropped — OT runs through
  models/ot.py directly.
- **MRFR** (pretrain_mrfr.py:29-51): Bernoulli region mask with an
  at-least-one guarantee; masked features zeroed; regression targets kept
  densely as ``feat_targets`` (the dense-mask equivalent of the reference's
  compacted target rows).
- **MRC** — *extension*: the reference ships the MRC head
  (model/pretrain.py:205-233) but no dataset; here detector classes
  (``objects``) become hard one-hot label targets (index 0 = background
  reserved; MemeDataset keeps only the class ids, not the confidences).
- **MetaLoader** (pretrain_meme_dataset.py:21-58): infinite random task
  sampling over named loaders with optional ratios, task held fixed for
  ``accum_steps``.

All task batches are static ``[B, T]`` / ``[B, R]`` shapes; masking happens
host-side with the global python RNG (reference seed discipline).
"""
from __future__ import annotations

import os
import random
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from meme_challenge_tpu_torch.core.constants import IMG_LABEL_DIM
from meme_challenge_tpu_torch.data.meme_dataset import MemeDataset


def pretrain_corpus(
    data_path: str,
    feature_dir: str,
    tokenizer,
    use_memotion: bool = False,
    **kwargs,
) -> MemeDataset:
    """Merged pretraining corpus (reference Pretrain_MemeDataset)."""
    paths = [os.path.join(data_path, "train.jsonl"),
             os.path.join(data_path, "dev_seen.jsonl")]
    if use_memotion:
        paths.append(os.path.join(data_path, "memotion_dataset", "all.jsonl"))
    return MemeDataset(paths, feature_dir=feature_dir, tokenizer=tokenizer,
                       **kwargs)


def mask_tokens_bert(
    token_ids: np.ndarray,
    attn_mask: np.ndarray,
    rng: random.Random,
    mask_prob: float,
    mask_token: int,
    vocab_range: Tuple[int, int],
    special_ids: Tuple[int, ...],
) -> Tuple[np.ndarray, np.ndarray]:
    """BERT 80/10/10 masking of one sequence (reference pretrain_mlm.py:35-69).

    Reproduces the reference's RNG pattern: one uniform draw per token,
    renormalized (``prob /= mask_prob``) to choose the 80/10/10 branch.
    Padding/CLS/SEP positions get label −1.

    One deliberate semantic fix (documented quirk, not replicated): the
    reference's at-least-one-mask fallback stores ``tokens[1]`` — a live
    0-dim tensor VIEW — into the label list before overwriting
    ``tokens[1] = mask`` (pretrain_mlm.py:65-68), so its fallback label
    mutates into the MASK id and teaches the model to predict [MASK].
    We keep the ORIGINAL token as the target. Draw-for-draw RNG parity
    with the executed reference is pinned in tests/test_rng_oracle.py.
    """
    tokens = token_ids.copy()
    labels = np.full_like(tokens, -1)
    n = int(attn_mask.sum())
    for i in range(len(tokens)):
        token = int(tokens[i])
        if i >= n or token in special_ids:
            continue
        prob = rng.random()
        if prob < mask_prob:
            prob /= mask_prob
            if prob < 0.8:
                tokens[i] = mask_token
            elif prob < 0.9:
                tokens[i] = rng.choice(range(*vocab_range))
            labels[i] = token
    if (labels == -1).all():
        # at least mask one: the first word after [CLS]
        labels[1] = tokens[1]
        tokens[1] = mask_token
    return tokens, labels


def _batch_rng(rng: random.Random) -> np.random.Generator:
    """Per-batch numpy Generator seeded FROM the python RNG stream — the
    vectorized batchers stay deterministic under the reference's global
    ``random.seed`` discipline (one 64-bit draw per batch) while the
    per-token draws vectorize."""
    return np.random.default_rng(rng.getrandbits(64))


def mask_tokens_bert_batch(
    token_ids: np.ndarray,
    attn_mask: np.ndarray,
    np_rng: np.random.Generator,
    mask_prob: float,
    mask_token: int,
    vocab_range: Tuple[int, int],
    special_ids: Tuple[int, ...],
) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized BERT 80/10/10 masking over a ``[B, T]`` batch.

    Distribution-identical to :func:`mask_tokens_bert` row-by-row (incl. the
    renormalized-uniform branch trick and the at-least-one guarantee), but
    one numpy draw per tensor instead of one python draw per token — the
    per-token loop was the host-side serial tail of the pretrain driver
    loop (measured r3: ~700 memes/s loop vs ~800 step-only)."""
    B, T = token_ids.shape
    tokens = token_ids.copy()
    labels = np.full_like(tokens, -1)
    n = attn_mask.sum(axis=1)
    eligible = (np.arange(T)[None, :] < n[:, None]) \
        & ~np.isin(tokens, special_ids)
    prob = np_rng.random((B, T))
    sel = eligible & (prob < mask_prob)
    sub = prob / mask_prob                      # renormalized branch draw
    labels[sel] = tokens[sel]
    tokens[sel & (sub < 0.8)] = mask_token
    to_rand = sel & (sub >= 0.8) & (sub < 0.9)
    if to_rand.any():
        tokens[to_rand] = np_rng.integers(
            vocab_range[0], vocab_range[1], size=int(to_rand.sum()))
    none = ~sel.any(axis=1)
    if none.any():                              # at least one: position [1]
        rows = np.where(none)[0]
        labels[rows, 1] = tokens[rows, 1]
        tokens[rows, 1] = mask_token
    return tokens, labels


class MLMBatcher:
    """Wraps a corpus loader; applies MLM masking per batch.

    ``reference_rng=True`` reproduces the reference's per-token python-RNG
    draw order exactly (pretrain_mlm.py:35-69); the default vectorized path
    is distribution-identical and ~50× cheaper on the host."""

    def __init__(self, dataset: MemeDataset, tokenizer, mask_prob: float = 0.15,
                 vocab_range: Optional[Tuple[int, int]] = None,
                 reference_rng: bool = False):
        self.dataset = dataset
        self.tokenizer = tokenizer
        self.mask_prob = mask_prob
        # random-replacement ids skip the special + [unused##] blocks
        # (BERT convention; reference passes an explicit vocab_range)
        self.vocab_range = vocab_range or tokenizer.mlm_vocab_range()
        self.special_ids = (tokenizer.cls_id, tokenizer.sep_id,
                            tokenizer.pad_id)
        self.reference_rng = reference_rng

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        input_ids = batch["input_ids"].copy()
        if self.reference_rng:
            txt_labels = np.full_like(input_ids, -1)
            for i in range(input_ids.shape[0]):
                input_ids[i], txt_labels[i] = mask_tokens_bert(
                    input_ids[i], batch["txt_mask"][i], random,
                    self.mask_prob, self.tokenizer.mask_id, self.vocab_range,
                    self.special_ids)
        else:
            input_ids, txt_labels = mask_tokens_bert_batch(
                input_ids, batch["txt_mask"], _batch_rng(random),
                self.mask_prob, self.tokenizer.mask_id, self.vocab_range,
                self.special_ids)
        out = dict(batch)
        out["input_ids"] = input_ids
        out["txt_labels"] = txt_labels
        return out


class ITMBatcher:
    """Replaces text with another sample's w.p. replace_prob → target 0/1."""

    def __init__(self, dataset: MemeDataset, replace_prob: float = 0.5):
        self.dataset = dataset
        self.replace_prob = replace_prob

    def __call__(self, batch: Dict[str, np.ndarray],
                 indices: np.ndarray) -> Dict[str, np.ndarray]:
        ds = self.dataset
        out = dict(batch)
        input_ids = batch["input_ids"].copy()
        txt_mask = batch["txt_mask"].copy()
        targets = np.ones(len(indices), dtype=np.int64)
        n = len(ds)
        for row, idx in enumerate(indices):
            if random.random() < self.replace_prob:
                # O(1) rejection sampling (uniform over != idx with a
                # different text) — building the full candidate list per
                # draw was O(corpus) on the host input path. Bounded: a
                # degenerate corpus (all rows one text) would otherwise spin
                # forever; after the cap any rand_idx != idx is accepted
                # (the replacement is then a same-text "negative", which is
                # the only option such a corpus offers).
                if n < 2:
                    raise ValueError(
                        "ITM replacement impossible: corpus has <2 rows")
                rand_idx = None
                for _ in range(64):
                    cand = random.randrange(n)
                    if cand != idx and ds.texts[idx] != ds.texts[cand]:
                        rand_idx = cand
                        break
                if rand_idx is None:
                    rand_idx = (idx + 1 + random.randrange(n - 1)) % n
                input_ids[row] = ds.input_ids[rand_idx]
                txt_mask[row] = ds.txt_mask[rand_idx]
                targets[row] = 0
        out["input_ids"] = input_ids
        out["txt_mask"] = txt_mask
        out["targets"] = targets
        return out


class MRFRBatcher:
    """Bernoulli region masks (≥1 per sample), zeroed features, dense targets."""

    def __init__(self, dataset: MemeDataset, mask_prob: float = 0.15,
                 reference_rng: bool = False):
        self.dataset = dataset
        self.mask_prob = mask_prob
        self.reference_rng = reference_rng

    def _region_masks(self, img_mask: np.ndarray) -> np.ndarray:
        B, R = img_mask.shape
        if self.reference_rng:
            # per-region python draws (reference pretrain_mrfr.py:29-35)
            img_masks = np.zeros((B, R), dtype=np.int32)
            for i in range(B):
                nbb = int(img_mask[i].sum())
                if nbb == 0:
                    continue
                flags = [random.random() < self.mask_prob
                         for _ in range(nbb)]
                if not any(flags):
                    flags[random.choice(range(nbb))] = True
                img_masks[i, :nbb] = np.asarray(flags, dtype=np.int32)
            return img_masks
        # vectorized: distribution-identical Bernoulli + uniform fallback
        rng = _batch_rng(random)
        valid = img_mask.astype(bool)
        flags = (rng.random((B, R)) < self.mask_prob) & valid
        nbb = valid.sum(axis=1)
        need = ~flags.any(axis=1) & (nbb > 0)
        if need.any():
            rows = np.where(need)[0]
            picks = (rng.random(rows.shape[0]) * nbb[rows]).astype(np.int64)
            flags[rows, picks] = True
        return flags.astype(np.int32)

    def __call__(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        out = dict(batch)
        img_mask = batch["img_mask"]
        img_masks = self._region_masks(img_mask)
        if "img_feat" in batch:
            feat = batch["img_feat"]
            out["feat_targets"] = feat
            out["img_feat"] = np.where(img_masks[..., None].astype(bool),
                                       0.0, feat)
        # index-mode batches carry no features: zeroing + targets happen on
        # the device from the device-resident arrays
        # (pretrain_driver._task_prepare)
        out["img_masks"] = img_masks
        return out


class MRCBatcher:
    """Region-classification HARD one-hot targets from detector class ids
    (extension —
    the reference has the head but no data path; SURVEY.md §2 quirks)."""

    def __init__(self, dataset: MemeDataset, mask_prob: float = 0.15,
                 label_dim: int = IMG_LABEL_DIM, reference_rng: bool = False):
        self.dataset = dataset
        self.mask_prob = mask_prob
        self.label_dim = label_dim
        self._mrfr = MRFRBatcher(dataset, mask_prob,
                                 reference_rng=reference_rng)
        # dense [N, R] class-id table built once: detector class ids are
        # 0-based over 1600 fg classes; +1 leaves index 0 as background
        # (reference pretrain.py:228-230); padding rows stay −1
        R = dataset.max_bb
        n = len(dataset)
        self._cls = np.full((n, R), -1, dtype=np.int64)
        self._cls_count = np.zeros(n, dtype=np.int64)
        for i, objs in enumerate(dataset.objects):
            k = min(len(objs), R)
            self._cls[i, :k] = np.asarray(objs[:k], dtype=np.int64) + 1
            self._cls_count[i] = k

    def __call__(self, batch: Dict[str, np.ndarray],
                 indices: np.ndarray) -> Dict[str, np.ndarray]:
        out = self._mrfr(batch)
        out.pop("feat_targets", None)  # MRC has no regression targets
        idx = np.asarray(indices)
        if "img_feat" not in batch:
            # index-mode: ship only the [B, R] class ids (64 KB at b16) —
            # the driver one-hots them on the device
            # (pretrain_driver._task_prepare). A dense [B, R, 1601] fp32
            # one-hot is ~10 MB per micro-batch, which would leave the mrc
            # task channel-bound on slow host→device links exactly like
            # streamed features; padding rows are −1 and their one-hot is
            # the same all-zero row the dense path builds
            out["label_cls"] = self._cls[idx].astype(np.int32)
            return out
        B, R = batch["img_mask"].shape
        labels = np.zeros((B, R, self.label_dim), dtype=np.float32)
        valid = np.arange(R)[None, :] < self._cls_count[idx][:, None]
        rows, regions = np.nonzero(valid)
        labels[rows, regions, self._cls[idx][rows, regions]] = 1.0
        out["label_targets"] = labels
        return out


class TaskLoader:
    """One pretraining task = corpus loader + batcher; yields task batches."""

    def __init__(self, name: str, dataset: MemeDataset, batch_size: int,
                 batcher, needs_indices: bool = False,
                 index_batches: bool = False):
        self.name = name
        self.dataset = dataset
        self.batch_size = batch_size
        self.batcher = batcher
        self.needs_indices = needs_indices
        # index_batches: the base batch carries only the (tiny) text-side
        # arrays + img_mask + indices; features stay device-resident and the
        # driver gathers them on device (train/steps.gather_micro). The
        # batchers' host RNG draws are IDENTICAL in both modes.
        self.index_batches = index_batches
        # epoch-position tracking for O(1) checkpoint resume (state() /
        # resume_iter()). Shared loader-level state: at most ONE live
        # iterator per loader (the MetaLoader's) — a second concurrent
        # iterator would clobber the position.
        self._order: Optional[List[int]] = None
        self._pos = 0

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def state(self) -> Dict:
        """Snapshot of the current epoch position: the shuffled order plus
        the next batch's start offset. ``order`` is None before the first
        batch of the run (no epoch started — resume then just starts one)."""
        return {
            "order": None if self._order is None
            else [int(i) for i in self._order],
            "pos": int(self._pos),
        }

    def reset_position(self) -> None:
        """Forget the current epoch: :meth:`state` reads "no epoch started"
        until the next iterator's first batch shuffles a new one."""
        self._order = None
        self._pos = 0

    def resume_iter(self, state: Dict) -> Iterator[Dict[str, np.ndarray]]:
        """Iterator continuing the epoch recorded by :meth:`state` — no
        fresh shuffle, so the remaining batches (and every global-RNG draw
        the batcher makes for them) equal the interrupted run's."""
        self._order = [int(i) for i in state["order"]]
        self._pos = int(state["pos"])
        return self._epoch_iter(fresh=False)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self._epoch_iter(fresh=True)

    def _epoch_iter(self, fresh: bool) -> Iterator[Dict[str, np.ndarray]]:
        # generator: with fresh=True the shuffle draw happens on the FIRST
        # next(), not at iter() time — MetaLoader creates iterators for all
        # tasks up front, and an eager shuffle would reorder the global RNG
        # stream that the draw-parity oracles pin
        if fresh:
            order = list(range(len(self.dataset)))
            random.shuffle(order)
            self._order = order
            self._pos = 0
        bs = self.batch_size
        ds = self.dataset
        while self._pos < len(self._order):
            start = self._pos
            self._pos = start + bs  # consumed once this next() returns
            chunk = np.asarray(self._order[start:start + bs])
            valid = chunk.shape[0]
            if valid < bs:
                chunk = np.concatenate(
                    [chunk, np.full(bs - valid, chunk[0], dtype=np.int64)])
            if self.index_batches:
                # fancy indexing already yields fresh copies — batchers may
                # mutate these without touching the dataset arrays
                batch = {
                    "input_ids": ds.input_ids[chunk],
                    "position_ids": ds.position_ids[chunk],
                    "txt_mask": ds.txt_mask[chunk],
                    "img_mask": ds.img_mask[chunk],
                    "indices": chunk.astype(np.int32),
                }
            else:
                batch = ds.batch(chunk)
                batch.pop("ids", None)
                batch.pop("labels", None)
            mask = np.zeros(bs, dtype=np.int32)
            mask[:valid] = 1
            batch["sample_mask"] = mask
            if self.needs_indices:
                yield self.batcher(batch, chunk)
            else:
                yield self.batcher(batch)


class MetaLoader:
    """Random multi-task sampling (reference MetaLoader,
    pretrain_meme_dataset.py:21-58): infinite iterator; the chosen task is
    held fixed for ``accum_steps`` consecutive batches."""

    def __init__(self, loaders: Dict[str, object], accum_steps: int = 1):
        assert isinstance(loaders, dict)
        self.name2loader = {}
        self.name2iter = {}
        self.sampling_pools: List[str] = []
        for name, l in loaders.items():
            if isinstance(l, tuple):
                l, ratio = l
            else:
                ratio = 1
            self.name2loader[name] = l
            self.name2iter[name] = iter(l)
            self.sampling_pools.extend([name] * ratio)
        self.accum_steps = accum_steps
        self.step = 0

    def state(self) -> Dict:
        """Snapshot for O(1) checkpoint resume: the micro-draw counter plus
        every task loader's epoch position. Only valid on an accumulation
        boundary — mid-group the currently-held task lives in generator
        state that a snapshot cannot carry."""
        assert self.step % self.accum_steps == 0, (
            "MetaLoader.state() mid-accumulation-group: the held task is "
            "not recoverable — snapshot only on optimizer-step boundaries")
        return {"step": int(self.step),
                "loaders": {name: loader.state()
                            for name, loader in self.name2loader.items()}}

    def set_state(self, state: Dict) -> None:
        """Reposition every task iterator to a :meth:`state` snapshot.
        Restore the host RNG state saved alongside it BEFORE iterating —
        the next task choice and the batchers' draws both come from the
        global stream."""
        if set(state["loaders"]) != set(self.name2loader):
            raise ValueError(
                "resume record's task set %s does not match this "
                "MetaLoader's %s — the checkpoint belongs to a run with a "
                "different task mix" % (sorted(state["loaders"]),
                                        sorted(self.name2loader)))
        self.step = int(state["step"])
        for name, ls in state["loaders"].items():
            loader = self.name2loader[name]
            if ls["order"] is None:
                # no epoch started when the record was taken: a fresh one,
                # from position 0, whatever this process consumed before
                loader.reset_position()
                self.name2iter[name] = iter(loader)
            else:
                self.name2iter[name] = loader.resume_iter(ls)

    def __iter__(self):
        task = self.sampling_pools[0]
        while True:
            if self.step % self.accum_steps == 0:
                task = random.choice(self.sampling_pools)
            self.step += 1
            it = self.name2iter[task]
            try:
                batch = next(it)
            except StopIteration:
                it = iter(self.name2loader[task])
                batch = next(it)
                self.name2iter[task] = it
            yield task, batch

    def __len__(self) -> int:
        return sum(len(l) for l in self.name2loader.values())
