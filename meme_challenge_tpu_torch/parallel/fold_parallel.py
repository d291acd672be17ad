"""Fold-parallel cross-validation training, on one card or over a mesh.

Counterpart of ``meme_challenge_tpu/parallel/fold_parallel.py``. The JAX
trainer ``vmap``s one update over a fold axis inside one ``jit``; here the F
folds are one :class:`~meme_challenge_tpu_torch.models.uniter.FoldStack`
and every step runs each layer, the attention kernels (the folds in their
batch axis) and the optimizer once for all F folds:

- parameters, optimizer state and batches carry a leading fold axis
  ``[F, ...]``; the folds share no parameter, so one backward of the summed
  fold losses gives each fold its own gradient, and the optimizer clips
  each fold by its own norm (``train/optim.py``, ``folds=F``);
- fold f's step k draws its dropout from ``dropout_generator(fold_seed(seed,
  f), k)``, the generator a sequential run of that fold draws from at that
  step (``core/seeding.fold_dropout_generators``), so F = 1 is the
  sequential ``Trainer``;
- per-fold early stopping keeps a best-parameter snapshot on the device:
  each epoch, the folds whose monitored metric improved copy their slice
  into it. Training runs until every fold has exhausted its patience;
  stopped folds keep computing, but their snapshot and patience freeze;
- folds march in lockstep; a shorter fold's stream restarts (cycles), so
  no fold drops tail batches.

Without a mesh (or on a mesh of one process) all F folds sit on the run's
one device. Over a ``torch.distributed`` mesh (``parallel/mesh.py``, one
process a device, ``torchrun``) each rank runs the same program on its
part, and every rank's step equals its slice of the one-process step:

- **fold**: rank r of the fold axis holds folds ``[r·F/n, (r+1)·F/n)``
  (``_shard_state``; F not divisible by n raises, as JAX's ``device_put``
  of a fold-sharded array does). Each fold draws from its global index.
  Every rank walks every fold's loader, building batches only for its own,
  so the host RNGs that shuffle them advance as in one process. The
  per-fold metrics are all-gathered every epoch, so the early-stopping
  state, the epochs run and the logs are the same on every rank;
- **data**: each fold's micro-batch is split by rows over the data axis.
  A fold's loss is its rows' share of the whole micro-batch's masked mean
  and the gradients are summed over the group (``train/steps.py``);
  dropout draws the whole micro-batch's masks and keeps the rank's rows
  (``models/uniter.py: ShardedGenerators``). Evaluation runs every row on
  each rank of the data axis;
- **model**: the ``parallel/mesh.py`` specs split the encoder's products
  Megatron-style (``models/uniter.py: ModelSplit``); a layer whose column
  and row products do not both split, or whose heads the axis does not
  divide, stays whole. Adam's moments follow their parameter's split, and
  the clip norm adds the split leaves' squares over the model group.

The resume file gathers every fold's whole state to rank 0 and holds the
one-process file's contents; loading it on any mesh takes each rank's part.
"""
from __future__ import annotations

import json
import logging
import os
import random
import time
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from meme_challenge_tpu_torch.core.config import TrainConfig
from meme_challenge_tpu_torch.core.metrics import standard_metrics
from meme_challenge_tpu_torch.core.seeding import fold_dropout_generators
from meme_challenge_tpu_torch.models.uniter import (
    FoldStack,
    ModelSplit,
    ShardedGenerators,
)
from meme_challenge_tpu_torch.parallel.mesh import (
    Mesh,
    apply_shardings,
    filter_divisible_specs,
    placements,
    uniter_param_specs,
)
from meme_challenge_tpu_torch.train.checkpoint import tree_to
from meme_challenge_tpu_torch.train.losses import make_loss_fn
from meme_challenge_tpu_torch.train.optim import Optimizer
from meme_challenge_tpu_torch.train.schedules import make_schedule
from meme_challenge_tpu_torch.train.steps import (
    EVAL_INFLIGHT_WINDOW,
    MODEL_INPUT_KEYS,
    TRAIN_KEYS,
    EvalPipeline,
    TrainState,
    chunk_batches,
    fold_gather,
    gather_micro,
    make_fold_train_step,
    stack_for_accum,
    steps_per_upload,
    to_device,
    upload_steps,
)

logger = logging.getLogger("meme_challenge_tpu_torch.fold_parallel")


def _check_equal_batch_counts(loaders, what: str) -> None:
    """The fold-parallel eval and export loops zip the folds' loaders and
    stop at the first exhausted one: unequal batch counts would drop the
    longer folds' tail batches, so they raise here."""
    counts = {len(loader) for loader in loaders}
    if len(counts) > 1:
        raise ValueError(
            f"{what} fold loaders have unequal batch counts {sorted(counts)}"
            " — the stacked [F, B, ...] eval would drop the longer folds'"
            " tail batches (training cycles unequal folds; eval cannot)")


def _order_only(loader):
    """A fold's batch stream that this rank does not train: it draws the
    loader's order (the host RNG draws of a real pass) and yields None for
    each batch."""
    loader._order()
    for _ in range(len(loader)):
        yield None


_ATTENTION = ("attention.self.query.weight", "attention.self.query.bias",
              "attention.self.key.weight", "attention.self.key.bias",
              "attention.self.value.weight", "attention.self.value.bias",
              "attention.output.dense.weight")
_FFN = ("intermediate.dense.weight", "intermediate.dense.bias",
        "output.dense.weight")


def _whole_blocks(specs: dict, config, model_size: int) -> dict:
    """Keep the ``model`` split of a layer's attention (its column and row
    products) only where all of them split and the axis divides the heads,
    and of its feed-forward only where both products split; else the block
    is whole on every rank, as ``filter_divisible_specs`` leaves a leaf."""
    out = dict(specs)
    for i in range(config.num_hidden_layers):
        p = "uniter_model.encoder.layer.%d." % i
        for block in (_ATTENTION, _FFN):
            names = [p + n for n in block]
            whole = not all("model" in specs[n] for n in names) or (
                block is _ATTENTION
                and config.num_attention_heads % model_size)
            if whole:
                for n in names:
                    out[n] = {a: v for a, v in specs[n].items()
                              if a != "model"}
    return out


def _fold_probs(logits: torch.Tensor, loss_func: str) -> torch.Tensor:
    """Probabilities of fold-stacked logits ``[F, B, C]``: fp32 softmax over
    classes for ``ce``, else the sigmoid of class 0 (``[F, B]``)."""
    if loss_func == "ce":
        return torch.softmax(logits.float(), dim=-1)
    return torch.sigmoid(logits[..., 0].float())


class FoldParallelTrainer:
    """Train the F folds of one model at once, on one device or over a
    ``torch.distributed`` mesh.

    Parameters
    ----------
    config : TrainConfig
    model : FoldStack (all F folds' parameters ``[F, ...]``, on the device;
        over a mesh each rank keeps its part of them)
    train_loaders / val_loaders : one BatchLoader per fold, all F folds on
        every rank (equal val lengths; unequal train lengths cycle)
    mesh : optional ``parallel.mesh.Mesh`` with a ``fold`` axis (and
        ``data``, ``model``); one of one process runs as without one
    """

    def __init__(self, config: TrainConfig, model, train_loaders: List,
                 val_loaders: List, mesh: Optional[Mesh] = None):
        self.config = config
        self.device = model.device
        self.train_loaders = train_loaders
        self.val_loaders = val_loaders
        self.num_folds = len(train_loaders)
        if not len(val_loaders) == self.num_folds == model.folds:
            raise ValueError("%d train loaders, %d val loaders, %d folds of "
                             "weights" % (self.num_folds, len(val_loaders),
                                          model.folds))
        self.mesh = (mesh if mesh is not None and mesh.device_mesh is not None
                     else None)
        self.folds_here = list(range(self.num_folds))
        self.specs = None
        self.data_rank, self.data_size = 0, 1
        if self.mesh is not None:
            model = self._shard_state(model)
        self.model = model
        # one rank of each fold's data and model group writes its exports
        self.writes_exports = (self.mesh is None or (
            self.mesh.coordinate("data") == 0
            and self.mesh.coordinate("model") == 0))
        lengths = {len(loader) for loader in train_loaders}
        if len(lengths) > 1:
            logger.warning(
                "fold train loaders have unequal lengths %s; each epoch "
                "runs max(%i) steps per fold, shorter folds cycle",
                sorted(lengths), max(lengths))
        # val loaders cannot cycle (eval sees every sample once): fail at
        # construction, not after the first epoch
        _check_equal_batch_counts(val_loaders, "val")

        c = config
        self.loss_fn = make_loss_fn(c.loss_func, c.pos_wt)
        total_steps = len(train_loaders[0]) * c.max_epoch
        self.schedule = make_schedule(
            c.scheduler, warmup_steps=c.warmup_steps, total_steps=total_steps,
            lr_decay_step=c.lr_decay_step, lr_decay_factor=c.lr_decay_factor)
        split = model.split
        self.optimizer = Optimizer(
            c.optimizer, c.lr, self.schedule, beta1=c.beta1, beta2=c.beta2,
            weight_decay=c.weight_decay, max_grad_norm=c.max_grad_norm,
            mu_dtype=c.adam_mu_dtype, nu_dtype=c.adam_nu_dtype,
            folds=model.folds,
            split=None if split is None else (set(split.dims), split.group))
        # the folds step in lockstep: one step count serves them all
        self.state = TrainState(model, self.optimizer.init(model.params))
        self.best_params = {k: v.detach().clone()
                            for k, v in model.params.items()}

        # device-resident data: index-mode loaders → the folds' union
        # corpus uploaded once plus a per-fold row table; per step only
        # [F, accum, B] indices cross the host link
        self._gather = bool(getattr(train_loaders[0], "index_batches",
                                    False))
        if any(bool(getattr(loader, "index_batches", False)) != self._gather
               for loader in train_loaders + val_loaders):
            raise ValueError("mix of index-mode and host-batch fold loaders")
        # staged-upload cache: repeated passes over the same loaders
        # (per-epoch eval, end-of-training exports) reuse the resident
        # corpus. Entries hold the datasets too, so the id()-based keys
        # cannot be recycled while cached.
        self._data_cache: dict = {}
        self._train_data = (self._stack_fold_data(self._here(train_loaders))
                            if self._gather else None)
        self._val_data = (self._stack_fold_data(self._here(val_loaders))
                          if self._gather else None)
        self._train_step = make_fold_train_step(
            model, self.loss_fn, self.optimizer,
            accum_steps=c.gradient_accumulation, gather_data=self._gather,
            fuse_accum=c.fuse_accum,
            data_group=(self.mesh.group("data") if self.mesh is not None
                        else None))

        self.start_epoch = 1
        self.best_metric = np.full(
            self.num_folds,
            np.inf if c.optimize_for == "loss" else -np.inf)
        self.not_improved = np.zeros(self.num_folds, dtype=np.int64)
        self.done = np.zeros(self.num_folds, dtype=bool)
        self.fold_val_metrics: List[Dict[str, float]] = [
            {} for _ in range(self.num_folds)]

    # ----------------------------------------------------------------- mesh

    def _shard_state(self, model: FoldStack) -> FoldStack:
        """This rank's part of the fold-stacked model (JAX ``_shard_state``
        :322-365): its folds, and with a ``model`` axis its slices of the
        leaves that ``uniter_param_specs`` split (after
        ``filter_divisible_specs`` and :func:`_whole_blocks`)."""
        mesh, F_ = self.mesh, self.num_folds
        n_fold, r = mesh.axis_size("fold"), mesh.coordinate("fold")
        if "fold" not in mesh.axis_names or F_ % n_fold:
            raise ValueError(
                "%d folds do not split evenly over a fold axis of %d: the "
                "fold count must be a multiple of the mesh's fold axis (JAX "
                "device_put of a fold-sharded array raises alike)"
                % (F_, n_fold))
        per = F_ // n_fold
        self.folds_here = list(range(r * per, (r + 1) * per))
        self.data_rank = mesh.coordinate("data")
        self.data_size = mesh.axis_size("data")
        n_model = mesh.axis_size("model")
        specs = uniter_param_specs(model.params, "model", fold_axis="fold")
        specs = filter_divisible_specs(mesh, model.params, specs)
        self.specs = _whole_blocks(specs, model.config, n_model)
        params = {k: v.detach() for k, v in model.params.items()}
        local = {k: v.to_local().contiguous() for k, v in apply_shardings(
            mesh, params, self.specs).items()}
        dims = {k: spec["model"].dim for k, spec in self.specs.items()
                if "model" in spec}
        split = (ModelSplit(mesh.group("model"), mesh.coordinate("model"),
                            n_model, dims)
                 if n_model > 1 and dims else None)
        return FoldStack(model.config, model.n_classes, local, split)

    def _here(self, per_fold: list) -> list:
        """This rank's entries of a list over all F folds."""
        return [per_fold[f] for f in self.folds_here]

    def _local_tree(self, tree):
        """A state tree of whole ``[F, ...]`` tensors (keyed by parameter
        name, as ``self.specs``) cut to this rank's part."""
        if self.mesh is None:
            return tree_to(tree, self.device)
        if isinstance(tree, dict) and set(tree) == set(self.specs):
            return {k: v.to_local().contiguous() for k, v in apply_shardings(
                self.mesh, tree_to(tree, self.device), self.specs).items()}
        if isinstance(tree, dict):
            return {k: self._local_tree(v) for k, v in tree.items()}
        return tree

    def _whole_tree(self, tree):
        """This rank's part of a state tree keyed by parameter name,
        gathered into the whole ``[F, ...]`` tensors on the host (a
        collective: every rank of the mesh calls it)."""
        if self.mesh is None:
            return tree_to(tree, "cpu")
        from torch.distributed.tensor import DTensor

        if isinstance(tree, dict) and set(tree) == set(self.specs):
            return {k: DTensor.from_local(
                v.detach(), self.mesh.device_mesh, placements(self.mesh,
                                                     self.specs[k]),
                run_check=False).full_tensor().cpu()
                for k, v in tree.items()}
        if isinstance(tree, dict):
            return {k: self._whole_tree(v) for k, v in tree.items()}
        return tree

    def _all_folds(self, mine: list) -> list:
        """Per-fold host values of this rank's folds → those of all F
        folds, in fold order (all-gathered over the fold axis)."""
        group = None if self.mesh is None else self.mesh.group("fold")
        if group is None:
            return list(mine)
        parts = [None] * dist.get_world_size(group)
        dist.all_gather_object(parts, list(mine), group=group)
        return [x for part in parts for x in part]

    # ------------------------------------------------------------------ data

    def _stack_fold_data(self, loaders):
        """Shared union corpus + per-fold index translation:
        ``({key: [N_union, ...]}, [F, N_max])`` on the device.

        The folds' train splits overlap (F−1)/F, so per-fold copies would
        take about F times the memory: the union of the folds' rows (deduped
        by meme id; rows of one id are identical across folds) uploads
        once, and each fold carries an ``[N_max]`` local→global row table
        (padding slots point at row 0 and are never selected). Disjoint
        fold datasets degenerate to concatenation."""
        datasets = [loader.dataset for loader in loaders]
        key = ("stack",) + tuple(map(id, datasets))
        cached = self._data_cache.get(key)
        if cached is not None:
            return cached[1]
        n_max = max(len(d) for d in datasets)
        global_row: dict = {}
        new_rows_per_fold = []
        table = np.zeros((len(datasets), n_max), np.int64)
        for f, d in enumerate(datasets):
            new_rows = []
            for local, id_ in enumerate(d.ids.tolist()):
                g = global_row.get(id_)
                if g is None:
                    g = len(global_row)
                    global_row[id_] = g
                    new_rows.append(local)
                table[f, local] = g
            new_rows_per_fold.append(np.asarray(new_rows, np.int64))
        arrays = [d.device_arrays() for d in datasets]
        shared = {k: np.concatenate(
            [a[k][rows] for a, rows in zip(arrays, new_rows_per_fold)
             if rows.size])
            for k in arrays[0]}
        data = (to_device(shared, self.device, keys=shared),
                torch.from_numpy(table).to(self.device))
        self._data_cache[key] = (datasets, data)
        return data

    def _shared_data(self, loader):
        """One loader's dataset, uploaded once (cached), for the
        shared-loader export."""
        key = ("shared", id(loader.dataset))
        cached = self._data_cache.get(key)
        if cached is None:
            arrays = loader.dataset.device_arrays()
            cached = ([loader.dataset],
                      to_device(arrays, self.device, keys=arrays))
            self._data_cache[key] = cached
        return cached[1]

    def _batch_keys(self, train: bool) -> tuple:
        keys = ("indices",) if self._gather else MODEL_INPUT_KEYS
        return keys + TRAIN_KEYS if train else keys

    # ----------------------------------------------------------------- train

    def _fold_device_batches(self):
        """Zip the fold loaders into ``[F, accum, micro_bs, ...]`` numpy
        batches.

        Folds march in lockstep for ``ceil(max(len(loader)) / accum)``
        steps an epoch; a fold whose stream runs out restarts it (cycles),
        so longer folds never drop tail batches and a trailing partial
        accumulation group is topped up rather than dropped."""
        accum = self.config.gradient_accumulation
        steps = max(-(-max(len(loader) for loader in self.train_loaders)
                      // accum), 1)
        here = set(self.folds_here)

        def stream(f):
            loader = self.train_loaders[f]
            return iter(loader) if f in here else _order_only(loader)

        iters = [stream(f) for f in range(self.num_folds)]

        def next_micro(f):
            try:
                return next(iters[f])
            except StopIteration:
                iters[f] = stream(f)
                return next(iters[f])

        for _ in range(steps):
            fold_groups = []
            for f in range(self.num_folds):
                group = [next_micro(f) for _ in range(accum)]
                if f in here:
                    fold_groups.append(stack_for_accum(
                        [self._my_rows(b) for b in group]))
            yield {k: np.stack([g[k] for g in fold_groups], axis=0)
                   for k in fold_groups[0]}

    def _my_rows(self, batch: dict) -> dict:
        """This rank's rows of a micro-batch (all of them without a data
        axis), without its ids."""
        batch = {k: v for k, v in batch.items() if k != "ids"}
        if self.data_size == 1:
            return batch
        n = len(batch["sample_mask"])
        if n % self.data_size:
            raise ValueError("a micro-batch of %d rows does not split over "
                             "a data axis of %d" % (n, self.data_size))
        rows = n // self.data_size
        r0 = self.data_rank * rows
        return {k: v[r0:r0 + rows] for k, v in batch.items()}

    def _step(self, batch: Dict[str, torch.Tensor]):
        generators = fold_dropout_generators(
            self.config.seed, self.folds_here, self.state.step, self.device)
        if self.data_size > 1:
            rows = batch["sample_mask"].shape[-1]
            generators = ShardedGenerators(generators, self.data_rank * rows,
                                           self.data_size * rows)
        self.state, out = self._train_step(self.state, batch, generators,
                                           self._train_data)
        return out["loss"]

    def train_main(self, checkpoint_path: Optional[str] = None
                   ) -> List[Dict[str, float]]:
        """``checkpoint_path``: if set, the trainer's whole state is saved there
        after every epoch (kill-and-resume via :meth:`load_checkpoint`)."""
        c = self.config
        start = time.time()
        if bool(self.done.all()):
            # resumed a run whose folds all stopped early
            logger.info("[fold-parallel] all %i folds already done; "
                        "skipping training", self.num_folds)
            return self.fold_val_metrics
        K = steps_per_upload(c, self._gather)
        keys = self._batch_keys(train=True)
        for epoch in range(self.start_epoch, c.max_epoch + 1):
            epoch_start = time.perf_counter()
            losses, memes = [], 0
            for group in chunk_batches(self._fold_device_batches(), K):
                memes += sum(int(h["sample_mask"].sum()) for h in group)
                for batch in upload_steps(group, self.device, keys):
                    losses.append(self._step(batch))
            # the epoch's one host sync
            loss = float(torch.stack(losses).float().mean().cpu())
            seconds = time.perf_counter() - epoch_start
            logger.info("train epoch %d: %d memes in %.6f s (%.1f memes/s)",
                        epoch, memes, seconds, memes / max(seconds, 1e-12))
            logger.info("[fold-parallel] epoch %d: %d steps of %d folds x "
                        "%d micro-batches, mean train loss %.4f", epoch,
                        len(losses), len(self.folds_here),
                        c.gradient_accumulation, loss)

            metrics_per_fold = self.eval_folds()
            self._early_stopping_update(metrics_per_fold)
            mean_auc = float(np.mean(
                [m.get("aucroc", -1) for m in metrics_per_fold]))
            logger.info(
                "[fold-parallel] epoch %i/%i mean_val_auc=%.4f done=%i/%i "
                "(%.1fs)", epoch, c.max_epoch, mean_auc,
                int(self.done.sum()), self.num_folds, time.time() - start)
            if checkpoint_path:
                self.save_checkpoint(checkpoint_path, epoch + 1)
            if bool(self.done.all()):
                break
        return self.fold_val_metrics

    # ------------------------------------------------------------------ eval

    def _forward_probs(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.inference_mode():
            return _fold_probs(self.model(batch), self.config.loss_func)

    def _stacked_pass(self, loaders, data, name: str, keep: str):
        """One pass over per-fold loaders in lockstep: ``[F, B, ...]``
        batches, one forward of all folds each. Returns per-fold lists of
        (probabilities, ``keep`` values) of the valid samples."""
        _check_equal_batch_counts(loaders, name)
        keys = self._batch_keys(train=False)
        pipe = EvalPipeline(window=None if self._gather
                            else EVAL_INFLIGHT_WINDOW)
        host_batches = []
        t0 = time.perf_counter()
        for batches in zip(*loaders):
            stacked = {k: np.stack([np.asarray(b[k]) for b in batches])
                       for k in keys if k in batches[0]}
            batch = to_device(stacked, self.device, keys=keys)
            if data is not None:
                batch = fold_gather(data, batch)
            pipe.add(self._forward_probs(batch))
            # masks and the kept values only (the features are uploaded)
            host_batches.append([(np.asarray(b["sample_mask"]).astype(bool),
                                  np.asarray(b[keep])) for b in batches])
        probs_per_fold = [[] for _ in range(len(loaders))]
        kept_per_fold = [[] for _ in range(len(loaders))]
        for probs, batches in zip(pipe.results(), host_batches):
            for f, (mask, kept) in enumerate(batches):
                probs_per_fold[f].append(probs[f][mask])
                kept_per_fold[f].append(kept[mask])
        self._log_pass(name, len(host_batches), sum(
            int(m.sum()) for bs in host_batches for m, _ in bs),
            time.perf_counter() - t0)
        return ([np.concatenate(p) for p in probs_per_fold],
                [np.concatenate(k) for k in kept_per_fold])

    def _log_pass(self, name: str, n_batches: int, memes: int,
                  seconds: float) -> None:
        logger.info("fold-parallel pass %s: %d batches of %d folds, %d "
                    "memes in %.6f s (%.1f memes/s)", name, n_batches,
                    len(self.folds_here), memes, seconds,
                    memes / max(seconds, 1e-12))

    def eval_folds(self) -> List[Dict[str, float]]:
        """Fold-parallel validation: batches stacked ``[F, B, ...]``;
        metrics per fold, with the host criterion loss over all samples.
        Over a mesh, each rank evaluates its folds and the metrics of all
        F are all-gathered."""
        probs_per_fold, labels_per_fold = self._stacked_pass(
            self._here(self.val_loaders), self._val_data, "val", "labels")
        out = []
        c = self.config
        for probs, labels in zip(probs_per_fold, labels_per_fold):
            m = standard_metrics(probs, labels, add_optimal_acc=True)
            # host-side criterion loss so optimize_for="loss" works
            eps = 1e-7
            p = np.clip(probs, eps, 1 - eps)
            if c.loss_func == "ce" and p.ndim == 2:
                m["loss"] = float(
                    -np.log(p[np.arange(len(labels)), labels]).mean())
            else:
                y = labels.astype(np.float64)
                w = c.pos_wt if c.loss_func == "bce_logits" else 1.0
                m["loss"] = float(-(w * y * np.log(p)
                                    + (1 - y) * np.log(1 - p)).mean())
            out.append(m)
        return self._all_folds(out)

    def _early_stopping_update(self, metrics_per_fold) -> None:
        """Per-fold early stopping (reference train_template.py:221-241
        semantics, vectorized over folds) and the device-side best
        snapshot."""
        c = self.config
        values = np.array([m[c.optimize_for] for m in metrics_per_fold])
        sign = -1.0 if c.optimize_for == "loss" else 1.0
        diff = sign * (values - self.best_metric)
        # a stopped fold is frozen: no snapshot, no patience changes
        improved = (diff > 0) & ~self.done
        for f in np.where(improved)[0]:
            self.fold_val_metrics[f] = metrics_per_fold[f]
        self.best_metric = np.where(improved, values, self.best_metric)
        below = (diff < c.early_stop_thresh) & ~self.done
        self.not_improved = np.where(below, self.not_improved + 1,
                                     np.where(~self.done, 0,
                                              self.not_improved))
        self.done = self.done | (self.not_improved >= c.patience)
        improved = improved[self.folds_here]
        if improved.any():
            idx = torch.as_tensor(np.where(improved)[0], device=self.device)
            with torch.no_grad():
                for k, best in self.best_params.items():
                    best.index_copy_(0, idx,
                                     self.model.params[k].index_select(0, idx))

    # --------------------------------------------------------- kill/resume

    def save_checkpoint(self, path: str, next_epoch: int) -> None:
        """The trainer's whole state in one torch file: parameters, optimizer
        state, per-fold step counts, the best snapshot, the per-fold
        early-stopping arrays, the next epoch, and (as a JSON string) the
        best-epoch metrics and the python and numpy host RNG states, which
        drive the loaders' shuffling. Written to ``path.tmp`` and moved over
        ``path``, so a kill mid-write keeps the previous file. Over a mesh
        every rank's part is gathered and rank 0 writes the file a
        one-process run writes."""
        t0 = time.perf_counter()
        params = self._whole_tree(self.model.params)
        opt_state = self._whole_tree(self.state.opt_state)
        best_params = self._whole_tree(self.best_params)
        if dist.is_initialized() and dist.get_rank() != 0:
            return
        py_state = random.getstate()
        np_state = np.random.get_state()
        meta_record = json.dumps({
            "fold_val_metrics": self.fold_val_metrics,
            "py_rng": [py_state[0], list(py_state[1]), py_state[2]],
            "np_rng": [np_state[0], np.asarray(np_state[1]).tolist(),
                       int(np_state[2]), int(np_state[3]),
                       float(np_state[4])],
        })
        payload = {
            "params": params,
            "opt_state": opt_state,
            "step": [int(self.state.step)] * self.num_folds,
            "best_params": best_params,
            "best_metric": torch.from_numpy(np.asarray(self.best_metric,
                                                       np.float64)),
            "not_improved": torch.from_numpy(self.not_improved),
            "done": torch.from_numpy(self.done),
            "next_epoch": int(next_epoch),
            "meta_record": meta_record,
        }
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        logger.info("[fold-parallel] resume file of %d folds saved: %.3f GB "
                    "in %.3f s", self.num_folds,
                    os.path.getsize(path) / 1e9, time.perf_counter() - t0)

    def load_checkpoint(self, path: str) -> None:
        """Resume from a file of :meth:`save_checkpoint`, whatever mesh
        wrote it: every rank reads it and keeps its part."""
        payload = torch.load(path, map_location="cpu", weights_only=True)
        with torch.no_grad():
            for k, v in self._local_tree(payload["params"]).items():
                self.model.params[k].copy_(v)
            for k, v in self._local_tree(payload["best_params"]).items():
                self.best_params[k].copy_(v)
        self.state.opt_state = self._local_tree(payload["opt_state"])
        steps = set(payload["step"])
        if len(steps) != 1:
            raise ValueError("folds at unequal steps %s" % payload["step"])
        self.state.step = steps.pop()
        self.best_metric = payload["best_metric"].numpy().copy()
        self.not_improved = payload["not_improved"].numpy().copy()
        self.done = payload["done"].numpy().copy()
        self.start_epoch = int(payload["next_epoch"])
        m = json.loads(payload["meta_record"])
        self.fold_val_metrics = m["fold_val_metrics"]
        v, st, gauss = m["py_rng"]
        random.setstate((v, tuple(st), gauss))
        name, keys, pos, has_g, cached = m["np_rng"]
        np.random.set_state((name, np.asarray(keys, np.uint32), pos, has_g,
                             cached))

    # -------------------------------------------------------------- exports

    def best_fold_params(self, fold_idx: int) -> Dict[str, torch.Tensor]:
        """Fold ``fold_idx``'s best MemeUniter ``state_dict``: views, or
        over a ``model`` axis its slices gathered from the model group (a
        collective of that group). ``fold_idx`` is a fold of this rank."""
        f = self.folds_here.index(fold_idx)
        sd = self.model.fold_state_dict(f, self.best_params)
        split = self.model.split
        if split is None:
            return sd
        for k, dim in split.dims.items():
            parts = [torch.empty_like(sd[k]) for _ in range(split.size)]
            dist.all_gather(parts, sd[k].contiguous(), group=split.group)
            sd[k] = torch.cat(parts, dim=dim - 1)
        return sd

    def predict_folds(self, loaders: List):
        """Per-fold (probabilities, ids) over per-fold loaders (one a fold,
        all F) with the best parameters: ``(probs_per_fold,
        ids_per_fold)``, for this rank's folds (``folds_here``).

        When every entry is the SAME loader object (a shared test set), each
        batch is uploaded once and broadcast over the fold axis on the
        device instead of stacking F identical copies."""
        pred_gather = bool(getattr(loaders[0], "index_batches", False))
        if pred_gather != self._gather:
            raise ValueError("predict loaders must match the trainer's "
                             "batch mode (index_batches)")
        if len(loaders) > 1 and all(loader is loaders[0]
                                    for loader in loaders):
            return self._predict_shared(loaders[0])
        _check_equal_batch_counts(loaders, "predict")
        loaders = self._here(loaders)
        pred_data = self._stack_fold_data(loaders) if pred_gather else None
        live, self.model.params = self.model.params, self.best_params
        try:
            return self._stacked_pass(loaders, pred_data,
                                      loaders[0].dataset.name, "ids")
        finally:
            self.model.params = live

    def _predict_shared(self, loader):
        """Shared-loader export: iterate the loader once, upload each batch
        once, and evaluate every fold on it (the batch expanded over the
        fold axis on the device)."""
        data = self._shared_data(loader) if self._gather else None
        keys = self._batch_keys(train=False)
        live, self.model.params = self.model.params, self.best_params
        try:
            pipe = EvalPipeline(window=None if self._gather
                                else EVAL_INFLIGHT_WINDOW)
            masks, ids_chunks = [], []
            t0 = time.perf_counter()
            for b in loader:
                batch = to_device(b, self.device, keys=keys)
                if data is not None:
                    batch = gather_micro(data, batch)
                batch = {k: v.unsqueeze(0).expand((self.model.folds,)
                                                  + tuple(v.shape))
                         for k, v in batch.items() if k in MODEL_INPUT_KEYS}
                pipe.add(self._forward_probs(batch))  # [F, B]
                mask = np.asarray(b["sample_mask"]).astype(bool)
                masks.append(mask)
                ids_chunks.append(np.asarray(b["ids"])[mask])
            probs_cat = np.concatenate(
                [p[:, m] for p, m in zip(pipe.results(), masks)], axis=1)
            ids_cat = np.concatenate(ids_chunks)
            self._log_pass(loader.dataset.name, len(masks),
                           self.model.folds * len(ids_cat),
                           time.perf_counter() - t0)
            return ([probs_cat[f] for f in range(self.model.folds)],
                    [ids_cat.copy() for _ in range(self.model.folds)])
        finally:
            self.model.params = live
