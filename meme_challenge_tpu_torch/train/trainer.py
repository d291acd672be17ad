"""Trainer lifecycle.

Counterpart of ``meme_challenge_tpu/train/trainer.py`` (reference
train_template.py + train_uniter.py):

- epochs over host micro-batches grouped into ``[accum, B, ...]`` device
  batches (steps.py); a final group that the loader leaves short is padded
  with zero-mask micro-batches and stepped, as in the JAX package;
- per-epoch train metrics and the weighted epoch loss, fetched from the
  device once per epoch; validation; early stopping on the monitored metric
  with patience and improvement threshold (train_template.py:221-241),
  saving the best weights;
- best-checkpoint reload → optimal threshold on validation → per-test-set
  exports (labelled sets get metrics and ``id,proba,label,gt`` CSVs,
  unlabelled sets leaderboard CSVs) → metrics JSON
  (train_template.py:287-354).

``--max_epoch 0`` runs no epoch: it serves an existing checkpoint, and the
metrics JSON equals the JAX package's (dev ``{"loss": 1000.0}``, train
``{"loss": 0.0}``). One log record per epoch, ``train epoch %d: %d memes in
%.6f s (%.1f memes/s)``, gives the training rate.
"""
from __future__ import annotations

import logging
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

from meme_challenge_tpu_torch.core.artifacts import (
    export_metrics_json,
    export_predictions,
)
from meme_challenge_tpu_torch.core.config import TrainConfig
from meme_challenge_tpu_torch.core.metrics import (
    find_optimal_threshold,
    standard_metrics,
)
from meme_challenge_tpu_torch.core.seeding import dropout_generator
from meme_challenge_tpu_torch.data.meme_dataset import BatchLoader
from meme_challenge_tpu_torch.train.checkpoint import ModelSaver
from meme_challenge_tpu_torch.train.losses import make_loss_fn
from meme_challenge_tpu_torch.train.observability import span
from meme_challenge_tpu_torch.train.optim import Optimizer
from meme_challenge_tpu_torch.train.schedules import make_schedule
from meme_challenge_tpu_torch.train.steps import (
    EVAL_INFLIGHT_WINDOW,
    MODEL_INPUT_KEYS,
    TRAIN_KEYS,
    EvalPipeline,
    chunk_batches,
    create_train_state,
    make_eval_step,
    make_train_multi_step,
    make_train_step,
    sigmoid_probs,
    softmax_probs,
    stack_chunk,
    stack_for_accum,
    to_device,
)

logger = logging.getLogger("meme_challenge_tpu_torch.train")


def _np_batch_loss(probs: np.ndarray, labels: np.ndarray, loss_func: str,
                   pos_wt: float) -> float:
    """Host-side eval loss from probabilities (reference logs criterion loss
    per eval batch, train_template.py:131-152)."""
    eps = 1e-7
    p = np.clip(probs, eps, 1 - eps)
    if loss_func == "ce":
        return float(-np.log(p[np.arange(len(labels)), labels]).mean())
    y = labels.astype(np.float64)
    w = pos_wt if loss_func == "bce_logits" else 1.0
    return float(-(w * y * np.log(p) + (1 - y) * np.log(1 - p)).mean())


class Trainer:
    """Host orchestration around the train and eval steps.

    Parameters
    ----------
    config : TrainConfig
    model : MemeUniter (``forward(batch, deterministic, generator)`` →
        logits), on ``device``; trained in place
    train_loader / val_loader / test_loaders : BatchLoader instances
    update_scales : optional per-parameter update scales (optim.py)
    """

    def __init__(
        self,
        config: TrainConfig,
        model: torch.nn.Module,
        train_loader: Optional[BatchLoader],
        val_loader: Optional[BatchLoader],
        test_loaders: Optional[List[BatchLoader]] = None,
        update_scales=None,
    ):
        self.config = config
        self.model = model.eval()
        self.device = next(model.parameters()).device
        self.test_loaders = test_loaders or []
        self.train_loader = train_loader
        self.val_loader = val_loader

        c = config
        self.model_file = os.path.join(c.model_path, c.model_save_name)
        self.saver = ModelSaver(self.model_file)
        self.loss_fn = make_loss_fn(c.loss_func, c.pos_wt)
        total_steps = (len(train_loader) * c.max_epoch) if train_loader else 1
        self.schedule = make_schedule(
            c.scheduler, warmup_steps=c.warmup_steps, total_steps=total_steps,
            lr_decay_step=c.lr_decay_step, lr_decay_factor=c.lr_decay_factor)
        self.optimizer = Optimizer(
            c.optimizer, c.lr, self.schedule, beta1=c.beta1, beta2=c.beta2,
            weight_decay=c.weight_decay, max_grad_norm=c.max_grad_norm,
            update_scales=update_scales, mu_dtype=c.adam_mu_dtype,
            nu_dtype=c.adam_nu_dtype)
        self.state = create_train_state(self.model, self.optimizer)

        # device-resident data (steps.gather_micro): index-mode loaders
        # upload their dataset once; detected per loader
        self._gather_train = bool(getattr(train_loader, "index_batches",
                                          False))
        self.train_step = make_train_step(
            self.model, self.loss_fn, self.optimizer,
            accum_steps=c.gradient_accumulation,
            gather_data=self._gather_train, fuse_accum=c.fuse_accum)
        # K steps per chunk, run as a plain loop with the numbers of single
        # steps (steps.make_train_multi_step); auto as in the JAX package
        self.steps_per_dispatch = c.steps_per_dispatch or (
            8 if self._gather_train else 1)
        self.train_multi_step = make_train_multi_step(
            self.train_step, c.seed, self.device)
        probs_fn = softmax_probs if c.loss_func == "ce" else sigmoid_probs
        self._eval_steps = {
            False: make_eval_step(self.model, probs_fn),
            True: make_eval_step(self.model, probs_fn, gather_data=True),
        }
        self._dataset_device_cache: Dict[int, tuple] = {}

        # early-stopping state (reference train_template.py:29-36)
        self.best_val_metrics: Dict[str, float] = defaultdict(int)
        self.best_val_loss = 1000.0
        self.not_improved = 0
        self.terminate_training = False
        self.train_metrics: Dict[str, float] = {}
        self.train_loss = 0.0
        self.test_metrics: Dict[str, dict] = {}
        self.total_iters = 0
        self.scalars: List[tuple] = []  # (name, step, value) log
        self.writer = None
        if c.vis_path:
            from meme_challenge_tpu_torch.train.observability import (
                ScalarWriter,
            )

            self.writer = ScalarWriter(
                os.path.join(c.vis_path, c.model_save_name.rsplit(".", 1)[0]))

    # ------------------------------------------------------------------ data

    def _data_for(self, loader) -> Optional[dict]:
        """Device-resident dataset arrays for an index-mode loader (uploaded
        once per dataset, cached); None for host-batch loaders."""
        if not getattr(loader, "index_batches", False):
            return None
        key = id(loader.dataset)
        if key not in self._dataset_device_cache:
            # pin the dataset object in the entry: a recycled id() of a
            # freed dataset must not hit a stale entry
            arrays = loader.dataset.device_arrays()
            self._dataset_device_cache[key] = (
                loader.dataset, to_device(arrays, self.device, keys=arrays))
        return self._dataset_device_cache[key][1]

    def _device_batch(self, batch: dict, gather: bool) -> dict:
        if gather:
            return to_device(batch, self.device, keys=("indices",))
        return to_device(batch, self.device)

    def _device_batches(self, loader: BatchLoader):
        """Group host micro-batches into [accum, ...] numpy batches; a short
        final group is padded with zero-mask copies of its last batch."""
        accum = self.config.gradient_accumulation
        group: List[dict] = []
        for batch in loader:
            batch = dict(batch)
            batch.pop("ids", None)
            group.append(batch)
            if len(group) == accum:
                yield stack_for_accum(group)
                group = []
        if group:
            pad = dict(group[-1])
            pad["sample_mask"] = np.zeros_like(pad["sample_mask"])
            while len(group) < accum:
                group.append(pad)
            yield stack_for_accum(group)

    # ------------------------------------------------------------------ train

    def train_main(self):
        c = self.config
        logger.info("Beginning training: %s", c.model_save_name)
        start = time.time()
        keys = (("indices",) if self._gather_train
                else MODEL_INPUT_KEYS) + TRAIN_KEYS
        for epoch in range(1, c.max_epoch + 1):
            losses, epoch_probs, epoch_labels, epoch_masks = [], [], [], []
            epoch_start = time.perf_counter()
            n_steps = 0
            train_data = self._data_for(self.train_loader)

            def run(kind, host):
                nonlocal n_steps
                batch = to_device(host, self.device, keys=keys)
                if kind == "chunk":
                    self.state, out = self.train_multi_step(
                        self.state, batch, train_data)
                else:
                    gen = dropout_generator(c.seed, self.state.step,
                                            self.device)
                    self.state, out = self.train_step(self.state, batch, gen,
                                                      train_data)
                # device tensors stay in flight; fetched once per epoch
                losses.append(out["loss"].reshape(-1))
                epoch_probs.append(out["probs"])
                epoch_labels.append(host["labels"].reshape(-1))
                epoch_masks.append(host["sample_mask"])
                k = len(host["labels"]) if kind == "chunk" else 1
                n_steps += k
                self.total_iters += k * c.gradient_accumulation

            stream = self._device_batches(self.train_loader)
            if self.steps_per_dispatch > 1:
                for kind, x in chunk_batches(stream, self.steps_per_dispatch):
                    run(kind, stack_chunk(x) if kind == "chunk" else x)
            else:
                for x in stream:
                    run("single", x)

            # one host sync for the epoch
            n_cls = (epoch_probs[0].shape[-1]
                     if c.loss_func == "ce" else None)
            with span("meme.train.fetch"):
                loss_flat = torch.cat(losses).cpu().numpy()
                probs = torch.cat([p.reshape(-1, n_cls) if n_cls
                                   else p.reshape(-1)
                                   for p in epoch_probs]).cpu().numpy()
            seconds = time.perf_counter() - epoch_start
            labels = np.concatenate(epoch_labels)
            masks = np.concatenate([m.reshape(-1) for m in epoch_masks])
            valid = masks.astype(bool)
            n_memes = int(valid.sum())
            logger.info("train epoch %d: %d memes in %.6f s (%.1f memes/s)",
                        epoch, n_memes, seconds,
                        n_memes / max(seconds, 1e-12))
            self.scalars.append(("Stats/time_per_train_iter",
                                 self.total_iters,
                                 seconds / (n_steps * c.gradient_accumulation)))
            self.scalars.append(("Stats/learning_rate", self.total_iters,
                                 c.lr * float(self.schedule(self.state.step))))
            self.train_metrics = standard_metrics(
                probs[valid], labels[valid], add_optimal_acc=True)
            # weight per-micro losses by their valid-sample counts so the
            # zero-mask padding of the final accumulation group does not
            # deflate the epoch loss
            count_flat = np.concatenate(
                [m.reshape(-1, m.shape[-1]).sum(-1) for m in epoch_masks])
            self.train_loss = float(np.average(
                loss_flat, weights=np.maximum(count_flat, 0) + 1e-9))

            val_t0 = time.time()
            self.val_metrics, self.val_loss = self.eval_model(self.val_loader)
            self.scalars.append(("Stats/time_validation", self.total_iters,
                                 time.time() - val_t0))
            # reference scalar names (utils/utils.py:25-60)
            self.scalars.append(("Train/Epoch_Loss", self.total_iters,
                                 self.train_loss))
            self.scalars.append(("Validation/Loss", epoch, self.val_loss))
            for k, v in self.val_metrics.items():
                self.scalars.append((f"Validation/{k}", epoch, v))
            for k, v in self.train_metrics.items():
                self.scalars.append((f"Train/{k}", epoch, v))

            logger.info(
                "Epoch %i/%i  train_loss=%.4f train_auc=%.4f  "
                "val_loss=%.4f val_auc=%.4f  (%.1fs)",
                epoch, c.max_epoch, self.train_loss,
                self.train_metrics.get("aucroc", -1), self.val_loss,
                self.val_metrics.get("aucroc", -1), time.time() - start)
            if self.writer is not None:
                self.writer.add_scalars(self.scalars)
                self.scalars.clear()
                self.writer.flush()

            self.check_early_stopping()
            if self.terminate_training:
                break
        return self.end_training()

    # ------------------------------------------------------------------- eval

    def _run_pass(self, loader: BatchLoader, keep_ids: bool):
        gather = bool(getattr(loader, "index_batches", False))
        step, data = self._eval_steps[gather], self._data_for(loader)
        pipe = EvalPipeline(window=None if gather else EVAL_INFLIGHT_WINDOW)
        masks, ids_list, labels_list = [], [], []
        t0 = time.perf_counter()
        for batch in loader:
            mask = batch["sample_mask"].astype(bool)
            pipe.add(step(self._device_batch(batch, gather), data))
            masks.append(mask)
            if keep_ids:
                ids_list.append(batch["ids"][mask])
            labels_list.append(batch["labels"][mask])
        probs_list = [p[m] for p, m in zip(pipe.results(), masks)]
        seconds = time.perf_counter() - t0
        n = int(sum(m.sum() for m in masks))
        logger.info("inference pass %s: %d memes in %.6f s (%.1f memes/s)",
                    loader.dataset.name, n, seconds, n / max(seconds, 1e-12))
        return probs_list, ids_list, labels_list

    def eval_model(self, loader: BatchLoader):
        probs_list, _, labels_list = self._run_pass(loader, keep_ids=False)
        probs = np.concatenate(probs_list)
        labels = np.concatenate(labels_list)
        metrics = standard_metrics(probs, labels, add_optimal_acc=True)
        # reference averages per-batch criterion means (train_template.py:146)
        batch_losses = [
            _np_batch_loss(p, l, self.config.loss_func, self.config.pos_wt)
            for p, l in zip(probs_list, labels_list)
        ]
        return metrics, float(np.mean(batch_losses))

    def predict(self, loader: BatchLoader):
        """Probabilities + ids + labels over a loader (reference export path)."""
        probs_list, ids_list, labels_list = self._run_pass(loader,
                                                           keep_ids=True)
        return (np.concatenate(probs_list), np.concatenate(ids_list),
                np.concatenate(labels_list))

    # --------------------------------------------------------- early stopping

    def check_early_stopping(self):
        """Reference train_template.py:221-241 semantics exactly."""
        c = self.config
        opt_for = c.optimize_for
        this_metric = (self.val_loss if opt_for == "loss"
                       else self.val_metrics[opt_for])
        current_best = (self.best_val_loss if opt_for == "loss"
                        else self.best_val_metrics[opt_for])
        new_best = (this_metric < current_best if opt_for == "loss"
                    else this_metric > current_best)
        if new_best:
            logger.info("New high score, saving model...")
            self.best_val_metrics = self.val_metrics
            self.best_val_loss = self.val_loss
            if not c.no_model_checkpoints:
                self.saver.save(self.model)
        diff = (current_best - this_metric if opt_for == "loss"
                else this_metric - current_best)
        if diff < c.early_stop_thresh:
            self.not_improved += 1
            if self.not_improved >= c.patience:
                self.terminate_training = True
        else:
            self.not_improved = 0
        logger.info("current patience: %i", self.not_improved)

    # ------------------------------------------------------------ end of run

    @staticmethod
    def _binary_probs(probs: np.ndarray) -> np.ndarray:
        """CSV/threshold export needs 1-D probabilities. Binary CE → p(class
        1); multiclass → max-class probability."""
        if probs.ndim == 1:
            return probs
        if probs.shape[1] == 2:
            return probs[:, 1]
        return probs.max(axis=1)

    @staticmethod
    def _discrete_preds(probs_raw: np.ndarray, threshold: float) -> np.ndarray:
        """Discrete labels for export: threshold for binary probabilities,
        argmax for ≥3-class softmax outputs."""
        if probs_raw.ndim == 2 and probs_raw.shape[1] > 2:
            return probs_raw.argmax(axis=1).astype(np.int64)
        return (Trainer._binary_probs(probs_raw) > threshold).astype(np.int64)

    def _csv_path(self, dataset_name: str) -> str:
        base = self.config.model_save_name.rsplit(".", 1)[0]
        return os.path.join(self.config.model_path,
                            base + "_%s_preds.csv" % dataset_name)

    def end_training(self):
        c = self.config
        if self.terminate_training:
            logger.info("Training terminated early (no %s improvement for "
                        "%i epochs)", c.optimize_for, c.patience)
        self.test_metrics = {}
        if not c.no_model_checkpoints and os.path.isfile(self.model_file):
            # reload best weights (reference train_template.py:298-303)
            self.saver.load(self.model)

            # optimal threshold on validation (train_template.py:304-310);
            # one inference pass serves both metrics and export
            val_probs_raw, val_ids, val_labels = self.predict(self.val_loader)
            val_probs = self._binary_probs(val_probs_raw)
            if not self.val_loader.dataset.return_ids:
                val_ids = np.zeros_like(val_labels) - 1
            binary = bool(np.all((val_labels == 0) | (val_labels == 1)))
            if binary:
                # the dev CSV exports labels at threshold 0.5 while test
                # exports use the optimal threshold — REFERENCE PARITY
                # (train_template.py:187 default + :305)
                threshold = find_optimal_threshold(val_probs, val_labels,
                                                   metric="accuracy")
                logger.info("Optimal threshold on validation: %.4f",
                            threshold)
            else:
                # >2 classes: thresholds are meaningless — exports use argmax
                threshold = 0.5
            export_predictions(
                self._csv_path(self.val_loader.dataset.name),
                val_ids, val_probs,
                self._discrete_preds(val_probs_raw, 0.5), labels=val_labels)

            for loader in self.test_loaders:
                name = loader.dataset.name
                probs_raw, ids, labels = self.predict(loader)
                probs = self._binary_probs(probs_raw)
                preds = self._discrete_preds(probs_raw, threshold)
                if loader.dataset.labels[0] == -1:
                    # unlabeled leaderboard export (train_template.py:157-192)
                    export_predictions(self._csv_path(name), ids, probs,
                                       preds)
                    self.test_metrics[name] = {}
                else:
                    self.test_metrics[name] = standard_metrics(
                        probs_raw, labels, add_optimal_acc=True)
                    export_predictions(self._csv_path(name), ids, probs,
                                       preds, labels=labels)
        else:
            logger.info("No model checkpoints were saved; skipping testing.")

        self.export_metrics()
        if self.writer is not None:
            self.writer.close()
        if c.remove_checkpoints and os.path.isfile(self.model_file):
            os.remove(self.model_file)
        return self.best_val_metrics, self.test_metrics

    def export_metrics(self):
        """Reference train_template.py:343-354."""
        base = self.config.model_save_name.rsplit(".", 1)[0]
        path = os.path.join(self.config.model_path, base + "_metrics.json")
        metric_dict = {
            "dev": dict(self.best_val_metrics, loss=self.best_val_loss),
            "train": dict(self.train_metrics, loss=self.train_loss),
        }
        if self.test_metrics:
            metric_dict["test"] = self.test_metrics
        export_metrics_json(path, metric_dict)
