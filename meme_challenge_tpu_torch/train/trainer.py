"""Trainer lifecycle, inference half.

Counterpart of ``meme_challenge_tpu/train/trainer.py`` for the serving path
(reference README's ``--max_epoch 0`` inference command): reload the best
checkpoint → predictions on validation → optimal threshold → the validation
CSV at threshold 0.5 → per-test-set CSVs (labelled sets get metrics and a
``gt`` column) → metrics JSON (reference train_template.py:287-354).

``train_main`` with ``max_epoch 0`` runs no epoch and calls
:meth:`Trainer.end_training`, so the metrics JSON equals the JAX package's
(dev ``{"loss": 1000.0}``, train ``{"loss": 0.0}``). Training epochs come
with the training slice in ROADMAP.md; ``max_epoch > 0`` raises.
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
from meme_challenge_tpu_torch.data.meme_dataset import BatchLoader
from meme_challenge_tpu_torch.train.checkpoint import ModelSaver
from meme_challenge_tpu_torch.train.steps import (
    EVAL_INFLIGHT_WINDOW,
    EvalPipeline,
    make_eval_step,
    sigmoid_probs,
    softmax_probs,
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
    """Host orchestration around the model's eval forward.

    Parameters
    ----------
    config : TrainConfig
    model : MemeUniter (``forward(batch)`` → logits), on ``device``
    train_loader / val_loader / test_loaders : BatchLoader instances
    """

    def __init__(
        self,
        config: TrainConfig,
        model: torch.nn.Module,
        train_loader: Optional[BatchLoader],
        val_loader: Optional[BatchLoader],
        test_loaders: Optional[List[BatchLoader]] = None,
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
        probs_fn = softmax_probs if c.loss_func == "ce" else sigmoid_probs
        self._eval_steps = {
            False: make_eval_step(self.model, probs_fn),
            True: make_eval_step(self.model, probs_fn, gather_data=True),
        }
        self._dataset_device_cache: Dict[int, tuple] = {}

        # early-stopping state (reference train_template.py:29-36); without
        # epochs it keeps its initial values, which the metrics JSON reports
        self.best_val_metrics: Dict[str, float] = defaultdict(int)
        self.best_val_loss = 1000.0
        self.terminate_training = False
        self.train_metrics: Dict[str, float] = {}
        self.train_loss = 0.0
        self.test_metrics: Dict[str, dict] = {}
        if c.vis_path:
            logger.warning("--vis_path: scalar logs come with the training "
                           "slice; none are written")

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
            self._dataset_device_cache[key] = (
                loader.dataset,
                to_device(loader.dataset.device_arrays(), self.device))
        return self._dataset_device_cache[key][1]

    def _device_batch(self, batch: dict, gather: bool) -> dict:
        if gather:
            return to_device(batch, self.device, keys=("indices",))
        return to_device(batch, self.device)

    # ------------------------------------------------------------------ train

    def train_main(self):
        c = self.config
        if c.max_epoch > 0:
            raise NotImplementedError(
                "training epochs (max_epoch=%d) come with the training slice "
                "in ROADMAP.md; this slice serves --max_epoch 0 (inference "
                "from an existing checkpoint)" % c.max_epoch)
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
