"""Fold-parallel cross-validation driver.

Counterpart of ``meme_challenge_tpu/parallel/crossval_parallel.py``: the
replacement of the sequential ``train_crossval`` loop
(``train/crossval_driver.py``) in which all folds train at once
(``parallel/fold_parallel.py: FoldParallelTrainer``),
after which the per-fold artifacts come out as the sequential path names
them: the ``..._fold_i.<ext>`` best checkpoints, the
``..._fold_i_{set}_preds.csv`` files with per-fold optimal thresholds from
each fold's own validation split, the ``..._fold_i_metrics.json`` files,
and the ensemble search over the fold CSVs, on the trainer's device.

Over a ``torch.distributed`` mesh (``mesh=``, one process a device) every
rank runs this driver: rank 0 writes the fold splits, each rank exports
its own folds' checkpoints, CSVs and metrics under the paths a
one-process run uses (one rank of each fold's data and model group), and
after a barrier rank 0 alone runs the ensemble search and writes its
outputs.
"""
from __future__ import annotations

import logging
import os
from glob import glob
from statistics import mean
from typing import Callable, Dict, Optional

import numpy as np
import torch.distributed as dist

from meme_challenge_tpu_torch.core.artifacts import (
    export_metrics_json,
    export_predictions,
)
from meme_challenge_tpu_torch.core.config import TrainConfig
from meme_challenge_tpu_torch.core.device import resolve_device
from meme_challenge_tpu_torch.core.metrics import (
    find_optimal_threshold,
    standard_metrics,
)
from meme_challenge_tpu_torch.core.seeding import fold_seed, set_seed
from meme_challenge_tpu_torch.data.crossval_splits import (
    crossval_dir,
    generate_crossval_splits,
)
from meme_challenge_tpu_torch.ensemble.ensemble import find_ensemble
from meme_challenge_tpu_torch.models.uniter import FoldStack
from meme_challenge_tpu_torch.parallel.fold_parallel import (
    FoldParallelTrainer,
)
from meme_challenge_tpu_torch.parallel.mesh import Mesh
from meme_challenge_tpu_torch.train.checkpoint import ModelSaver

logger = logging.getLogger("meme_challenge_tpu_torch.crossval_parallel")


def train_crossval_fold_parallel(
    config: TrainConfig,
    init_model_fn: Callable,
    data_loader_funcs: Dict[str, Callable],
    test_loaders: Optional[list] = None,
    num_folds: int = -1,
    dev_size: int = 300,
    use_dev_set: bool = False,
    run_ensemble: bool = True,
    ea_generations: int = 100,
    run_ea: bool = True,
    resume_path: Optional[str] = None,
    device="cuda",
    mesh: Optional[Mesh] = None,
):
    """Train all crossval folds at once on ``device`` (over ``mesh``, this
    rank's part of them).

    ``init_model_fn(seed)`` → one fold's MemeUniter on ``device`` (each
    fold seeded ``fold_seed(seed, fold)`` as in the sequential driver); the
    folds are stacked one at a time into a ``FoldStack``. ``resume_path``:
    the resume file (the trainer's whole state), written after every epoch
    and, if present at start, loaded so a killed run resumes mid-crossval.
    """
    device = resolve_device(str(device))
    grouped = dist.is_initialized()
    lead = not grouped or dist.get_rank() == 0
    test_loaders = test_loaders or []
    cv_path = crossval_dir(config.data_path, dev_size, use_dev_set)
    if lead and (not os.path.isdir(cv_path)
                 or not glob(os.path.join(cv_path, "*.jsonl"))):
        generate_crossval_splits(config.data_path, dev_size=dev_size,
                                 use_dev_set=use_dev_set)
    if grouped:
        dist.barrier()
    train_sets = sorted(glob(os.path.join(cv_path, "train_??.jsonl")))
    dev_sets = sorted(glob(os.path.join(cv_path, "dev_??.jsonl")))
    fold_test_sets = sorted(glob(os.path.join(cv_path,
                                              "dev_seen_??.jsonl")))
    if num_folds == -1:
        num_folds = len(dev_sets)
    num_folds = min(num_folds, len(dev_sets))

    train_loaders, val_loaders = [], []
    for fold_idx in range(num_folds):
        set_seed(fold_seed(config.seed, fold_idx))
        train_loaders.append(data_loader_funcs["train"](train_sets[fold_idx]))
        val_loaders.append(data_loader_funcs["val"](dev_sets[fold_idx]))
    model = FoldStack.from_models(
        (init_model_fn(fold_seed(config.seed, f)) for f in range(num_folds)),
        num_folds)

    trainer = FoldParallelTrainer(config, model, train_loaders, val_loaders,
                                  mesh=mesh)
    del model
    mine, writes = trainer.folds_here, trainer.writes_exports
    if resume_path and os.path.isfile(resume_path):
        logger.info("[fold-parallel] resuming from %s", resume_path)
        trainer.load_checkpoint(resume_path)
    fold_val_metrics = trainer.train_main(checkpoint_path=resume_path)

    results = {"val_metrics": fold_val_metrics}
    mean_scores = {k: mean(v[k] for v in fold_val_metrics)
                   for k in fold_val_metrics[0]}
    results["mean_scores"] = mean_scores
    logger.info("[fold-parallel] mean validation scores: %s", mean_scores)

    # ---- per-fold exports, the sequential path's names ------------------
    base_name, base_ext = (config.model_save_name.rsplit(".", 1)
                           if "." in config.model_save_name
                           else (config.model_save_name, "ckpt"))

    def csv_path(fold_idx, set_name):
        return os.path.join(
            config.model_path,
            f"{base_name}_fold_{fold_idx}_{set_name}_preds.csv")

    # per-fold best checkpoints, the sequential names `*_fold_i.*`
    # (reference utils/crossval.py:185 / train_template ModelSaver path)
    # (this rank's folds: the results of predict_folds come in that order)
    if not config.no_model_checkpoints:
        for f in mine:
            state = trainer.best_fold_params(f)
            if writes:
                ModelSaver(os.path.join(
                    config.model_path,
                    f"{base_name}_fold_{f}.{base_ext}")).save(state)

    # per-fold optimal thresholds from each fold's validation split
    val_probs, _ = trainer.predict_folds(val_loaders)
    thresholds = {}
    for i, f in enumerate(mine):
        labels = val_loaders[f].dataset.labels
        probs = val_probs[i]
        thresholds[f] = find_optimal_threshold(
            probs, labels[:len(probs)], metric="accuracy")
        if writes:
            export_predictions(
                csv_path(f, val_loaders[f].dataset.name),
                val_loaders[f].dataset.ids[:len(probs)], probs,
                (probs > 0.5).astype(np.int64), labels=labels[:len(probs)])

    all_test_loaders = list(test_loaders)
    if use_dev_set:
        all_test_loaders = [t for t in all_test_loaders
                            if t.dataset.name != "dev_seen"]
        per_fold_tests = [data_loader_funcs["test"](fold_test_sets[f])
                          for f in range(num_folds)]
    else:
        per_fold_tests = None

    fold_test_metrics = {f: {} for f in mine}
    for loader in all_test_loaders:
        probs_by_fold, ids_by_fold = trainer.predict_folds(
            [loader] * num_folds)
        has_labels = loader.dataset.labels[0] != -1
        for i, f in enumerate(mine):
            probs = probs_by_fold[i]
            if writes:
                export_predictions(
                    csv_path(f, loader.dataset.name), ids_by_fold[i], probs,
                    (probs > thresholds[f]).astype(np.int64),
                    labels=(loader.dataset.labels[:len(probs)]
                            if has_labels else None))
            if has_labels:
                fold_test_metrics[f][loader.dataset.name] = standard_metrics(
                    probs, loader.dataset.labels[:len(probs)],
                    add_optimal_acc=True)
    if per_fold_tests is not None:
        # each fold has its OWN dev_seen_XX test split
        probs_by_fold, ids_by_fold = trainer.predict_folds(per_fold_tests)
        for i, f in enumerate(mine):
            probs, labels = probs_by_fold[i], per_fold_tests[f].dataset.labels
            if writes:
                export_predictions(
                    csv_path(f, per_fold_tests[f].dataset.name),
                    ids_by_fold[i], probs,
                    (probs > thresholds[f]).astype(np.int64),
                    labels=labels[:len(probs)])
            fold_test_metrics[f][per_fold_tests[f].dataset.name] = (
                standard_metrics(probs, labels[:len(probs)],
                                 add_optimal_acc=True))

    # per-fold metrics JSON, the sequential `*_fold_i_metrics.json` names
    # (reference train_template.py:343-354 schema: dev + test sections)
    for f in mine:
        if writes:
            export_metrics_json(
                os.path.join(config.model_path,
                             f"{base_name}_fold_{f}_metrics.json"),
                {"dev": fold_val_metrics[f], "test": fold_test_metrics[f]})

    if grouped:
        dist.barrier()  # every fold's CSVs are written
    if run_ensemble and lead:
        base_path = os.path.join(config.model_path, base_name + "_fold_*")
        if use_dev_set:
            dev_files = sorted(glob(base_path + "_dev_seen_??_preds.csv"))
            test_names = [t.dataset.name for t in all_test_loaders]
        else:
            dev_names = sorted(t.dataset.name for t in all_test_loaders
                               if t.dataset.name.startswith("dev"))
            if not dev_names:
                dev_files = []
                test_names = []
            else:
                dev_files = sorted(
                    glob(base_path + "_%s_preds.csv" % dev_names[0]))
                test_names = [t.dataset.name for t in all_test_loaders
                              if t.dataset.name != dev_names[0]]
        test_files = [sorted(glob(base_path + "_%s_preds.csv" % n))
                      for n in test_names]
        test_files = [tf for tf in test_files if tf]
        if dev_files:
            results["ensemble"] = find_ensemble(
                dev_files=dev_files, test_files=test_files,
                run_ea=run_ea, ea_generations=ea_generations,
                device=device)
    results["trainer"] = trainer
    return results
