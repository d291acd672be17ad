"""Cross-validation training driver.

Counterpart of ``meme_challenge_tpu/train/crossval_driver.py`` (reference
utils/crossval.py:132-215): ``num_folds == 0`` trains the default
train/dev_seen split; otherwise the fold splits are written if missing,
each fold trains from its own split files reseeded with ``seed + fold_idx``,
checkpoints and CSVs get ``_fold_i`` names, the mean validation metrics are
reported, and the per-fold prediction CSVs feed the ensemble search, which
runs on the trainer's device.

Here folds run one after another; ``parallel/crossval_parallel.py`` trains
them all at once (``--mesh_shape 1 --mesh_axes fold``).
"""
from __future__ import annotations

import logging
import os
from glob import glob
from statistics import mean
from typing import Callable, Dict, List, Optional

from meme_challenge_tpu_torch.core.config import TrainConfig
from meme_challenge_tpu_torch.core.device import resolve_device
from meme_challenge_tpu_torch.core.seeding import fold_seed, set_seed
from meme_challenge_tpu_torch.data.crossval_splits import (
    crossval_dir,
    generate_crossval_splits,
)
from meme_challenge_tpu_torch.ensemble.ensemble import find_ensemble

logger = logging.getLogger("meme_challenge_tpu_torch.crossval")


def train_crossval(
    trainer_factory: Callable,
    config: TrainConfig,
    data_loader_funcs: Dict[str, Callable],
    test_loaders: Optional[list] = None,
    num_folds: int = 0,
    dev_size: int = 300,
    use_dev_set: bool = False,
    run_ensemble: bool = True,
    ea_generations: int = 100,
    run_ea: bool = True,
    device="cuda",
):
    """Run single-split or per-fold training.

    ``trainer_factory(config, train_loader, val_loader, test_loaders)`` must
    return a Trainer whose ``train_main()`` yields (val_metrics, test_metrics).
    ``device`` is where the ensemble search runs: the trainers' device."""
    device = resolve_device(str(device))
    test_loaders = test_loaders or []
    if num_folds == 0:
        train_loader = data_loader_funcs["train"](
            os.path.join(config.data_path, "train.jsonl"))
        val_loader = data_loader_funcs["val"](
            os.path.join(config.data_path, "dev_seen.jsonl"))
        trainer = trainer_factory(config, train_loader, val_loader,
                                  test_loaders)
        return trainer.train_main()

    cv_path = crossval_dir(config.data_path, dev_size, use_dev_set)
    if not os.path.isdir(cv_path) or not glob(os.path.join(cv_path, "*.jsonl")):
        logger.info("Generating crossval splits (dev size %i)", dev_size)
        generate_crossval_splits(config.data_path, dev_size=dev_size,
                                 use_dev_set=use_dev_set)
    train_sets = sorted(glob(os.path.join(cv_path, "train_??.jsonl")))
    dev_sets = sorted(glob(os.path.join(cv_path, "dev_??.jsonl")))
    test_sets = sorted(glob(os.path.join(cv_path, "dev_seen_??.jsonl")))
    assert len(train_sets) == len(dev_sets), (
        "Unequal number of training and validation folds.")
    if num_folds == -1:
        num_folds = len(dev_sets)
    if use_dev_set:
        assert len(test_sets) >= num_folds, "Fewer test sets than expected."

    base_name, base_ext = (config.model_save_name.rsplit(".", 1)
                           if "." in config.model_save_name
                           else (config.model_save_name, "ckpt"))
    original_test_loaders = test_loaders
    if use_dev_set:
        # each fold tests on its own half of dev_seen instead
        original_test_loaders = [
            t for t in original_test_loaders if t.dataset.name != "dev_seen"]

    val_metrics: List[dict] = []
    folds_to_run = min(num_folds, len(dev_sets))
    try:
        for fold_idx in range(folds_to_run):
            set_seed(fold_seed(config.seed, fold_idx))
            logger.info("Starting fold %i of %i", fold_idx, folds_to_run)
            train_loader = data_loader_funcs["train"](train_sets[fold_idx])
            val_loader = data_loader_funcs["val"](dev_sets[fold_idx])
            if use_dev_set and len(test_sets) > fold_idx:
                fold_tests = original_test_loaders + [
                    data_loader_funcs["test"](test_sets[fold_idx])]
            else:
                fold_tests = original_test_loaders
            # the fold's seed reaches the trainer too, so weight init and
            # dropout vary per fold as the host RNGs do (reference
            # utils/crossval.py:174 reseeds everything per fold)
            fold_config = config.replace(
                model_save_name=base_name + "_fold_%i." % fold_idx + base_ext,
                seed=fold_seed(config.seed, fold_idx))
            trainer = trainer_factory(fold_config, train_loader, val_loader,
                                      fold_tests)
            fold_val_metrics, _ = trainer.train_main()
            val_metrics.append(dict(fold_val_metrics))
    except KeyboardInterrupt:
        # completed folds still feed the summary and the ensemble
        # (reference utils/crossval.py:191-196)
        logger.warning("Keyboard interrupt — stopping cross validation "
                       "after %i completed folds", len(val_metrics))

    results = {"val_metrics": val_metrics}
    if val_metrics:
        mean_scores = {k: mean(v[k] for v in val_metrics)
                       for k in val_metrics[0]}
        logger.info("Cross validation finished. Mean validation scores: %s",
                    mean_scores)
        results["mean_scores"] = mean_scores

        if run_ensemble:
            base_path = os.path.join(config.model_path, base_name + "_fold_*")
            # the dataset names only: the use_dev_set test set's name comes
            # from its file name, as MemeDataset derives it
            all_names = [t.dataset.name for t in original_test_loaders]
            if use_dev_set and test_sets:
                all_names.append(
                    test_sets[0].split("/")[-1].split(".")[0])
            dev_names = sorted(n for n in all_names if n.startswith("dev"))
            if not dev_names:
                logger.warning("Skipping ensemble: no dev predictions found")
            else:
                if not use_dev_set:
                    dev_files = sorted(
                        glob(base_path + "_%s_preds.csv" % dev_names[0]))
                    test_names = [n for n in all_names
                                  if n != dev_names[0]]
                else:
                    dev_files = sorted(
                        glob(base_path + "_dev_seen_??_preds.csv"))
                    test_names = [t.dataset.name
                                  for t in original_test_loaders]
                test_files = [sorted(glob(base_path + "_%s_preds.csv" % n))
                              for n in test_names]
                test_files = [tf for tf in test_files if tf]
                if dev_files:
                    results["ensemble"] = find_ensemble(
                        dev_files=dev_files, test_files=test_files,
                        run_ea=run_ea, ea_generations=ea_generations,
                        device=device)
    return results
