"""Cross-validation training driver, single-split branch.

Counterpart of ``meme_challenge_tpu/train/crossval_driver.py``:
``num_folds == 0`` runs the default train/dev_seen split (reference
utils/crossval.py:132-215). The fold loop and the ensemble search come in a
later slice (ROADMAP.md); until then ``num_folds != 0`` raises.
"""
from __future__ import annotations

import os
from typing import Callable, Dict, Optional

from meme_challenge_tpu_torch.core.config import TrainConfig


def train_crossval(
    trainer_factory: Callable,
    config: TrainConfig,
    data_loader_funcs: Dict[str, Callable],
    test_loaders: Optional[list] = None,
    num_folds: int = 0,
    dev_size: int = 300,
    use_dev_set: bool = False,
):
    """Run the single-split path.

    ``trainer_factory(config, train_loader, val_loader, test_loaders)`` must
    return a Trainer whose ``train_main()`` yields (val_metrics, test_metrics).
    """
    del dev_size, use_dev_set  # fold-loop options
    if num_folds != 0:
        raise NotImplementedError(
            "num_folds=%d: the fold loop and the ensemble come in a later "
            "slice (ROADMAP.md); use --num_folds 0" % num_folds)
    test_loaders = test_loaders or []
    train_loader = data_loader_funcs["train"](
        os.path.join(config.data_path, "train.jsonl"))
    val_loader = data_loader_funcs["val"](
        os.path.join(config.data_path, "dev_seen.jsonl"))
    trainer = trainer_factory(config, train_loader, val_loader, test_loaders)
    return trainer.train_main()
