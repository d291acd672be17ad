"""Oscar fine-tuning entry point.

Counterpart of ``meme_challenge_tpu/train/train_oscar.py``: MemeDataset
features assembled into 2054-d Oscar features (2048 ⊕ 6-d geometry),
ConfounderSampler, crossval, CE loss over ``max(n_classes, 2)`` labels
(config/oscar-base.json), checkpoints selected on accuracy (multiclass
metrics report no AUROC). The JAX CLI's flags and defaults, plus
``--device`` (default ``cuda``; raises without a card):

    python -m meme_challenge_tpu_torch.train.train_oscar \\
        --data_path dataset --feature_path dataset/img_feats \\
        --vocab_file vocab.txt --oscar_config configs/oscar-base.json \\
        [--classifier mlp] [--device_resident_data] [--device cpu]

A config with ``"use_pallas_attention": true`` runs every encoder layer
through the fused-attention kernels (``"pallas_blocked": true``: the
pair-blocked seed mode; ``"dtype": "bfloat16"``: bf16 compute).
"""
from __future__ import annotations

import argparse
import logging
import os

import numpy as np

from meme_challenge_tpu_torch.core.config import TrainConfig, UniterConfig
from meme_challenge_tpu_torch.core.device import resolve_device
from meme_challenge_tpu_torch.core.seeding import set_seed, torch_generator
from meme_challenge_tpu_torch.data.meme_dataset import (
    BatchLoader,
    ConfounderSampler,
    MemeDataset,
)
from meme_challenge_tpu_torch.data.tokenizer import BertTokenizer
from meme_challenge_tpu_torch.models.oscar import init_oscar_model
from meme_challenge_tpu_torch.train.crossval_driver import train_crossval
from meme_challenge_tpu_torch.train.train_pure_text import (
    parse_train_config,
    text_loader_funcs,
)
from meme_challenge_tpu_torch.train.trainer import Trainer

logger = logging.getLogger("meme_challenge_tpu_torch.train_oscar")


class OscarBatchLoader(BatchLoader):
    """Batches with the 2054-d Oscar feature assembly.

    Host mode: the per-batch 2048 ⊕ 6 feature concat happens here. Index
    mode (``device_resident_data``): batches carry no features, the Trainer
    gathers the dataset's raw (2048-d, 7-d geometry) arrays on the device,
    and the model assembles the 2054-d features
    (models/oscar.py: ImageBertForSequenceClassification)."""

    def __iter__(self):
        for batch in super().__iter__():
            if "img_feat" in batch:
                batch = dict(batch)
                batch["img_feat"] = np.concatenate(
                    [batch["img_feat"], batch["img_pos_feat"][..., :6]],
                    axis=-1)
                del batch["img_pos_feat"]
            yield batch


def build_oscar_entry(config: TrainConfig, oscar_config: UniterConfig,
                      vocab_file: str, classifier: str = "linear",
                      device="cuda"):
    device = resolve_device(str(device))
    tokenizer = BertTokenizer(vocab_file)
    ds_kwargs = dict(feature_dir=config.feature_path, tokenizer=tokenizer,
                     max_txt_len=config.max_txt_len, max_bb=config.max_bb,
                     confidence_threshold=config.object_conf_thresh,
                     # stored features are Oscar's img_feature_dim minus the
                     # 6-d geometry the loader/model appends (2054 → 2048
                     # with config/oscar-base.json)
                     img_dim=oscar_config.img_dim - 6)

    def make_loader(path, train=False, return_ids=False):
        ds = MemeDataset(path, return_ids=return_ids, **ds_kwargs)
        kw = {"index_batches": config.device_resident_data}
        if train:
            kw["sampler"] = ConfounderSampler(
                ds, repeat_factor=config.confounder_repeat)
        return OscarBatchLoader(ds, config.batch_size, **kw)

    loader_funcs, test_loaders = text_loader_funcs(config, make_loader)

    def trainer_factory(cfg, train_loader, val_loader, fold_tests):
        model = init_oscar_model(oscar_config, max(config.n_classes, 2),
                                 device, torch_generator(cfg.seed, device),
                                 classifier=classifier)
        return Trainer(cfg, model, train_loader, val_loader, fold_tests)

    return loader_funcs, test_loaders, trainer_factory


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--oscar_config", type=str,
                        default="configs/oscar-base.json")
    parser.add_argument("--vocab_file", type=str, required=True)
    parser.add_argument("--classifier", type=str, default="linear",
                        choices=["linear", "mlp"])
    # multiclass metrics report aucroc=-1 (reference data/metrics.py:59-80),
    # so optimize_for="aucroc" would never checkpoint under CE loss
    args, config = parse_train_config(
        parser, argv, dict(loss_func="ce", optimize_for="accuracy"))
    oscar_config = UniterConfig.from_json_file(args.oscar_config)
    os.makedirs(config.model_path, exist_ok=True)
    set_seed(config.seed)
    loader_funcs, test_loaders, trainer_factory = build_oscar_entry(
        config, oscar_config, args.vocab_file, classifier=args.classifier,
        device=args.device)
    return train_crossval(
        trainer_factory, config, loader_funcs, test_loaders,
        num_folds=config.num_folds, dev_size=config.crossval_dev_size,
        use_dev_set=config.crossval_use_dev, device=args.device)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
