"""UNITER entry point (inference slice).

Counterpart of ``meme_challenge_tpu/train/train_uniter.py``, with the same
flags plus ``--device`` (default ``cuda``; asking for ``cuda`` without a card
raises). The reference README's inference command maps directly:

    python -m meme_challenge_tpu_torch.train.train_uniter \
        --data_path dataset --feature_path dataset/img_feats \
        --vocab_file vocab.txt --model_path ckpts --model_save_name best.ckpt \
        --max_epoch 0 --num_folds 0 --batch_size 16 [--compute_bf16]

It reloads ``model_path/model_save_name`` (a torch checkpoint in the
reference's format) and writes the validation CSV, a CSV per test set and
the metrics JSON. ``--pretrained_model_file`` reads reference torch dumps
(fine-tuned MemeUniter or UNITER pretraining); flax msgpack files raise.
``--slow_rng`` is accepted and does nothing (a JAX PRNG switch).
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os

import torch

from meme_challenge_tpu_torch.core.config import TrainConfig, UniterConfig
from meme_challenge_tpu_torch.core.device import resolve_device
from meme_challenge_tpu_torch.core.seeding import set_seed, torch_generator
from meme_challenge_tpu_torch.data.meme_dataset import (
    BatchLoader,
    ConfounderSampler,
    MemeDataset,
)
from meme_challenge_tpu_torch.data.tokenizer import BertTokenizer
from meme_challenge_tpu_torch.models.convert import load_pretrained
from meme_challenge_tpu_torch.models.uniter import MemeUniter, init_meme_uniter
from meme_challenge_tpu_torch.train.crossval_driver import train_crossval
from meme_challenge_tpu_torch.train.trainer import Trainer

logger = logging.getLogger("meme_challenge_tpu_torch.train_uniter")


def _parse_mesh_shape(s: str) -> tuple:
    return tuple(int(x) for x in str(s).split(",") if x.strip())


def _parse_mesh_axes(s: str) -> tuple:
    return tuple(x.strip() for x in str(s).split(",") if x.strip())


def add_train_config_args(parser: argparse.ArgumentParser) -> None:
    """All TrainConfig fields as flags (reference add_default_argparse +
    train_uniter.py extras), typed as the JAX CLI types them."""
    for f in dataclasses.fields(TrainConfig):
        name = "--" + f.name
        if f.type == "bool" or isinstance(f.default, bool):
            parser.add_argument(name, action=argparse.BooleanOptionalAction,
                                default=f.default)
        elif f.name == "mesh_shape":
            parser.add_argument(name, type=_parse_mesh_shape, default=())
        elif f.name == "mesh_axes":
            parser.add_argument(name, type=_parse_mesh_axes,
                                default=("fold", "data"))
        else:
            typ = (type(f.default) if f.default is not None else str)
            parser.add_argument(name, type=typ, default=f.default)


def init_meme_uniter_params(uniter_config: UniterConfig,
                            train_config: TrainConfig, device,
                            generator: torch.Generator) -> MemeUniter:
    """A MemeUniter with random weights from ``generator``, optionally
    loaded from ``pretrained_model_file``.

    Mirrors reference TrainerUniter.init_model/load_model
    (train_uniter.py:22-53): a raw UNITER pretraining dump loads the trunk
    (the classifier stays random); a fine-tuned MemeUniter dump restores
    everything."""
    model = init_meme_uniter(uniter_config, train_config.n_classes, device,
                             generator)
    path = train_config.pretrained_model_file
    if path:
        full_path = (path if os.path.isfile(path)
                     else os.path.join(train_config.model_path, path))
        logger.info("Loading pretrained UNITER weights from %s", full_path)
        load_pretrained(model, full_path)
    return model


def build_entry(config: TrainConfig, uniter_config: UniterConfig,
                vocab_file: str, device="cuda"):
    """Wire tokenizer, loader factories, trainer factory. Returns
    (loader_funcs, test_loaders, trainer_factory)."""
    device = resolve_device(str(device))
    tokenizer = BertTokenizer(vocab_file)

    ds_kwargs = dict(
        feature_dir=config.feature_path,
        tokenizer=tokenizer,
        max_txt_len=config.max_txt_len,
        max_bb=config.max_bb,
        confidence_threshold=config.object_conf_thresh,
        img_dim=uniter_config.img_dim,
    )
    idx = config.device_resident_data  # device-resident datasets, on-device
    # micro-batch gather (train/steps.py:gather_micro)

    def train_data_loader(path):
        ds = MemeDataset(path, **ds_kwargs)
        sampler = ConfounderSampler(ds,
                                    repeat_factor=config.confounder_repeat)
        return BatchLoader(ds, config.batch_size, sampler=sampler,
                           index_batches=idx)

    def val_data_loader(path):
        ds = MemeDataset(path, **ds_kwargs)
        return BatchLoader(ds, config.batch_size, index_batches=idx)

    def test_data_loader(path):
        ds = MemeDataset(path, return_ids=True, **ds_kwargs)
        return BatchLoader(ds, config.batch_size, index_batches=idx)

    loader_funcs = {"train": train_data_loader, "val": val_data_loader,
                    "test": test_data_loader}

    test_loaders = []
    for name in ["test_seen.jsonl", "test_unseen.jsonl", "dev_seen.jsonl",
                 "dev_unseen.jsonl"]:
        path = os.path.join(config.data_path, name)
        if os.path.isfile(path):
            test_loaders.append(test_data_loader(path))

    def trainer_factory(cfg, train_loader, val_loader, fold_test_loaders):
        model = init_meme_uniter_params(
            uniter_config, cfg, device, torch_generator(cfg.seed, device))
        return Trainer(cfg, model, train_loader, val_loader,
                       fold_test_loaders)

    return loader_funcs, test_loaders, trainer_factory


def main(argv=None):
    parser = argparse.ArgumentParser()
    add_train_config_args(parser)
    parser.add_argument("--uniter_config", type=str, default="",
                        help="JSON model config (uniter-base defaults)")
    parser.add_argument("--vocab_file", type=str, required=True,
                        help="BERT vocab.txt (cased)")
    parser.add_argument("--compute_bf16", action="store_true",
                        help="bfloat16 compute dtype; also bf16 attention-"
                             "score storage on the non-kernel attention path")
    parser.add_argument("--precise_attention", action="store_true",
                        help="with --compute_bf16: keep fp32 score storage")
    parser.add_argument("--slow_rng", action="store_true",
                        help="accepted for CLI parity with the JAX package; "
                             "no effect")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args, _ = parser.parse_known_args(argv)
    device = resolve_device(args.device)

    cfg_dict = {f.name: getattr(args, f.name)
                for f in dataclasses.fields(TrainConfig)
                if hasattr(args, f.name)}
    config = TrainConfig(**cfg_dict)
    uniter_config = (UniterConfig.from_json_file(args.uniter_config)
                     if args.uniter_config else UniterConfig())
    if args.compute_bf16:
        uniter_config = uniter_config.replace(dtype="bfloat16")
        if not args.precise_attention:
            uniter_config = uniter_config.replace(
                attention_score_dtype="bfloat16", dropout_bits_dtype="uint8")
    if config.mesh_shape:
        logger.warning("--mesh_shape is ignored: the port runs on one "
                       "device in this slice")

    os.makedirs(config.model_path, exist_ok=True)
    set_seed(config.seed)
    loader_funcs, test_loaders, trainer_factory = build_entry(
        config, uniter_config, args.vocab_file, device)
    return train_crossval(
        trainer_factory, config, loader_funcs, test_loaders,
        num_folds=config.num_folds, dev_size=config.crossval_dev_size,
        use_dev_set=config.crossval_use_dev)


if __name__ == "__main__":
    logging.basicConfig(
        format="%(asctime)s %(levelname)s %(name)s | %(message)s",
        datefmt="%d/%m/%Y %I:%M:%S %p", level=logging.INFO)
    main()
