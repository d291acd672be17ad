"""Text-only baseline fine-tuning entry point.

Counterpart of ``meme_challenge_tpu/train/train_pure_text.py`` (reference
text_based/train_pure_text.py): a ``MODEL_DICT`` backbone +
``TransformerClassificationHead`` trained on meme text only, with layer
freezing (``--num_layers_freeze``), a separate head learning rate
(``--lr_head``), ConfounderSampler upsampling and the crossval driver. The
JAX CLI's flags and defaults (lr 5e-5, adamw, warmup_cosine 100, batch 32,
max_epoch 10, head dropout 0.5, hidden 512, GELU), plus ``--device``
(default ``cuda``; asking for ``cuda`` without a card raises):

    python -m meme_challenge_tpu_torch.train.train_pure_text \\
        --data_path dataset --vocab_file vocab.txt --model bert \\
        [--lr_head 1e-4] [--num_layers_freeze 4] [--compute_bf16] \\
        [--device_resident_data] [--num_folds -1 --crossval_use_dev] \\
        [--debug] [--device cpu]

The text models' attention is the encoder's plain torch branch, as in the
JAX package: no fused-attention kernel runs on this path.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import os

from meme_challenge_tpu_torch.core.config import TrainConfig
from meme_challenge_tpu_torch.core.device import resolve_device
from meme_challenge_tpu_torch.core.seeding import set_seed, torch_generator
from meme_challenge_tpu_torch.data.meme_dataset import (
    BatchLoader,
    ConfounderSampler,
    MemeDataset,
)
from meme_challenge_tpu_torch.data.tokenizer import BertTokenizer
from meme_challenge_tpu_torch.models.text_models import (
    MODEL_DICT,
    init_text_model,
)
from meme_challenge_tpu_torch.train.crossval_driver import train_crossval
from meme_challenge_tpu_torch.train.optim import (
    head_lr_scales,
    layer_freeze_scales,
)
from meme_challenge_tpu_torch.train.train_uniter import add_train_config_args
from meme_challenge_tpu_torch.train.trainer import Trainer

logger = logging.getLogger("meme_challenge_tpu_torch.train_pure_text")

PURE_TEXT_DEFAULTS = dict(
    lr=5e-5, warmup_steps=100, scheduler="warmup_cosine", optimizer="adamw",
    log_every=50, max_epoch=10, batch_size=32)


def _is_head(name: str) -> bool:
    """The head's parameters: a name part starting with ``head_`` (JAX
    ``_is_head`` over the tree path)."""
    return any(part.startswith("head_") for part in name.split("."))


def text_update_scales(names, lr: float, lr_head: float,
                       num_layers_freeze: int) -> dict:
    """Two LR groups (the head at ``lr_head``) times layer freezing (the
    first ``num_layers_freeze`` encoder layers at 0)."""
    scales = head_lr_scales(names, lr, lr_head, _is_head)
    if num_layers_freeze > 0:
        freeze = layer_freeze_scales(names, num_layers_freeze)
        scales = {n: scales[n] * freeze[n] for n in names}
    return scales


def text_loader_funcs(config: TrainConfig, make_loader) -> tuple:
    """The crossval driver's loader factories from ``make_loader(path,
    train=False, return_ids=False)``, and the test loaders of the sets
    present under ``data_path``."""
    loader_funcs = {
        "train": lambda p: make_loader(p, train=True),
        "val": lambda p: make_loader(p),
        "test": lambda p: make_loader(p, return_ids=True),
    }
    test_loaders = [
        loader_funcs["test"](os.path.join(config.data_path, n))
        for n in ["test_seen.jsonl", "test_unseen.jsonl", "dev_seen.jsonl",
                  "dev_unseen.jsonl"]
        if os.path.isfile(os.path.join(config.data_path, n))
    ]
    return loader_funcs, test_loaders


def build_text_entry(config: TrainConfig, model_name: str, vocab_file: str,
                     lr_head: float = 1e-4, num_layers_freeze: int = 0,
                     max_txt_len: int = 256, compute_bf16: bool = False,
                     device="cuda"):
    """Loader factories + trainer factory for a text-only run."""
    device = resolve_device(str(device))
    tokenizer = BertTokenizer(vocab_file)

    def make_loader(path, train=False, return_ids=False):
        if train and config.debug:
            # --debug trains on dev_seen for fast iteration
            # (reference text_based/train_pure_text.py:132-133)
            path = os.path.join(config.data_path, "dev_seen.jsonl")
        ds = MemeDataset(path, tokenizer=tokenizer, text_only=True,
                         max_txt_len=max_txt_len, return_ids=return_ids)
        kw = {"index_batches": config.device_resident_data}
        if train:
            kw["sampler"] = ConfounderSampler(
                ds, repeat_factor=config.confounder_repeat)
        return BatchLoader(ds, config.batch_size, **kw)

    loader_funcs, test_loaders = text_loader_funcs(config, make_loader)

    def trainer_factory(cfg, train_loader, val_loader, fold_tests):
        model = init_text_model(model_name, config.n_classes, device,
                                torch_generator(cfg.seed, device),
                                compute_bf16=compute_bf16)
        scales = text_update_scales(
            [n for n, _ in model.named_parameters()], cfg.lr, lr_head,
            num_layers_freeze)
        return Trainer(cfg, model, train_loader, val_loader, fold_tests,
                       update_scales=scales)

    return loader_funcs, test_loaders, trainer_factory


def parse_train_config(parser: argparse.ArgumentParser, argv, defaults
                       ) -> tuple:
    """``--device`` and the TrainConfig flags with ``defaults``; returns
    (args, TrainConfig). The device is resolved first: asking for ``cuda``
    without a card raises before any data is read."""
    add_train_config_args(parser)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    parser.set_defaults(**defaults)
    args, _ = parser.parse_known_args(argv)
    args.device = resolve_device(args.device)
    config = TrainConfig(**{f.name: getattr(args, f.name)
                            for f in dataclasses.fields(TrainConfig)
                            if hasattr(args, f.name)})
    return args, config


def check_model_name(name: str) -> str:
    model_name = name.lower()
    if model_name not in MODEL_DICT:
        raise ValueError("Given model is not known. Please choose between: "
                         "%s" % list(MODEL_DICT.keys()))
    return model_name


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, default="bert")
    parser.add_argument("--vocab_file", type=str, required=True)
    parser.add_argument("--lr_head", type=float, default=1e-4)
    parser.add_argument("--num_layers_freeze", type=int, default=0)
    parser.add_argument("--compute_bf16", action="store_true",
                        help="bfloat16 compute (incl. bf16 score storage + "
                             "uint8 dropout words)")
    args, config = parse_train_config(parser, argv, PURE_TEXT_DEFAULTS)
    model_name = check_model_name(args.model)

    os.makedirs(config.model_path, exist_ok=True)
    set_seed(config.seed)
    loader_funcs, test_loaders, trainer_factory = build_text_entry(
        config, model_name, args.vocab_file, lr_head=args.lr_head,
        num_layers_freeze=args.num_layers_freeze,
        max_txt_len=config.max_txt_len, compute_bf16=args.compute_bf16,
        device=args.device)
    return train_crossval(
        trainer_factory, config, loader_funcs, test_loaders,
        num_folds=config.num_folds, dev_size=config.crossval_dev_size,
        use_dev_set=config.crossval_use_dev, device=args.device)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
