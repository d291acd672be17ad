"""Object-text baseline trainer: meme text ⊕ detected object words.

Counterpart of ``meme_challenge_tpu/train/train_object_text.py`` (reference
text_based/train_object_text.py): ``ObjectTextDataset`` with a text backbone
+ head, the plain loader (no ConfounderSampler), crossval-capable. The train
loader draws a confidence threshold in (min, max) a sample and swaps
adjacent object words with ``--obj_swap_prob``; evaluation loaders use the
fixed threshold ``--obj_threshold_max`` and no swaps. The JAX CLI's flags
and defaults, plus ``--device`` (default ``cuda``; raises without a card):

    python -m meme_challenge_tpu_torch.train.train_object_text \\
        --data_path dataset --vocab_file vocab.txt --model bert \\
        --object_file objects.npz --object_to_text_file bbox_classes.json \\
        [--obj_threshold_min 0.3 --obj_threshold_max 0.7] \\
        [--obj_swap_prob 0.1] [--device cpu]
"""
from __future__ import annotations

import argparse
import logging
import os

from meme_challenge_tpu_torch.core.config import TrainConfig
from meme_challenge_tpu_torch.core.device import resolve_device
from meme_challenge_tpu_torch.core.seeding import set_seed, torch_generator
from meme_challenge_tpu_torch.data.meme_dataset import BatchLoader
from meme_challenge_tpu_torch.data.object_text import ObjectTextDataset
from meme_challenge_tpu_torch.data.tokenizer import BertTokenizer
from meme_challenge_tpu_torch.models.text_models import init_text_model
from meme_challenge_tpu_torch.train.crossval_driver import train_crossval
from meme_challenge_tpu_torch.train.train_pure_text import (
    check_model_name,
    parse_train_config,
    text_loader_funcs,
)
from meme_challenge_tpu_torch.train.trainer import Trainer

logger = logging.getLogger("meme_challenge_tpu_torch.train_object_text")

OBJECT_TEXT_DEFAULTS = dict(
    lr=5e-5, warmup_steps=100, scheduler="warmup_cosine", optimizer="adamw",
    log_every=50, max_epoch=10, batch_size=32)


def build_object_text_entry(config: TrainConfig, model_name: str,
                            vocab_file: str, object_filepath: str,
                            object_to_text_filepath: str,
                            thresh_min: float = 0.5, thresh_max: float = 0.5,
                            swap_prob: float = 0.0,
                            max_txt_len: int = 128, device="cuda"):
    device = resolve_device(str(device))
    tokenizer = BertTokenizer(vocab_file)

    def make_loader(path, train=False, return_ids=False):
        # train-time: random threshold in (min, max) + swaps; eval: fixed
        # threshold, no swaps (reference train_object_text.py:116-120)
        thresh = (thresh_min, thresh_max) if train else thresh_max
        ds = ObjectTextDataset(
            path, object_filepath, object_to_text_filepath,
            tokenizer=tokenizer, max_txt_len=max_txt_len,
            confidence_threshold=thresh,
            swap_prob=swap_prob if train else 0.0,
            return_ids=return_ids)
        return BatchLoader(ds, config.batch_size, shuffle_data=train)

    loader_funcs, test_loaders = text_loader_funcs(config, make_loader)

    def trainer_factory(cfg, train_loader, val_loader, fold_tests):
        model = init_text_model(model_name, config.n_classes, device,
                                torch_generator(cfg.seed, device))
        return Trainer(cfg, model, train_loader, val_loader, fold_tests)

    return loader_funcs, test_loaders, trainer_factory


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, default="bert")
    parser.add_argument("--vocab_file", type=str, required=True)
    parser.add_argument("--object_file", type=str, required=True)
    parser.add_argument("--object_to_text_file", type=str, required=True)
    parser.add_argument("--obj_threshold_min", type=float, default=0.5)
    parser.add_argument("--obj_threshold_max", type=float, default=0.5)
    parser.add_argument("--obj_swap_prob", type=float, default=0.0)
    args, config = parse_train_config(parser, argv, OBJECT_TEXT_DEFAULTS)
    model_name = check_model_name(args.model)
    os.makedirs(config.model_path, exist_ok=True)
    set_seed(config.seed)
    loader_funcs, test_loaders, trainer_factory = build_object_text_entry(
        config, model_name, args.vocab_file, args.object_file,
        args.object_to_text_file, thresh_min=args.obj_threshold_min,
        thresh_max=args.obj_threshold_max, swap_prob=args.obj_swap_prob,
        max_txt_len=config.max_txt_len, device=args.device)
    return train_crossval(
        trainer_factory, config, loader_funcs, test_loaders,
        num_folds=config.num_folds, dev_size=config.crossval_dev_size,
        use_dev_set=config.crossval_use_dev, device=args.device)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
