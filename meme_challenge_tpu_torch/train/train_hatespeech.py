"""Twitter hate-speech domain warm-up trainer.

Counterpart of ``meme_challenge_tpu/train/train_hatespeech.py`` (reference
text_based/train_hatespeech.py): a text backbone + head trained with CE loss
on the Twitter CSV, ``n_classes`` from the data's label vocabulary,
checkpoints selected on accuracy, one run (no crossval). The JAX CLI's flags
and defaults, plus ``--device`` (default ``cuda``; raises without a card):

    python -m meme_challenge_tpu_torch.train.train_hatespeech \\
        --vocab_file vocab.txt --train_csv train.csv --val_csv val.csv \\
        --model bert [--device cpu]
"""
from __future__ import annotations

import argparse
import logging
import os

from meme_challenge_tpu_torch.core.config import TrainConfig
from meme_challenge_tpu_torch.core.device import resolve_device
from meme_challenge_tpu_torch.core.seeding import set_seed, torch_generator
from meme_challenge_tpu_torch.data.hatespeech import TwitterHatespeechDataset
from meme_challenge_tpu_torch.data.meme_dataset import BatchLoader
from meme_challenge_tpu_torch.data.tokenizer import BertTokenizer
from meme_challenge_tpu_torch.models.text_models import init_text_model
from meme_challenge_tpu_torch.train.train_pure_text import (
    check_model_name,
    parse_train_config,
)
from meme_challenge_tpu_torch.train.trainer import Trainer

logger = logging.getLogger("meme_challenge_tpu_torch.train_hatespeech")

HATESPEECH_DEFAULTS = dict(
    lr=5e-5, warmup_steps=100, scheduler="warmup_cosine", optimizer="adamw",
    loss_func="ce", optimize_for="accuracy", log_every=50, max_epoch=10,
    batch_size=32)


def run_hatespeech(config: TrainConfig, model_name: str, vocab_file: str,
                   train_csv: str, val_csv: str, max_txt_len: int = 64,
                   device="cuda"):
    device = resolve_device(str(device))
    tokenizer = BertTokenizer(vocab_file)
    train_ds = TwitterHatespeechDataset(train_csv, tokenizer, max_txt_len)
    val_ds = TwitterHatespeechDataset(val_csv, tokenizer, max_txt_len)
    # n_classes from the data (reference train_hatespeech.py:134-143)
    model = init_text_model(model_name, train_ds.num_classes, device,
                            torch_generator(config.seed, device))
    train_loader = BatchLoader(train_ds, config.batch_size,
                               shuffle_data=True)
    val_loader = BatchLoader(val_ds, config.batch_size)
    trainer = Trainer(config, model, train_loader, val_loader, [])
    return trainer.train_main()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, default="bert")
    parser.add_argument("--vocab_file", type=str, required=True)
    parser.add_argument("--train_csv", type=str, required=True)
    parser.add_argument("--val_csv", type=str, required=True)
    args, config = parse_train_config(parser, argv, HATESPEECH_DEFAULTS)
    model_name = check_model_name(args.model)
    os.makedirs(config.model_path, exist_ok=True)
    set_seed(config.seed)
    return run_hatespeech(config, model_name, args.vocab_file,
                          args.train_csv, args.val_csv,
                          max_txt_len=config.max_txt_len, device=args.device)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
