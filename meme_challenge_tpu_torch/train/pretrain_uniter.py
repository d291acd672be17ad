"""UNITER pretraining entry point (CLI).

Counterpart of ``meme_challenge_tpu/train/pretrain_uniter.py``, with the
same flags plus ``--device`` (default ``cuda``; asking for ``cuda`` without
a card raises):

    python -m meme_challenge_tpu_torch.train.pretrain_uniter \\
        --data_path dataset --feature_path dataset/img_feats \\
        --vocab_file vocab.txt --tasks mlm:2,itm,mrfr,mrc-kl \\
        --batch_size 16 --gradient_accumulation 2 --max_epoch 5 \\
        --ot_weight 0.1 --device_resident_data [--compute_bf16] \\
        [--fuse_accum] [--device cpu]

``--tasks`` takes ``name[:pool_weight]`` entries (the MetaLoader's sampling
pool, reference pretrain_meme_dataset.py:21-58); the corpus merges
train.jsonl + dev_seen.jsonl (+ Memotion with ``--use_memotion``,
``tools/prep_memotion.py``). ``--pretrained_model_file`` warm-starts from a
JAX pretraining dump (flax msgpack, every head), a fine-tuned MemeUniter
dump (the trunk) or a torch pretraining dump (the trunk and the heads it
carries; ``models.convert.load_pretrain_weights``). The full-state resume
file is ``{model_save_name}.resume.pt`` in ``model_path``, written every
``--checkpoint_every`` steps (default one nominal epoch) and at the end, and
read back when it exists. The final dump, ``model_path/model_save_name``,
is a reference-layout torch pretraining checkpoint that
``train.train_uniter --pretrained_model_file`` ingests. ``--mesh_shape`` is
ignored with a warning, and ``--slow_rng`` (a JAX PRNG switch) does
nothing.
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import math
import os

from meme_challenge_tpu_torch.core.config import TrainConfig, UniterConfig
from meme_challenge_tpu_torch.core.constants import IMG_LABEL_DIM
from meme_challenge_tpu_torch.core.device import resolve_device
from meme_challenge_tpu_torch.core.seeding import set_seed, torch_generator
from meme_challenge_tpu_torch.data.pretrain import (
    ITMBatcher,
    MLMBatcher,
    MRCBatcher,
    MRFRBatcher,
    MetaLoader,
    TaskLoader,
    pretrain_corpus,
)
from meme_challenge_tpu_torch.data.tokenizer import BertTokenizer
from meme_challenge_tpu_torch.models.convert import load_pretrain_weights
from meme_challenge_tpu_torch.train.checkpoint import save_training_meta
from meme_challenge_tpu_torch.train.pretrain_driver import PretrainTrainer
from meme_challenge_tpu_torch.train.pretrain_init import init_pretrain_model
from meme_challenge_tpu_torch.train.train_uniter import add_train_config_args

logger = logging.getLogger("meme_challenge_tpu_torch.pretrain_uniter")

TASKS = ("mlm", "itm", "mrfr", "mrc", "mrc-kl")


def parse_tasks(spec: str):
    """``"mlm:2,itm,mrfr"`` → ordered {name: pool_weight} (weight ≥ 1)."""
    tasks = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, _, weight = part.partition(":")
        tasks[name] = int(weight) if weight else 1
    unknown = set(tasks) - set(TASKS)
    if unknown:
        raise ValueError("unknown pretraining tasks %s; choose from %s"
                         % (sorted(unknown), sorted(TASKS)))
    return tasks


def build_task_loaders(config: TrainConfig, dataset, tokenizer, tasks,
                       mlm_prob: float, itm_replace_prob: float,
                       region_mask_prob: float):
    """A TaskLoader per task; index mode when the corpus is
    device-resident."""
    idx = config.device_resident_data
    B = config.batch_size

    def make(name):
        if name == "mlm":
            return TaskLoader("mlm", dataset, B,
                              MLMBatcher(dataset, tokenizer,
                                         mask_prob=mlm_prob),
                              index_batches=idx)
        if name == "itm":
            return TaskLoader("itm", dataset, B,
                              ITMBatcher(dataset,
                                         replace_prob=itm_replace_prob),
                              needs_indices=True, index_batches=idx)
        if name == "mrfr":
            return TaskLoader("mrfr", dataset, B,
                              MRFRBatcher(dataset,
                                          mask_prob=region_mask_prob),
                              index_batches=idx)
        # mrc / mrc-kl share the batcher; the task string picks the loss
        return TaskLoader(name, dataset, B,
                          MRCBatcher(dataset, mask_prob=region_mask_prob),
                          needs_indices=True, index_batches=idx)

    return {name: (make(name), weight) if weight > 1 else make(name)
            for name, weight in tasks.items()}


def main(argv=None):
    parser = argparse.ArgumentParser()
    add_train_config_args(parser)
    parser.add_argument("--uniter_config", type=str, default="",
                        help="JSON model config (uniter-base defaults)")
    parser.add_argument("--vocab_file", type=str, required=True,
                        help="BERT vocab.txt (cased)")
    parser.add_argument("--tasks", type=str, default="mlm:2,itm,mrfr,mrc-kl",
                        help="comma list of task[:pool_weight] entries")
    parser.add_argument("--ot_weight", type=float, default=0.0,
                        help="IPOT optimal-transport alignment weight on the "
                             "ITM loss (models/ot.py)")
    parser.add_argument("--use_memotion", action="store_true",
                        help="merge memotion_dataset/all.jsonl into the "
                             "corpus (tools/prep_memotion.py output)")
    parser.add_argument("--mlm_prob", type=float, default=0.15)
    parser.add_argument("--itm_replace_prob", type=float, default=0.5)
    parser.add_argument("--region_mask_prob", type=float, default=0.15)
    parser.add_argument("--steps_per_epoch", type=int, default=0,
                        help="optimizer steps per nominal epoch (0 = one "
                             "pass of the merged corpus)")
    parser.add_argument("--checkpoint_every", type=int, default=0,
                        help="full-state resume checkpoint cadence in "
                             "optimizer steps (0 = once per nominal epoch; "
                             "resume is automatic when the file exists)")
    parser.add_argument("--compute_bf16", action="store_true",
                        help="bfloat16 compute dtype; also bf16 attention-"
                             "score storage and uint8 dropout words")
    parser.add_argument("--precise_attention", action="store_true",
                        help="with --compute_bf16: keep fp32 score storage "
                             "and uint32 dropout words")
    parser.add_argument("--slow_rng", action="store_true",
                        help="accepted for CLI parity with the JAX package; "
                             "no effect")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args, _ = parser.parse_known_args(argv)
    device = resolve_device(args.device)
    if args.slow_rng:
        logger.info("--slow_rng selects a JAX PRNG; it has no effect here")

    cfg_dict = {f.name: getattr(args, f.name)
                for f in dataclasses.fields(TrainConfig)
                if hasattr(args, f.name)}
    config = TrainConfig(**cfg_dict)
    if config.mesh_shape:
        logger.warning("--mesh_shape is not used by the pretraining driver "
                       "(single-device loop); ignoring %s", config.mesh_shape)
    uniter_config = (UniterConfig.from_json_file(args.uniter_config)
                     if args.uniter_config else UniterConfig())
    if args.compute_bf16:
        uniter_config = uniter_config.replace(dtype="bfloat16")
        if not args.precise_attention:
            uniter_config = uniter_config.replace(
                attention_score_dtype="bfloat16", dropout_bits_dtype="uint8")

    os.makedirs(config.model_path, exist_ok=True)
    set_seed(config.seed)
    save_training_meta(config.model_path, config, uniter_config)

    tokenizer = BertTokenizer(args.vocab_file)
    dataset = pretrain_corpus(
        config.data_path, config.feature_path, tokenizer,
        use_memotion=args.use_memotion, max_txt_len=config.max_txt_len,
        max_bb=config.max_bb, img_dim=uniter_config.img_dim,
        confidence_threshold=config.object_conf_thresh)
    logger.info("pretraining corpus: %i memes (train+dev%s)", len(dataset),
                "+memotion" if args.use_memotion else "")

    tasks = parse_tasks(args.tasks)
    loaders = build_task_loaders(config, dataset, tokenizer, tasks,
                                 args.mlm_prob, args.itm_replace_prob,
                                 args.region_mask_prob)
    meta = MetaLoader(loaders, accum_steps=config.gradient_accumulation)

    # weights from a generator made from the seed: no host RNG consumed,
    # so the batch stream does not depend on the initialization
    model = init_pretrain_model(uniter_config, IMG_LABEL_DIM, device,
                                torch_generator(config.seed, device))
    if config.pretrained_model_file:
        path = config.pretrained_model_file
        full = (path if os.path.isfile(path)
                else os.path.join(config.model_path, path))
        kind = load_pretrain_weights(model, full)
        logger.info("warm-started from %s (%s dump)", full, kind)

    # one nominal epoch = one pass of the merged corpus in OPTIMIZER steps:
    # each step consumes gradient_accumulation micro-batches of batch_size
    steps_per_epoch = args.steps_per_epoch or max(
        1, math.ceil(len(dataset)
                     / (config.batch_size * config.gradient_accumulation)))
    trainer = PretrainTrainer(
        config, model, meta, steps_per_epoch=steps_per_epoch,
        ot_weight=args.ot_weight,
        data_arrays=(dataset.device_arrays()
                     if config.device_resident_data else None))
    # resume file keyed by model_save_name: two runs sharing a model_path
    # must not pick up each other's stream records
    ckpt_path = (None if config.no_model_checkpoints else
                 os.path.join(config.model_path,
                              "%s.resume.pt" % config.model_save_name))
    losses = trainer.train(checkpoint_path=ckpt_path,
                           checkpoint_every=args.checkpoint_every or None)
    logger.info("final-epoch mean losses: %s",
                {t: round(v, 4) for t, v in sorted(losses.items())})
    logger.info("pretrained model saved to %s/%s — fine-tune with "
                "train.train_uniter --pretrained_model_file",
                config.model_path, config.model_save_name)
    return losses


if __name__ == "__main__":
    logging.basicConfig(
        format="%(asctime)s %(levelname)s %(name)s | %(message)s",
        datefmt="%d/%m/%Y %I:%M:%S %p", level=logging.INFO)
    main()
