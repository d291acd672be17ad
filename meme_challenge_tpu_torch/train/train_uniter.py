"""UNITER fine-tuning and inference entry point.

Counterpart of ``meme_challenge_tpu/train/train_uniter.py``, with the same
flags plus ``--device`` (default ``cuda``; asking for ``cuda`` without a card
raises). The reference README's recipe maps directly:

    python -m meme_challenge_tpu_torch.train.train_uniter \
        --data_path dataset --feature_path dataset/img_feats \
        --vocab_file vocab.txt --pretrained_model_file uniter-base.pt \
        --lr 3e-5 --scheduler warmup_cosine --warmup_steps 500 \
        --batch_size 16 --gradient_accumulation 2 --confounder_repeat 3 \
        --pos_wt 1.8 --max_epoch 30 --patience 5 --seed 43 \
        --num_folds -1 --crossval_dev_size 200 --crossval_use_dev \
        [--compute_bf16] [--fuse_accum] [--device_resident_data]

``--num_folds -1`` writes the fold splits (if missing), fine-tunes every
fold (``_fold_i`` checkpoints, CSVs and metrics JSON), then runs the
brute-force and evolutionary ensemble search on the same device and writes
the ``*_ensemble.csv`` files; ``--num_folds 0`` fine-tunes the default
train/dev_seen split. Each fine-tune uses dropout and early stopping,
reloads the best checkpoint and writes the validation CSV, a CSV per test
set and the metrics JSON; ``--max_epoch 0`` serves
``model_path/model_save_name`` as it is. ``--pretrained_model_file`` reads
reference torch dumps and the JAX package's flax-msgpack ``ModelSaver``
dumps (fine-tuned MemeUniter or UNITER pretraining). ``--steps_per_dispatch``
and ``--dispatch_unroll`` run their steps as a plain loop with the numbers
of single steps; ``--slow_rng`` is accepted and does nothing (a JAX PRNG
switch).

``--mesh_shape 1 --mesh_axes fold`` with ``--num_folds`` other than 0
trains all folds at once as one fold-stacked model on the one card
(``parallel/crossval_parallel.py``), with the same artifacts and a resume
file ``crossval_resume.pt`` under ``model_path`` (unless
``--no_model_checkpoints``). A mesh of more devices runs one process a
device under ``torchrun``, which sets up the process group (``nccl`` on
cards, ``gloo`` with ``--device cpu``)::

    torchrun --nproc_per_node 8 -m meme_challenge_tpu_torch.train.train_uniter \
        ... --num_folds -1 --mesh_shape 2,2,2 --mesh_axes fold,data,model

(folds split over ranks, each fold's batch over ``data``, the encoder over
``model``: ``parallel/fold_parallel.py``); without ``torchrun`` such a mesh
raises ValueError. With ``--num_folds 0`` a fold mesh falls through to the
sequential single-split run with a warning, as in the JAX package.
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
from meme_challenge_tpu_torch.parallel.crossval_parallel import (
    train_crossval_fold_parallel,
)
from meme_challenge_tpu_torch.parallel.mesh import (
    initialize_distributed,
    launched,
    make_mesh,
)
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
        kind = load_pretrained(model, full_path)
        logger.info("Loaded %s (%s dump)", full_path, kind)
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
        # the Trainer builds the optimizer and schedule from cfg
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
    # --mesh_shape 4,2 --mesh_axes fold,data → all folds train at once over
    # the mesh (parallel/crossval_parallel.py), one process a device under
    # torchrun; num_folds == 0 has no fold axis and falls through to the
    # sequential single-split driver
    fold_parallel = (bool(config.mesh_shape) and "fold" in config.mesh_axes
                     and config.num_folds != 0)
    mesh, started = None, False
    if fold_parallel:
        if launched() and not torch.distributed.is_initialized():
            initialize_distributed(device.type)
            started = True
        # raises for more than one device without a process group
        mesh = make_mesh(config.mesh_shape, config.mesh_axes, device.type)
        if mesh.device_mesh is not None:
            logger.info("process group: backend %s, world size %d, mesh %s",
                        torch.distributed.get_backend(),
                        torch.distributed.get_world_size(),
                        ",".join("%s=%d" % a for a in zip(mesh.axis_names,
                                                          mesh.shape)))
    try:
        return _run(config, uniter_config, args, device, fold_parallel, mesh)
    finally:
        if started:
            torch.distributed.destroy_process_group()


def _run(config, uniter_config, args, device, fold_parallel, mesh):
    """The fold-parallel driver over ``mesh`` or the sequential one."""
    os.makedirs(config.model_path, exist_ok=True)
    set_seed(config.seed)
    loader_funcs, test_loaders, trainer_factory = build_entry(
        config, uniter_config, args.vocab_file, device)
    if fold_parallel:
        def init_model_fn(seed):
            return init_meme_uniter_params(uniter_config, config, device,
                                           torch_generator(seed, device))

        return train_crossval_fold_parallel(
            config, init_model_fn, loader_funcs, test_loaders=test_loaders,
            num_folds=config.num_folds, dev_size=config.crossval_dev_size,
            use_dev_set=config.crossval_use_dev,
            resume_path=(os.path.join(config.model_path,
                                      "crossval_resume.pt")
                         if not config.no_model_checkpoints else None),
            device=device, mesh=mesh)
    if config.mesh_shape and "fold" in config.mesh_axes:
        logger.warning("--mesh_shape given but num_folds=0 (no crossval): "
                       "falling back to the sequential single-split driver")
    return train_crossval(
        trainer_factory, config, loader_funcs, test_loaders,
        num_folds=config.num_folds, dev_size=config.crossval_dev_size,
        use_dev_set=config.crossval_use_dev, device=device)


if __name__ == "__main__":
    logging.basicConfig(
        format="%(asctime)s %(levelname)s %(name)s | %(message)s",
        datefmt="%d/%m/%Y %I:%M:%S %p", level=logging.INFO)
    main()
