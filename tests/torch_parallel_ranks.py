"""The ranks of ``tests/test_torch_parallel.py``: one process each, over a
``gloo`` group with a ``file://`` rendezvous, on the CPU.

    python tests/torch_parallel_ranks.py WORLD RANK STORE INPUTS OUT

Every rank of a world runs the same scenarios (``world2``, ``world4``) on the
inputs that the test process wrote to ``INPUTS`` (``init.pt``, 4 folds'
fold-stacked initial weights; ``batch.npz``, one global step's batch; the
synthetic dataset ``data/``), and rank 0 saves what the test compares to
``OUT/world<WORLD>.pt``. Imports no JAX: the test process holds the oracles.
"""
import datetime
import json
import os
import shutil
import sys

import numpy as np
import torch
import torch.distributed as dist

from meme_challenge_tpu_torch.core.config import TrainConfig, UniterConfig
from meme_challenge_tpu_torch.core.seeding import (
    dropout_generator,
    fold_seed,
    set_seed,
    torch_generator,
)
from meme_challenge_tpu_torch.data.meme_dataset import BatchLoader, MemeDataset
from meme_challenge_tpu_torch.data.tokenizer import BertTokenizer
from meme_challenge_tpu_torch.models.uniter import FoldStack, init_meme_uniter
from meme_challenge_tpu_torch.parallel.crossval_parallel import (
    train_crossval_fold_parallel,
)
from meme_challenge_tpu_torch.parallel.fold_parallel import FoldParallelTrainer
from meme_challenge_tpu_torch.parallel.mesh import (
    initialize_distributed,
    make_mesh,
)
from meme_challenge_tpu_torch.train.steps import TRAIN_KEYS, to_device

# SMALL of tests/torch_parity.py: 2 layers, hidden 32, 4 heads
SMALL = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=64, img_dim=16,
             max_position_embeddings=32, initializer_range=0.2)
TXT, BB, BATCH, ACCUM, FOLDS = 8, 8, 4, 2, 2
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
# the encoder's attention, dropout on (the fused kernels' plain versions on
# the CPU) and off (the plain branch, as the JAX oracle runs it)
VARIANTS = {"per_sample": dict(use_pallas_attention=True),
            "blocked": dict(use_pallas_attention=True, pallas_blocked=True),
            "plain": {},
            "off": NO_DROPOUT}
# the step meshes of the 2-rank world
STEP_MESHES = {"fold2": ((2,), ("fold",)), "fold1_data2": ((1, 2),
                                                           ("fold", "data"))}
# every collective of a test rank gives up after this long
TIMEOUT = datetime.timedelta(seconds=120)
MODEL_KEYS = ("input_ids", "position_ids", "txt_mask", "img_feat",
              "img_pos_feat", "img_mask")


def uniter_config(variant: str) -> UniterConfig:
    return UniterConfig(**SMALL, **VARIANTS[variant])


def train_config(data_root: str, model_path: str, **kw) -> TrainConfig:
    base = dict(data_path=data_root,
                feature_path=os.path.join(data_root, "img_feats"),
                model_path=model_path, model_save_name="fp.ckpt", lr=0.05,
                optimizer="sgd", batch_size=BATCH, max_epoch=2, patience=5,
                warmup_steps=0, gradient_accumulation=ACCUM,
                max_txt_len=TXT, max_bb=BB, seed=43,
                adam_mu_dtype="float32", adam_nu_dtype="float32")
    base.update(kw)
    return TrainConfig(**base)


def loader(data_root: str, name: str, shuffle: bool = False
           ) -> BatchLoader:
    """A loader of split ``name`` of ``data_root``, or of the jsonl file
    ``name``."""
    path = (name if name.endswith(".jsonl")
            else os.path.join(data_root, name + ".jsonl"))
    ds = MemeDataset(path, feature_dir=os.path.join(data_root, "img_feats"),
                     tokenizer=BertTokenizer(os.path.join(data_root,
                                                          "vocab.txt")),
                     max_txt_len=TXT, max_bb=BB, img_dim=SMALL["img_dim"],
                     return_ids=True)
    return BatchLoader(ds, BATCH, shuffle_data=shuffle)


def step_trainer(inputs: str, variant: str, mesh=None, folds: int = FOLDS
                 ) -> FoldParallelTrainer:
    """A trainer of ``folds`` folds from ``init.pt`` (SGD, lr 0.05)."""
    data = os.path.join(inputs, "data")
    init = torch.load(os.path.join(inputs, "init.pt"))
    params = {k: v[:folds].clone() for k, v in init.items()}
    return FoldParallelTrainer(
        train_config(data, os.path.join(inputs, "unused")),
        FoldStack(uniter_config(variant), 1, params),
        [loader(data, "train") for _ in range(folds)],
        [loader(data, "dev_seen") for _ in range(folds)], mesh=mesh)


def one_step(trainer: FoldParallelTrainer, batch: dict) -> None:
    """One optimizer step on this rank's folds and rows of the global
    ``batch`` (numpy ``[F, accum, B, ...]``)."""
    rows = batch["sample_mask"].shape[-1] // trainer.data_size
    r0 = trainer.data_rank * rows
    local = {k: v[trainer.folds_here][:, :, r0:r0 + rows]
             for k, v in batch.items()}
    trainer._step(to_device(local, trainer.device,
                            keys=MODEL_KEYS + TRAIN_KEYS))


def forward_logits(model: FoldStack, batch: dict, step: int = 0,
                   folds_here=None, seed: int = 43) -> torch.Tensor:
    """Logits ``[F, B, 1]`` of the first micro-batch of ``batch`` with
    dropout on, fold f drawing from its generator at ``step``."""
    folds_here = list(range(model.folds)) if folds_here is None else folds_here
    micro = {k: v[folds_here][:, 0] for k, v in batch.items()
             if k in MODEL_KEYS}
    gens = [dropout_generator(fold_seed(seed, f), step, "cpu")
            for f in folds_here]
    with torch.no_grad():
        return model(to_device(micro, "cpu"), deterministic=False,
                     generators=gens)


def crossval(data_root: str, model_path: str, mesh=None, max_epoch: int = 2,
             kill_after: int = 0) -> dict:
    """The fold-parallel crossval driver, 2 folds, on ``mesh``; with
    ``kill_after`` the run stops (as if killed) after that epoch's resume
    file is written."""
    cfg = train_config(data_root, model_path, optimizer="adam", lr=3e-3,
                       max_epoch=max_epoch, warmup_steps=2,
                       model_save_name="cv.ckpt")
    loaders = {"train": lambda p: loader(data_root, p, shuffle=True),
               "val": lambda p: loader(data_root, p),
               "test": lambda p: loader(data_root, p)}
    tests = [loader(data_root, n) for n in ("test_seen", "dev_seen")]
    os.makedirs(model_path, exist_ok=True)
    set_seed(cfg.seed)
    ucfg = uniter_config("per_sample")
    saved = FoldParallelTrainer.save_checkpoint
    if kill_after:
        def save_then_stop(self, path, next_epoch):
            saved(self, path, next_epoch)
            if next_epoch > kill_after:
                raise _Killed()
        FoldParallelTrainer.save_checkpoint = save_then_stop
    try:
        return train_crossval_fold_parallel(
            cfg, lambda seed: init_meme_uniter(ucfg, 1, "cpu",
                                               torch_generator(seed, "cpu")),
            loaders, tests, num_folds=FOLDS, dev_size=8, ea_generations=3,
            resume_path=os.path.join(model_path, "crossval_resume.pt"),
            device="cpu", mesh=mesh)
    except _Killed:
        return {}
    finally:
        FoldParallelTrainer.save_checkpoint = saved


class _Killed(Exception):
    pass


def cli_run(data_root: str, model_path: str, mesh_flags: list) -> dict:
    """``train_uniter`` through its CLI: the fold-parallel recipe on the
    synthetic data, 2 epochs, the per-sample kernel's plain version."""
    from meme_challenge_tpu_torch.train import train_uniter

    os.makedirs(model_path, exist_ok=True)
    cfg = os.path.join(model_path, "uniter.json")
    with open(cfg, "w") as f:
        json.dump(uniter_config("per_sample").to_dict(), f)
    return train_uniter.main([
        "--data_path", data_root,
        "--feature_path", os.path.join(data_root, "img_feats"),
        "--vocab_file", os.path.join(data_root, "vocab.txt"),
        "--model_path", model_path, "--model_save_name", "cli.ckpt",
        "--uniter_config", cfg, "--max_epoch", "2", "--num_folds", "2",
        "--crossval_dev_size", "8", "--batch_size", str(BATCH),
        "--gradient_accumulation", str(ACCUM), "--confounder_repeat", "3",
        "--warmup_steps", "2", "--lr", "3e-3", "--seed", "43",
        "--max_txt_len", str(TXT), "--max_bb", str(BB), "--device", "cpu",
        *mesh_flags])


# ------------------------------------------------------------ the worlds


def world2(inputs: str, out: str) -> dict:
    batch = dict(np.load(os.path.join(inputs, "batch.npz")))
    saved = {}
    for name, (shape, axes) in STEP_MESHES.items():
        mesh = make_mesh(shape, axes, "cpu")
        for variant in ("per_sample", "blocked", "off"):
            trainer = step_trainer(inputs, variant, mesh)
            one_step(trainer, batch)
            saved["%s/%s" % (name, variant)] = trainer._whole_tree(
                trainer.model.params)
    # the model axis: one forward with dropout on
    mesh = make_mesh((1, 2), ("fold", "model"), "cpu")
    for variant in ("per_sample", "blocked", "plain"):
        trainer = step_trainer(inputs, variant, mesh)
        saved["model2/%s" % variant] = forward_logits(trainer.model, batch)
        saved["model2/%s/heads" % variant] = trainer.model.params[
            "uniter_model.encoder.layer.0.attention.self.query.weight"
        ].shape[1]
    # 3 folds do not split over a fold axis of 2
    try:
        step_trainer(inputs, "off", make_mesh((2,), ("fold",), "cpu"),
                     folds=3)
        saved["uneven"] = ""
    except ValueError as e:
        saved["uneven"] = str(e)
    try:
        make_mesh((4,), ("fold",), "cpu")
        saved["wrong_world"] = ""
    except ValueError as e:
        saved["wrong_world"] = str(e)
    # the crossval driver: a whole run, and one stopped after epoch 1
    data = os.path.join(inputs, "data")
    fold2 = make_mesh((2,), ("fold",), "cpu")
    res = crossval(data, os.path.join(out, "cv2"), fold2)
    ran = [None] * dist.get_world_size()
    dist.all_gather_object(ran, "ensemble" in res)
    saved["cv2/ensemble_ran"] = ran
    saved["cv2/val_metrics"] = json.dumps(res["val_metrics"], default=float)
    killed = os.path.join(out, "cv2_killed")
    crossval(data, killed, fold2, kill_after=1)
    # the resume file read back on 2 ranks, in a copy of the run
    again = os.path.join(out, "cv2_resumed")
    if dist.get_rank() == 0:
        shutil.copytree(killed, again)
    dist.barrier()
    crossval(data, again, fold2)
    # the CLI over the group this process is in
    cli_run(data, os.path.join(out, "cli2"), ["--mesh_shape", "2",
                                              "--mesh_axes", "fold"])
    return saved


def world4(inputs: str, out: str) -> dict:
    batch = dict(np.load(os.path.join(inputs, "batch.npz")))
    saved = {}
    mesh = make_mesh((1, 2, 2), ("fold", "data", "model"), "cpu")
    trainer = step_trainer(inputs, "per_sample", mesh)
    saved["3axis/split"] = sorted(trainer.model.split.dims)
    one_step(trainer, batch)
    saved["3axis/step"] = trainer._whole_tree(trainer.model.params)
    data = os.path.join(inputs, "data")
    adam = train_config(data, os.path.join(out, "unused"), optimizer="adam",
                        lr=3e-3, warmup_steps=2)
    init = torch.load(os.path.join(inputs, "init.pt"))
    trainer = FoldParallelTrainer(
        adam, FoldStack(uniter_config("per_sample"), 1,
                        {k: v[:FOLDS].clone() for k, v in init.items()}),
        [loader(data, "train", shuffle=True) for _ in range(FOLDS)],
        [loader(data, "dev_seen") for _ in range(FOLDS)], mesh=mesh)
    saved["3axis/metrics"] = json.dumps(trainer.train_main(), default=float)
    # four folds, one a rank
    fold4 = make_mesh((4,), ("fold",), "cpu")
    four = {k: v[:4].clone() for k, v in init.items()}
    trainer = FoldParallelTrainer(
        adam, FoldStack(uniter_config("per_sample"), 1, four),
        [loader(data, "train", shuffle=True) for _ in range(4)],
        [loader(data, "dev_seen") for _ in range(4)], mesh=fold4)
    mine = {k: v[0] for k, v in trainer.model.params.items()}
    wanted = {k: v[trainer.folds_here[0]] for k, v in four.items()}
    held = [trainer.model.folds, int(all(torch.equal(mine[k], wanted[k])
                                         for k in wanted))]
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, [trainer.folds_here] + held)
    saved["fold4/ranks"] = parts
    saved["fold4/metrics"] = json.dumps(trainer.train_main(), default=float)
    return saved


def main(world: int, rank: int, store: str, inputs: str, out: str) -> None:
    torch.set_num_threads(1)
    initialize_distributed("cpu", init_method="file://" + store,
                           world_size=world, rank=rank, timeout=TIMEOUT)
    try:
        saved = {2: world2, 4: world4}[world](inputs, out)
        if rank == 0:
            torch.save(saved, os.path.join(out, "world%d.pt" % world))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
