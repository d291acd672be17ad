"""Multi-device dry run of the port: the fold-parallel crossval driver over
a ``torch.distributed`` mesh, on tiny synthetic data.

Counterpart of ``__graft_entry__.py`` (``entry()`` :39, ``dryrun_multichip``
:57-140). Each mesh runs the real driver (``parallel/crossval_parallel.py``):
2 epochs of training with per-epoch evaluation and early stopping, every
fold's checkpoint, CSVs (content-checked) and metrics, and the ensemble
search on rank 0. The meshes of n ranks, as in JAX: n a multiple of 8 runs
(n/4, 2, 2) over fold × data × model, then (n/2, 2) over fold × data; another
even n runs (n/2, 2); an odd n runs (n,) over fold.

    torchrun --nproc_per_node N -m meme_challenge_tpu_torch.parallel.dryrun
    python -m meme_challenge_tpu_torch.parallel.dryrun --spawn N [--device cpu]

``torchrun`` provides the process group (one process a card, ``nccl``);
``--spawn N`` starts the N processes itself, with a ``file://`` rendezvous in
a temporary directory (``gloo`` with ``--device cpu``). Rank 0 prints one
``dryrun_multichip OK`` line a mesh; the command exits non-zero if a rank
fails.
"""
from __future__ import annotations

import argparse
import csv
import datetime
import os
import shutil
import sys
import tempfile
from glob import glob

import numpy as np
import torch
import torch.distributed as dist

from meme_challenge_tpu_torch.core.config import TrainConfig, UniterConfig
from meme_challenge_tpu_torch.core.device import resolve_device
from meme_challenge_tpu_torch.core.seeding import set_seed, torch_generator
from meme_challenge_tpu_torch.data.meme_dataset import BatchLoader, MemeDataset
from meme_challenge_tpu_torch.data.tokenizer import BertTokenizer
from meme_challenge_tpu_torch.models.uniter import MemeUniter, init_meme_uniter
from meme_challenge_tpu_torch.parallel.crossval_parallel import (
    train_crossval_fold_parallel,
)
from meme_challenge_tpu_torch.parallel.mesh import (
    initialize_distributed,
    launched,
    make_mesh,
)
from meme_challenge_tpu_torch.utils.synthetic import make_synthetic_dataset

# a rank that dies ends the dry run's collectives after this long
TIMEOUT = datetime.timedelta(minutes=5)


def entry(device="cuda"):
    """A UNITER-base forward in bfloat16 and its arguments on ``device``:
    ``(fn, (model, batch))`` with ``fn(model, batch)`` → logits ``[16, 1]``
    (JAX ``entry()``: batch 16, 60 text tokens, 100 regions)."""
    device = resolve_device(str(device))
    cfg = UniterConfig(dtype="bfloat16")
    model = init_meme_uniter(cfg, 1, device, torch_generator(0, device))
    rng = np.random.RandomState(0)
    B, T, R = 16, 60, 100
    txt_len, img_len = rng.randint(4, T, B), rng.randint(10, R, B)
    batch = {
        "input_ids": rng.randint(1, cfg.vocab_size, (B, T)),
        "position_ids": np.tile(np.arange(T), (B, 1)),
        "img_feat": rng.randn(B, R, cfg.img_dim).astype(np.float32),
        "img_pos_feat": rng.rand(B, R, 7).astype(np.float32),
        "txt_mask": (np.arange(T)[None] < txt_len[:, None]).astype(np.int32),
        "img_mask": (np.arange(R)[None] < img_len[:, None]).astype(np.int32),
    }
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}

    def fn(model: MemeUniter, batch):
        with torch.inference_mode():
            return model(batch, deterministic=True)

    return fn, (model, batch)


def mesh_configs(n: int) -> list:
    """The (shape, axes) meshes a dry run of ``n`` ranks runs."""
    if n % 8 == 0:
        return [((n // 4, 2, 2), ("fold", "data", "model")),
                ((n // 2, 2), ("fold", "data"))]
    if n % 2 == 0:
        return [((n // 2, 2), ("fold", "data"))]
    return [((n,), ("fold",))]


def _shared_dir(prefix: str) -> str:
    """A directory rank 0 makes and every rank gets the path of."""
    path = [tempfile.mkdtemp(prefix=prefix) if dist.get_rank() == 0
            else None]
    dist.broadcast_object_list(path, src=0)
    return path[0]


def dryrun_one_mesh(shape, axes, device) -> str:
    """The fold-parallel crossval driver on ``shape`` over ``axes``, on tiny
    synthetic data; returns rank 0's summary line (checks fail with
    RuntimeError)."""
    mesh = make_mesh(shape, axes, device.type)
    n_folds = shape[0]
    tmp = _shared_dir("dryrun_multichip_")
    try:
        # enough memes that the rarer label gives n_folds dev splits
        n_train = max(32, 20 * n_folds + 16)
        root = os.path.join(tmp, "data")
        if dist.get_rank() == 0:
            make_synthetic_dataset(root, n_train=n_train, n_dev=16, n_test=8,
                                   img_dim=32, label_signal=3.0)
        dist.barrier()
        synth = {"root": root, "feature_dir": os.path.join(root, "img_feats"),
                 "vocab": os.path.join(root, "vocab.txt")}
        tok = BertTokenizer(synth["vocab"])
        ucfg = UniterConfig(vocab_size=tok.vocab_size, hidden_size=32,
                            num_hidden_layers=2, num_attention_heads=2,
                            intermediate_size=64, img_dim=32,
                            max_position_embeddings=32,
                            use_pallas_attention=True)
        tcfg = TrainConfig(
            data_path=root, feature_path=synth["feature_dir"],
            model_path=os.path.join(tmp, "ck"), model_save_name="dry.ckpt",
            lr=3e-3, batch_size=8, max_epoch=2, patience=4, warmup_steps=2,
            gradient_accumulation=2, max_txt_len=12, max_bb=16, seed=43,
            pos_wt=1.8, scheduler="warmup_cosine", steps_per_dispatch=2)
        kwargs = dict(feature_dir=synth["feature_dir"], tokenizer=tok,
                      max_txt_len=12, max_bb=16, img_dim=32)
        loader_funcs = {
            "train": lambda p: BatchLoader(MemeDataset(p, **kwargs), 8,
                                           shuffle_data=True,
                                           index_batches=True),
            "val": lambda p: BatchLoader(MemeDataset(p, **kwargs), 8,
                                         index_batches=True),
            "test": lambda p: BatchLoader(
                MemeDataset(p, return_ids=True, **kwargs), 8,
                index_batches=True),
        }
        test_loaders = [loader_funcs["test"](os.path.join(root, n + ".jsonl"))
                        for n in ("test_seen", "dev_seen")]
        os.makedirs(tcfg.model_path, exist_ok=True)
        set_seed(tcfg.seed)
        results = train_crossval_fold_parallel(
            tcfg, lambda seed: init_meme_uniter(
                ucfg, 1, device, torch_generator(seed, device)),
            loader_funcs, test_loaders, num_folds=n_folds, dev_size=8,
            use_dev_set=False, ea_generations=3, device=device, mesh=mesh,
            resume_path=os.path.join(tcfg.model_path, "crossval_resume.pt"))
        dist.barrier()
        if dist.get_rank() != 0:
            return ""
        return _check(results, tcfg, n_folds, dict(zip(axes, shape)),
                      len(test_loaders))
    finally:
        dist.barrier()
        if dist.get_rank() == 0:
            shutil.rmtree(tmp, ignore_errors=True)


def _check(results, tcfg, n_folds: int, mesh: dict, n_tests: int) -> str:
    """JAX ``_dryrun_one_mesh``'s checks on rank 0: finite per-fold AUROC,
    a checkpoint a fold, every fold's val and test CSVs with one finite
    probability in [0, 1] a sample, and the ensemble search's result."""
    def need(cond, what):
        if not cond:
            raise RuntimeError("dry run on %s: %s" % (mesh, what))

    ck = tcfg.model_path
    need(len(results["val_metrics"]) == n_folds, "fold metrics")
    need(all(np.isfinite(m["aucroc"]) for m in results["val_metrics"]),
         "a fold's AUROC is not finite")
    need("ensemble" in results, "the ensemble search did not run")
    ckpts = sorted(os.path.basename(p)
                   for p in glob(os.path.join(ck, "dry_fold_*.ckpt")))
    need(len(ckpts) == n_folds, "checkpoints %s" % ckpts)
    csv_paths = sorted(glob(os.path.join(ck, "*_preds.csv")))
    need(len(csv_paths) == n_folds * (1 + n_tests),
         "%d CSVs" % len(csv_paths))
    sizes = {"test_seen": 8, "dev_seen": 16}
    checksum, n_rows = 0.0, 0
    for p in csv_paths:
        with open(p) as f:
            rows = list(csv.DictReader(f))
        need({"id", "proba", "label"} <= set(rows[0]), "columns of " + p)
        for split, n in sizes.items():
            if p.endswith("_%s_preds.csv" % split):
                need(len(rows) == n, "%d rows in %s" % (len(rows), p))
        probs = np.array([float(r["proba"]) for r in rows])
        need(np.isfinite(probs).all() and (probs >= 0).all()
             and (probs <= 1).all(), "probabilities of " + p)
        checksum += float(probs.sum())
        n_rows += len(rows)
    ens = {k: (round(v, 4) if isinstance(v, float) else "...")
           for k, v in list(results["ensemble"].items())[:4]}
    return ("dryrun_multichip OK: mesh=%s epochs>=%d fold_auc=%s "
            "fold_ckpts=%s csv_exports=%d csv_rows=%d "
            "csv_proba_checksum=%.4f ensemble=%s" % (
                mesh, tcfg.max_epoch,
                [round(m["aucroc"], 4) for m in results["val_metrics"]],
                ckpts, len(csv_paths), n_rows, checksum, ens))


def dryrun(device) -> None:
    """Every mesh of :func:`mesh_configs` over the process group's ranks."""
    for shape, axes in mesh_configs(dist.get_world_size()):
        line = dryrun_one_mesh(shape, axes, device)
        if line:
            print(line, flush=True)


def _rank_main(rank: int, world: int, store: str, device: str) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)
    initialize_distributed(device, init_method="file://" + store,
                           world_size=world, rank=rank, timeout=TIMEOUT)
    try:
        dryrun(resolve_device(device))
    finally:
        dist.destroy_process_group()


def spawn(n: int, device: str) -> None:
    """Run the dry run in ``n`` processes started here; raises if any
    fails."""
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="dryrun_store_")
    try:
        mp.start_processes(_rank_main,
                           args=(n, os.path.join(tmp, "store"), device),
                           nprocs=n, start_method="spawn")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--spawn", type=int, default=0,
                        help="start this many ranks here (without torchrun)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)
    resolve_device(args.device)
    if args.spawn:
        spawn(args.spawn, args.device)
    elif launched():
        initialize_distributed(args.device, timeout=TIMEOUT)
        try:
            dryrun(resolve_device(args.device))
        finally:
            dist.destroy_process_group()
    else:
        sys.exit("start the dry run under torchrun, or pass --spawn N")


if __name__ == "__main__":
    main()
