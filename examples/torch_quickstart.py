"""Quickstart of the PyTorch port: the full pipeline on synthetic data, no
downloads needed.

    python examples/torch_quickstart.py /tmp/torch_quickstart            # card
    python examples/torch_quickstart.py /tmp/torch_quickstart --device cpu

1. generates a synthetic meme dataset (jsonl + .npy feature pairs + vocab),
2. trains a tiny UNITER on 2 crossval folds (sequential driver),
3. searches ensemble weights over the per-fold CSVs,
4. re-runs the same folds FOLD-STACKED in this process (one FoldStack
   trained by ``FoldParallelTrainer``, no process group).

On the CPU it takes about a minute. A fold × data mesh of several processes
runs through the CLI under torchrun, one process a card (gloo with
``--device cpu``):

    torchrun --nproc_per_node 4 -m meme_challenge_tpu_torch.train.train_uniter \\
        --data_path DATA --feature_path DATA/img_feats --vocab_file VOCAB \\
        --uniter_config configs/uniter-base.json --num_folds -1 \\
        --mesh_shape 2,2 --mesh_axes fold,data

Swap the tiny config for ``configs/uniter-base.json`` (or
``configs/uniter-large.json``), point at real Hateful-Memes features
(``extract/extract_features.py`` + ``tools/convert_feature_export.py``) and a
real vocab to reproduce the reference recipe (see README.md).
"""
import argparse
import os
import sys

# allow `python examples/torch_quickstart.py` without installing the package
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from meme_challenge_tpu_torch.core.config import TrainConfig, UniterConfig
from meme_challenge_tpu_torch.core.device import resolve_device
from meme_challenge_tpu_torch.core.seeding import set_seed, torch_generator
from meme_challenge_tpu_torch.models.uniter import init_meme_uniter
from meme_challenge_tpu_torch.parallel.crossval_parallel import (
    train_crossval_fold_parallel,
)
from meme_challenge_tpu_torch.train.crossval_driver import train_crossval
from meme_challenge_tpu_torch.train.train_uniter import build_entry
from meme_challenge_tpu_torch.utils.synthetic import make_synthetic_dataset


def main(root: str, device: str = "cuda") -> dict:
    device = resolve_device(device)
    print("== 1. synthetic dataset")
    synth = make_synthetic_dataset(os.path.join(root, "data"), n_train=48,
                                   n_dev=16, n_test=8, img_dim=64,
                                   label_signal=3.0)

    ucfg = UniterConfig(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=2, intermediate_size=64,
                        img_dim=64, max_position_embeddings=32)
    tcfg = TrainConfig(
        data_path=synth["root"], feature_path=synth["feature_dir"],
        model_path=os.path.join(root, "ckpt"), model_save_name="quick.ckpt",
        lr=3e-3, batch_size=8, max_epoch=2, patience=3, warmup_steps=2,
        gradient_accumulation=1, pos_wt=1.2, confounder_repeat=2,
        max_txt_len=12, max_bb=16, seed=43, crossval_dev_size=8)

    print("== 2. sequential 2-fold crossval + ensemble")
    os.makedirs(tcfg.model_path, exist_ok=True)
    set_seed(tcfg.seed)
    loader_funcs, test_loaders, trainer_factory = build_entry(
        tcfg, ucfg, synth["vocab"], device)
    results = train_crossval(trainer_factory, tcfg, loader_funcs,
                             test_loaders, num_folds=2, dev_size=8,
                             ea_generations=3, device=device)
    print("   mean fold AUROC: %.3f" % results["mean_scores"]["aucroc"])
    print("   ensemble: %.3f with %s" % (
        results["ensemble"]["score"],
        ["%.2f" % w for w in results["ensemble"]["config"]["weights"]]))

    print("== 3. the same folds fold-stacked in one process")
    tcfg_fp = tcfg.replace(model_path=os.path.join(root, "ckpt_fp"))
    os.makedirs(tcfg_fp.model_path, exist_ok=True)

    def init_model_fn(seed):
        return init_meme_uniter(ucfg, 1, device,
                                torch_generator(seed, device))

    fp = train_crossval_fold_parallel(
        tcfg_fp, init_model_fn, loader_funcs, test_loaders, num_folds=2,
        dev_size=8, ea_generations=3, device=device)
    print("   fold-stacked mean AUROC: %.3f" % fp["mean_scores"]["aucroc"])
    print("== done; artifacts in", root)
    return {"sequential": results, "fold_stacked": fp}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("out_dir", nargs="?", default="/tmp/torch_quickstart")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args()
    main(args.out_dir, args.device)
