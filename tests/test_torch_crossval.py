"""PyTorch port, the crossval slice against the JAX package: the fold split
files (byte-identical, with and without dev_seen in the folds, and with
confounder groups in dev_seen), the driver's control flow on stand-in
trainers (the fold loop, the ``use_dev_set`` test-loader swap, the
keyboard-interrupt stop, the mean scores, the ensemble file choice), and
the port's CLI ``--num_folds 2`` against JAX ``build_entry`` +
``train_crossval(num_folds=2)``: the same artifacts, per-fold metrics and
CSVs, ensemble weights, threshold and ensemble CSVs."""
import json
import os
import shutil

import numpy as np
import pytest

from torch_parity import SMALL, flax_params

from meme_challenge_tpu.core.artifacts import export_predictions, load_predictions
from meme_challenge_tpu.core.config import TrainConfig, UniterConfig
from meme_challenge_tpu.core.seeding import set_seed
from meme_challenge_tpu.data.crossval_splits import (
    crossval_dir as jax_crossval_dir,
    generate_crossval_splits as jax_splits,
)
from meme_challenge_tpu.models.convert import save_reference_checkpoint
from meme_challenge_tpu.train import crossval_driver as JC
from meme_challenge_tpu.train.train_uniter import build_entry
from meme_challenge_tpu.utils.synthetic import make_synthetic_dataset
from meme_challenge_tpu_torch.core.config import TrainConfig as PortConfig
from meme_challenge_tpu_torch.data.crossval_splits import (
    crossval_dir,
    generate_crossval_splits,
)
from meme_challenge_tpu_torch.train import crossval_driver as TC
from meme_challenge_tpu_torch.train import train_uniter as port_cli

DEV_SIZE = 8


def _copy_sources(src, dst):
    os.makedirs(dst)
    for name in ("train.jsonl", "dev_seen.jsonl"):
        shutil.copy(os.path.join(src, name), os.path.join(dst, name))
    return str(dst)


def _assert_same_split_files(jax_root, port_root, use_dev):
    a = jax_crossval_dir(jax_root, DEV_SIZE, use_dev)
    b = crossval_dir(port_root, DEV_SIZE, use_dev)
    assert os.path.basename(a) == os.path.basename(b)
    files = sorted(os.listdir(a))
    assert files == sorted(os.listdir(b)) and files
    for name in files:
        with open(os.path.join(a, name), "rb") as fa, \
                open(os.path.join(b, name), "rb") as fb:
            assert fa.read() == fb.read(), name
    return files


@pytest.mark.parametrize("use_dev", [False, True],
                         ids=["train_only", "dev_seen_in_folds"])
def test_splits_byte_identical_to_jax(tmp_path, use_dev):
    synth = make_synthetic_dataset(str(tmp_path / "d"), n_train=48, n_dev=20,
                                   n_test=4, img_dim=4, seed=11)
    j = _copy_sources(synth["root"], tmp_path / "jax")
    p = _copy_sources(synth["root"], tmp_path / "port")
    assert jax_splits(j, DEV_SIZE, use_dev) == jax_crossval_dir(
        j, DEV_SIZE, use_dev)
    assert generate_crossval_splits(p, DEV_SIZE, use_dev) == crossval_dir(
        p, DEV_SIZE, use_dev)
    files = _assert_same_split_files(j, p, use_dev)
    n_folds = sum(f.startswith("train_") for f in files)
    assert n_folds >= 2
    assert sum(f.startswith("dev_seen_") for f in files) == (
        n_folds if use_dev else 0)


def test_splits_with_dev_confounders_byte_identical_to_jax(tmp_path):
    """Confounder groups in dev_seen (duplicated texts): the coin flip with
    its short-circuit, and the float64 count that survives where the
    reference crashes (the case of tests/test_data.py)."""
    rng = np.random.RandomState(3)
    src = tmp_path / "src"
    src.mkdir()
    for name, n in [("train", 60), ("dev_seen", 20)]:
        recs = []
        for i in range(n):
            if name == "dev_seen" and i >= n - 4:
                text = "confounder %i" % ((i - (n - 4)) // 2)
            else:
                text = "text %s %i" % (name, i)
            recs.append({"id": 30000 + i + (0 if name == "train" else 1000),
                         "img": "img/x.png", "label": int(rng.randint(0, 2)),
                         "text": text})
        with open(src / ("%s.jsonl" % name), "w") as f:
            f.write("\n".join(json.dumps(r) for r in recs))
    j = _copy_sources(str(src), tmp_path / "jax")
    p = _copy_sources(str(src), tmp_path / "port")
    jax_splits(j, DEV_SIZE, True)
    generate_crossval_splits(p, DEV_SIZE, True)
    files = _assert_same_split_files(j, p, True)
    # the groups stay together in each fold's half of dev_seen
    for name in files:
        if name.startswith("dev_seen_"):
            with open(os.path.join(crossval_dir(p, DEV_SIZE, True),
                                   name)) as f:
                texts = [json.loads(line)["text"] for line in f]
            assert all(texts.count(t) == (2 if t.startswith("confounder")
                                          else 1) for t in texts)


# ------------------------------------------------- driver on stand-in trainers

class _Loader:
    def __init__(self, path):
        self.path = path
        self.dataset = type("D", (), {"name": os.path.basename(path)
                                      .split(".")[0]})()


class _FakeTrainer:
    """Writes the CSVs a fold's Trainer writes, from its split files, with
    probabilities drawn from the fold's seed; ``interrupt_at`` raises
    KeyboardInterrupt in that fold."""

    def __init__(self, cfg, train, val, tests, interrupt_at, log):
        self.cfg, self.val, self.tests = cfg, val, tests
        self.interrupt_at, self.log = interrupt_at, log

    def train_main(self):
        fold = int(self.cfg.model_save_name.split("_fold_")[1].split(".")[0])
        self.log.append((fold, self.cfg.seed, self.val.dataset.name,
                         sorted(t.dataset.name for t in self.tests)))
        if fold == self.interrupt_at:
            raise KeyboardInterrupt
        rng = np.random.RandomState(self.cfg.seed)
        base = self.cfg.model_save_name.rsplit(".", 1)[0]
        for loader in [self.val] + self.tests:
            with open(loader.path) as f:
                recs = [json.loads(line) for line in f if line.strip()]
            ids = np.array([r["id"] for r in recs])
            p = rng.rand(len(recs))
            gt = (np.array([r["label"] for r in recs])
                  if all("label" in r for r in recs) else None)
            export_predictions(
                os.path.join(self.cfg.model_path, "%s_%s_preds.csv"
                             % (base, loader.dataset.name)),
                ids, p, (p > 0.5).astype(int), gt)
        return {"aucroc": rng.rand(), "loss": rng.rand()}, {}


def _fake_run(driver, config_cls, synth, root, use_dev, interrupt_at, **kw):
    shutil.copytree(synth["root"], root)
    cfg = config_cls(data_path=root, model_path=root,
                     model_save_name="fake.ckpt", seed=5)
    log = []

    def factory(c, train, val, tests):
        return _FakeTrainer(c, train, val, tests, interrupt_at, log)

    loaders = {k: _Loader for k in ("train", "val", "test")}
    tests = [_Loader(os.path.join(root, n + ".jsonl"))
             for n in ("test_seen", "dev_seen", "dev_unseen")]
    set_seed(5)
    res = driver.train_crossval(factory, cfg, loaders, tests, num_folds=-1,
                                dev_size=DEV_SIZE, use_dev_set=use_dev,
                                ea_generations=20, **kw)
    return res, log


@pytest.mark.parametrize("use_dev,interrupt_at", [
    (True, None), (False, None), (True, 1)],
    ids=["dev_seen_in_folds", "train_only", "interrupt_second_fold"])
def test_driver_matches_jax_on_stand_in_trainers(tmp_path, use_dev,
                                                 interrupt_at):
    synth = make_synthetic_dataset(str(tmp_path / "d"), n_train=48, n_dev=20,
                                   n_test=6, img_dim=4, seed=11)
    ref, ref_log = _fake_run(JC, TrainConfig, synth, str(tmp_path / "jax"),
                             use_dev, interrupt_at)
    res, log = _fake_run(TC, PortConfig, synth, str(tmp_path / "port"),
                         use_dev, interrupt_at, device="cpu")
    assert log == ref_log
    n_folds = 1 if interrupt_at == 1 else len(log)
    assert len(res["val_metrics"]) == n_folds
    assert [f[1] for f in log] == [5 + i for i in range(len(log))]
    if use_dev:  # each fold tests on its own half of dev_seen
        assert all("dev_seen" not in f[3] and "dev_seen_%02d" % f[0] in f[3]
                   for f in log)
    assert res["val_metrics"] == ref["val_metrics"]
    assert res["mean_scores"] == ref["mean_scores"]
    assert res["ensemble"]["config"] == ref["ensemble"]["config"]
    # the threshold is a midpoint of two fp32 mixes: equal to rounding
    assert abs(res["ensemble"]["threshold"]
               - ref["ensemble"]["threshold"]) <= 1e-6
    ens = sorted(f for f in os.listdir(tmp_path / "port")
                 if f.endswith("_ensemble.csv"))
    assert ens == sorted(f for f in os.listdir(tmp_path / "jax")
                         if f.endswith("_ensemble.csv"))
    assert len(ens) == 3


def test_driver_ensemble_defaults_to_cuda(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        TC.train_crossval(None, PortConfig(), {}, num_folds=2)


# ---------------------------------------------------------------- the CLI

NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
NAME = "cv.ckpt"
KW = dict(model_save_name=NAME, max_epoch=2, patience=5, lr=3e-3,
          warmup_steps=2, gradient_accumulation=2, confounder_repeat=3,
          pos_wt=1.8, batch_size=4, max_txt_len=8, max_bb=8, seed=7,
          num_folds=2, crossval_dev_size=DEV_SIZE, adam_mu_dtype="float32",
          adam_nu_dtype="float32")


def _run_jax(synth, model_path, ckpt, kw):
    set_seed(7)
    cfg = TrainConfig(data_path=synth["root"],
                      feature_path=synth["feature_dir"],
                      model_path=model_path, pretrained_model_file=ckpt, **kw)
    lf, tl, tf = build_entry(
        cfg, UniterConfig(**SMALL, use_pallas_attention=True, **NO_DROPOUT),
        synth["vocab"])
    return JC.train_crossval(tf, cfg, lf, tl, num_folds=2,
                             dev_size=DEV_SIZE,
                             use_dev_set=cfg.crossval_use_dev)


def _run_port(synth, model_path, ckpt, kw, tmp_path):
    ucfg_path = str(tmp_path / "uniter.json")
    with open(ucfg_path, "w") as f:
        json.dump(dict(SMALL, use_pallas_attention=True, **NO_DROPOUT), f)
    argv = ["--vocab_file", synth["vocab"], "--uniter_config", ucfg_path,
            "--device", "cpu", "--data_path", synth["root"],
            "--feature_path", synth["feature_dir"], "--model_path",
            model_path, "--pretrained_model_file", ckpt]
    for k, v in kw.items():
        if isinstance(v, bool):
            argv.append("--%s" % k if v else "--no-%s" % k)
        else:
            argv += ["--%s" % k, str(v)]
    return port_cli.main(argv)


@pytest.mark.parametrize("use_dev", [False, True],
                         ids=["train_only", "dev_seen_in_folds"])
def test_port_cli_crossval_matches_jax(tmp_path, use_dev):
    """Two folds of 2 epochs each from one reference torch checkpoint,
    dropout off, then the ensemble (brute force and the host EA on the CPU
    in both packages)."""
    kw = dict(KW, crossval_use_dev=use_dev)
    ckpt = str(tmp_path / "start.pt")
    save_reference_checkpoint(ckpt, flax_params())
    runs, synths = {}, {}
    for who in ("jax", "port"):
        # one dataset each (the same seed): the splits land in data_path
        synths[who] = make_synthetic_dataset(
            str(tmp_path / ("data_" + who)), n_train=40, n_dev=20, n_test=9,
            img_dim=SMALL["img_dim"], seed=3, label_signal=0.7)
        model_path = str(tmp_path / who)
        if who == "jax":
            runs[who] = _run_jax(synths[who], model_path, ckpt, kw)
        else:
            runs[who] = _run_port(synths[who], model_path, ckpt, kw,
                                  tmp_path)
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    _assert_same_split_files(synths["jax"]["root"], synths["port"]["root"],
                             use_dev)

    files = sorted(os.listdir(jax_dir))
    assert files == sorted(os.listdir(port_dir))
    for fold in (0, 1):
        assert "cv_fold_%d.ckpt" % fold in files
        assert "cv_fold_%d_metrics.json" % fold in files
    assert len([f for f in files if f.endswith("_ensemble.csv")]) == 4

    jv, pv = runs["jax"]["val_metrics"], runs["port"]["val_metrics"]
    assert len(jv) == len(pv) == 2
    for a, b in zip(jv, pv):
        assert set(a) == set(b)
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-5, (k, a[k], b[k])
    for k, v in runs["jax"]["mean_scores"].items():
        assert abs(runs["port"]["mean_scores"][k] - v) <= 1e-5, k
    for fold in (0, 1):
        with open(os.path.join(jax_dir, "cv_fold_%d_metrics.json" % fold)) as f:
            mj = json.load(f)
        with open(os.path.join(port_dir, "cv_fold_%d_metrics.json" % fold)) as f:
            mp = json.load(f)
        assert set(mj) == set(mp) == {"dev", "train", "test"}
        assert set(mj["test"]) == set(mp["test"])
        for part in ("dev", "train"):
            for k, v in mj[part].items():
                assert abs(mp[part][k] - v) <= 1e-5, (fold, part, k)

    ens_j, ens_p = runs["jax"]["ensemble"], runs["port"]["ensemble"]
    assert ens_p["config"] == ens_j["config"]
    assert abs(ens_p["threshold"] - ens_j["threshold"]) <= 1e-6
    assert abs(ens_p["score"] - ens_j["score"]) <= 1e-6
    t = ens_j["threshold"]
    for name in files:
        if not name.endswith(".csv"):
            continue
        a = load_predictions(os.path.join(jax_dir, name))
        b = load_predictions(os.path.join(port_dir, name))
        assert list(a) == list(b), name
        np.testing.assert_array_equal(a["id"], b["id"])
        if "gt" in a:
            np.testing.assert_array_equal(a["gt"], b["gt"])
        np.testing.assert_allclose(b["proba"], a["proba"], atol=2e-6, rtol=0,
                                   err_msg=name)
        if name.endswith("_ensemble.csv"):
            away = np.abs(a["proba"] - t) > 2e-6
            np.testing.assert_array_equal(a["label"][away], b["label"][away])
