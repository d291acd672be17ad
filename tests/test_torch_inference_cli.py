"""PyTorch port, train/train_uniter.py: the inference command (``--max_epoch 0``
with an existing checkpoint) and a fine-tune (``--max_epoch 3``) against the
JAX package's runs of the same configuration.

One flax parameter tree is written twice: as the JAX ``ModelSaver``'s msgpack
and as a reference torch checkpoint. JAX runs through ``build_entry`` +
``train_crossval(max_epoch=0)`` (as tests/test_inference_mode.py does; its
``main()`` would flip the PRNG implementation for the whole worker); the port
runs through its CLI ``main([..., '--device', 'cpu'])``. The same CSV files
must come out with equal ids and gt, probabilities within 2e-6 and equal
labels away from the thresholds, and the same metrics JSON within 1e-5.

The fine-tune starts both packages from one reference torch checkpoint given
as ``--pretrained_model_file``, with dropout off and ``set_seed`` before each
run (the confounder sampler draws the same order), and compares the scalar
logs (epoch losses, validation AUROC, the early-stop epoch), the CSVs and
the metrics JSON."""
import json
import os

import numpy as np
import pytest

from torch_parity import SMALL, flax_params

from meme_challenge_tpu.core.artifacts import load_predictions
from meme_challenge_tpu.core.config import TrainConfig, UniterConfig
from meme_challenge_tpu.core.metrics import find_optimal_threshold
from meme_challenge_tpu.core.seeding import set_seed
from meme_challenge_tpu.models.convert import save_reference_checkpoint
from meme_challenge_tpu.train.checkpoint import ModelSaver
from meme_challenge_tpu.train.crossval_driver import train_crossval
from meme_challenge_tpu.train.train_uniter import build_entry
from meme_challenge_tpu.utils.synthetic import make_synthetic_dataset
from meme_challenge_tpu_torch.train import train_uniter as port_cli

NAME = "inf.ckpt"


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth")
    return make_synthetic_dataset(str(root / "d"), n_train=12, n_dev=10,
                                  n_test=9, img_dim=SMALL["img_dim"], seed=3)


def _base(synth, model_path, **kw):
    return dict(dict(data_path=synth["root"],
                     feature_path=synth["feature_dir"], model_path=model_path,
                     model_save_name=NAME, batch_size=4, max_txt_len=8,
                     max_bb=8, seed=7, max_epoch=0, num_folds=0), **kw)


def _run_jax(synth, model_path, attention, **kw):
    params = flax_params()
    os.makedirs(model_path, exist_ok=True)
    ModelSaver(os.path.join(model_path, NAME)).save(params)
    set_seed(7)
    cfg = TrainConfig(**_base(synth, model_path, **kw))
    ucfg = UniterConfig(**SMALL, **attention)
    lf, tl, tf = build_entry(cfg, ucfg, synth["vocab"])
    train_crossval(tf, cfg, lf, tl, num_folds=0)


def _run_port(synth, model_path, attention, tmp_path, **kw):
    os.makedirs(model_path, exist_ok=True)
    save_reference_checkpoint(os.path.join(model_path, NAME), flax_params())
    ucfg_path = str(tmp_path / "uniter.json")
    with open(ucfg_path, "w") as f:
        json.dump(dict(SMALL, **attention), f)
    argv = ["--vocab_file", synth["vocab"], "--uniter_config", ucfg_path,
            "--device", "cpu"]
    for k, v in _base(synth, model_path, **kw).items():
        if isinstance(v, bool):
            argv.append("--%s" % k if v else "--no-%s" % k)
        else:
            argv += ["--%s" % k, str(v)]
    return port_cli.main(argv)


def _assert_close(a, b, tol=1e-5, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_close(a[k], b[k], tol, path + "/" + k)
    else:
        assert abs(float(a) - float(b)) <= tol, (path, a, b)


@pytest.mark.parametrize("attention,resident", [
    ({"use_pallas_attention": True}, False),
    ({}, True),
], ids=["fused-host_batches", "plain-device_resident"])
def test_port_cli_matches_jax_inference(synth, tmp_path, attention, resident):
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    _run_jax(synth, jax_dir, attention, device_resident_data=resident)
    val, test = _run_port(synth, port_dir, attention, tmp_path,
                          device_resident_data=resident)
    assert dict(val) == {}
    assert set(test) == {"test_seen", "test_unseen", "dev_seen", "dev_unseen"}

    csvs = sorted(f for f in os.listdir(jax_dir) if f.endswith(".csv"))
    assert csvs == sorted(f for f in os.listdir(port_dir)
                          if f.endswith(".csv"))
    assert len(csvs) == 4
    dev = load_predictions(os.path.join(jax_dir, "inf_dev_seen_preds.csv"))
    t_opt = find_optimal_threshold(dev["proba"], dev["gt"])
    for name in csvs:
        a = load_predictions(os.path.join(jax_dir, name))
        b = load_predictions(os.path.join(port_dir, name))
        assert set(a) == set(b), name
        np.testing.assert_array_equal(a["id"], b["id"])
        if "gt" in a:
            np.testing.assert_array_equal(a["gt"], b["gt"])
        np.testing.assert_allclose(b["proba"], a["proba"], atol=2e-6, rtol=0)
        away = ((np.abs(a["proba"] - 0.5) > 1e-5)
                & (np.abs(a["proba"] - t_opt) > 1e-5))
        np.testing.assert_array_equal(a["label"][away], b["label"][away])

    with open(os.path.join(jax_dir, "inf_metrics.json")) as f:
        m_jax = json.load(f)
    with open(os.path.join(port_dir, "inf_metrics.json")) as f:
        m_port = json.load(f)
    assert m_port["dev"] == {"loss": 1000.0}
    assert m_port["train"] == {"loss": 0.0}
    _assert_close(m_port, m_jax)


@pytest.mark.parametrize("flag,match", [
    ({"pretrained_model_file": "flax.msgpack"}, "msgpack"),
])
def test_port_cli_later_slices_raise(synth, tmp_path, flag, match):
    """The CLI reads the JAX package's flax-msgpack dumps (models/convert.py
    holds the weights to JAX's), and refuses a file that is neither a torch
    checkpoint nor msgpack rather than misread it."""
    ModelSaver(str(tmp_path / "flax.msgpack")).save(flax_params())
    _run_port(synth, str(tmp_path / "p"), {}, tmp_path, max_epoch=1,
              **{k: str(tmp_path / v) for k, v in flag.items()})
    bad = tmp_path / "bad"
    bad.write_bytes(b"\xc1 neither torch nor msgpack")
    with pytest.raises(ValueError, match=match):
        _run_port(synth, str(tmp_path / "q"), {}, tmp_path, max_epoch=1,
                  **{k: str(bad) for k in flag})


def test_port_eval_model_matches_jax_trainer(synth):
    """Trainer.eval_model (metrics + mean per-batch loss) on dev_seen."""
    import torch

    from meme_challenge_tpu_torch.core.config import (
        TrainConfig as PortTrainConfig,
        UniterConfig as PortUniterConfig,
    )
    from meme_challenge_tpu_torch.models.convert import (
        meme_uniter_state_from_jax,
    )

    kw = dict(_base(synth, "unused"), pos_wt=1.8)
    cfg = TrainConfig(**kw)
    lf, _, tf = build_entry(cfg, UniterConfig(**SMALL), synth["vocab"])
    dev = os.path.join(synth["root"], "dev_seen.jsonl")
    jax_trainer = tf(cfg, None, lf["val"](dev), [])
    jax_trainer.state = jax_trainer.state._replace(params=flax_params())
    m_jax, loss_jax = jax_trainer.eval_model(jax_trainer.val_loader)

    pcfg = PortTrainConfig(**kw)
    plf, _, ptf = port_cli.build_entry(pcfg, PortUniterConfig(**SMALL),
                                       synth["vocab"], device="cpu")
    port_trainer = ptf(pcfg, None, plf["val"](dev), [])
    port_trainer.model.load_state_dict(
        meme_uniter_state_from_jax(flax_params()), strict=True)
    with torch.no_grad():
        m_port, loss_port = port_trainer.eval_model(port_trainer.val_loader)
    _assert_close(m_port, m_jax)
    assert abs(loss_port - loss_jax) <= 1e-5


# ------------------------------------------------------------------ training

NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
TRAIN_NAME = "ft.ckpt"
# tolerance on every compared number (scalars, probabilities, metrics):
# fp32 Adam moments follow JAX to fp32 rounding over the run (scalars seen
# within 9e-8); bf16 moments round to bf16 after each update, and an element
# whose fp32 moment differs by an ulp can land on the neighbouring bf16
# value, which then propagates (seen: 1.5e-6). The CSVs carry probabilities
# to 6 decimals.
TRAIN_TOL = {"float32": 1e-5, "bfloat16": 1e-4}


@pytest.fixture(scope="module")
def synth_train(tmp_path_factory):
    # 22 train memes, confounder repeat 3, batch 4, accumulation 2: the
    # epoch ends on a short accumulation group that is padded
    root = tmp_path_factory.mktemp("synth_train")
    return make_synthetic_dataset(str(root / "d"), n_train=22, n_dev=10,
                                  n_test=9, img_dim=SMALL["img_dim"], seed=5,
                                  label_signal=0.7)


def _scalars(path):
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return {(r["name"], r["step"]): r["value"] for r in rows
            if not r["name"].startswith("Stats/time")}


@pytest.mark.parametrize("resident,moments", [
    (False, "float32"), (True, "bfloat16")],
    ids=["host_batches-fp32_moments", "device_resident-bf16_moments"])
def test_port_cli_finetune_matches_jax(synth_train, tmp_path, resident,
                                       moments):
    synth = synth_train
    ckpt = str(tmp_path / "start.pt")
    save_reference_checkpoint(ckpt, flax_params())
    attention = dict(NO_DROPOUT, use_pallas_attention=True)
    kw = dict(model_save_name=TRAIN_NAME, max_epoch=3, patience=1,
              lr=3e-3, warmup_steps=2, gradient_accumulation=2,
              confounder_repeat=3, pos_wt=1.8, pretrained_model_file=ckpt,
              device_resident_data=resident, adam_mu_dtype=moments,
              adam_nu_dtype=moments)
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    runs = {}
    for name, model_path in (("jax", jax_dir), ("port", port_dir)):
        vis = str(tmp_path / ("vis_" + name))
        if name == "jax":
            set_seed(7)
            cfg = TrainConfig(**_base(synth, model_path, vis_path=vis, **kw))
            lf, tl, tf = build_entry(cfg, UniterConfig(**SMALL, **attention),
                                     synth["vocab"])
            runs[name] = train_crossval(tf, cfg, lf, tl, num_folds=0)
        else:  # the port's main() seeds itself, as the JAX CLI does
            runs[name] = _run_port(synth, model_path, attention, tmp_path,
                                   vis_path=vis, **kw)
    tol = TRAIN_TOL[moments]

    s_jax = _scalars(str(tmp_path / "vis_jax" / "ft" / "scalars.jsonl"))
    s_port = _scalars(str(tmp_path / "vis_port" / "ft" / "scalars.jsonl"))
    assert set(s_port) == set(s_jax)
    for key, value in s_jax.items():
        assert abs(s_port[key] - value) <= tol, (key, s_port[key], value)
    # validation AUROC falls in epoch 2, so patience 1 stops there
    epochs = sorted(step for name, step in s_jax if name == "Validation/Loss")
    assert epochs == [1, 2]
    losses = [s_jax[k] for k in sorted(s_jax) if k[0] == "Train/Epoch_Loss"]
    assert losses[-1] < losses[0]  # it trained

    csvs = sorted(f for f in os.listdir(jax_dir) if f.endswith(".csv"))
    assert csvs == sorted(f for f in os.listdir(port_dir)
                          if f.endswith(".csv"))
    assert len(csvs) == 4
    for name in csvs:
        a = load_predictions(os.path.join(jax_dir, name))
        b = load_predictions(os.path.join(port_dir, name))
        np.testing.assert_array_equal(a["id"], b["id"])
        np.testing.assert_allclose(b["proba"], a["proba"], atol=tol, rtol=0)
    with open(os.path.join(jax_dir, "ft_metrics.json")) as f:
        m_jax = json.load(f)
    with open(os.path.join(port_dir, "ft_metrics.json")) as f:
        m_port = json.load(f)
    assert set(m_port) == {"dev", "train", "test"}
    _assert_close(m_port, m_jax, tol)
