"""PyTorch port, the Oscar slice: ``models/oscar.py``, the Oscar converters
of ``models/convert.py`` and ``train/train_oscar.py``, against the JAX
package in the same process at a small width (hidden 32, 4 heads, 2
layers, 16-d stored features + 6-d geometry = 22-d Oscar features), JAX's
weights carried across with ``oscar_state_from_jax``.

- Logits, the loss and every gradient against JAX
  ``ImageBertForSequenceClassification``: the linear and the MLP head, the
  image LayerNorm on (its own eps) and off, on the plain attention branch
  and on the fused one (the port's plain kernel versions against JAX's
  Pallas kernels in interpret mode, per-sample and pair-blocked): logits
  within 1e-5, gradients within 2e-5 of the gradient's largest magnitude.
- The host-assembled 22-d input and the in-graph assembly from the raw
  (16-d, 7-d) pair give equal logits.
- ``oscar_state_from_torch`` on a reference-layout state dict (both heads,
  the image LayerNorm, TF-era gamma/beta names, extra keys) gives the logits
  JAX ``oscar_params_from_torch`` gives.
- ``build_oscar_entry`` against JAX's with host batches and with
  ``--device_resident_data`` (dropout off, JAX's initial weights carried
  into the port by a monkeypatched init): scalars, CSVs and metrics JSON
  within 1e-5, and the two port modes equal, as tests/test_tools_oscar.py
  holds JAX's two modes together.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meme_challenge_tpu.core.config import TrainConfig as JaxTrainConfig
from meme_challenge_tpu.core.config import UniterConfig as JaxUniterConfig
from meme_challenge_tpu.core.seeding import set_seed as jax_set_seed
from meme_challenge_tpu.models import oscar as JOS
from meme_challenge_tpu.models.convert import oscar_params_from_torch
from meme_challenge_tpu.train import train_oscar as JTO
from meme_challenge_tpu.train.crossval_driver import (
    train_crossval as jax_train_crossval,
)
from meme_challenge_tpu.train.losses import make_loss_fn as jax_loss_fn
from meme_challenge_tpu.utils.synthetic import make_synthetic_dataset
from meme_challenge_tpu_torch.core.config import TrainConfig, UniterConfig
from meme_challenge_tpu_torch.core.seeding import set_seed
from meme_challenge_tpu_torch.models import oscar as POS
from meme_challenge_tpu_torch.models.convert import (
    oscar_state_from_jax,
    oscar_state_from_torch,
)
from meme_challenge_tpu_torch.train import train_oscar as PTO
from meme_challenge_tpu_torch.train.crossval_driver import train_crossval
from meme_challenge_tpu_torch.train.losses import make_loss_fn

from test_torch_text_models import (  # noqa: F401 (threefry: a fixture)
    _assert_runs_match,
    _grad_worst,
    threefry,
)

SMALL = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=64, img_dim=22,
             max_position_embeddings=32, initializer_range=0.2)
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
ATTENTION = {"plain": {}, "fused": dict(use_pallas_attention=True),
             "fused_blocked": dict(use_pallas_attention=True,
                                   pallas_blocked=True)}
IMG_LN_EPS = 1e-5  # the image LayerNorm's own eps (encoder: 1e-12)


def _batch(seed=0, B=3, T=8, R=6, stored=16):
    """Padded text and boxes; the raw 16-d features and 7-d geometry."""
    rng = np.random.RandomState(seed)
    return {
        "input_ids": rng.randint(0, 64, (B, T)).astype(np.int32),
        "txt_mask": (np.arange(T)[None] < np.array([T, 5, 3])[:B, None]
                     ).astype(np.int32),
        "img_feat": rng.randn(B, R, stored).astype(np.float16),
        "img_pos_feat": rng.rand(B, R, 7).astype(np.float32),
        "img_mask": (np.arange(R)[None] < np.array([R, 4, 2])[:B, None]
                     ).astype(np.int32),
    }


def _assembled(batch):
    """The host assembly of train_oscar.OscarBatchLoader."""
    out = dict(batch)
    out["img_feat"] = np.concatenate(
        [batch["img_feat"], batch["img_pos_feat"][..., :6]], axis=-1)
    del out["img_pos_feat"]
    return out


def _models(classifier, img_ln, attention="plain", seed=0):
    """The JAX model and its init (numpy leaves), and the port's model with
    those weights."""
    ln = dict(use_img_layernorm=img_ln,
              img_layer_norm_eps=IMG_LN_EPS if img_ln else None)
    cfg = dict(SMALL, **ATTENTION[attention])
    jmodel = JOS.ImageBertForSequenceClassification(
        JaxUniterConfig(**cfg), num_labels=2, classifier=classifier,
        img_feature_dim=22, **ln)
    batch = {k: jnp.asarray(v) for k, v in _assembled(_batch()).items()}
    params = jax.tree_util.tree_map(np.asarray, jmodel.init(
        jax.random.key(seed, impl="threefry2x32"), batch)["params"])
    pmodel = POS.ImageBertForSequenceClassification(
        UniterConfig(**cfg), num_labels=2, classifier=classifier,
        img_feature_dim=22, **ln)
    pmodel.load_state_dict(oscar_state_from_jax(params), strict=True)
    return jmodel, params, pmodel.eval()


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("classifier,img_ln,attention", [
    ("linear", False, "plain"), ("mlp", False, "plain"),
    ("linear", True, "plain"), ("mlp", True, "plain"),
    ("linear", False, "fused"), ("mlp", True, "fused"),
    ("mlp", False, "fused_blocked")])
def test_logits_and_gradients_match_jax(classifier, img_ln, attention):
    """Logits within 1e-5; the ce loss (one sample masked out) within 2e-5
    relative and every gradient within 2e-5 of its largest magnitude, the
    image projection, the image LayerNorm and both heads included."""
    jmodel, params, pmodel = _models(classifier, img_ln, attention)
    batch = dict(_assembled(_batch(seed=1)), labels=np.array([1, 0, 1]),
                 sample_mask=np.array([1, 1, 0]))
    jloss = jax_loss_fn("ce")

    @jax.jit
    def value_and_grad(p, b):
        def f(p):
            logits = jmodel.apply({"params": p}, b)
            return jloss(logits, b["labels"], b["sample_mask"])[0], logits
        return jax.value_and_grad(f, has_aux=True)(p)

    (loss_j, logits_j), grads_j = value_and_grad(params, _j(batch))
    want = {k: v.numpy() for k, v in oscar_state_from_jax(
        jax.tree_util.tree_map(np.asarray, grads_j)).items()}
    b = _t(batch)
    logits_p = pmodel(b)
    np.testing.assert_allclose(logits_p.detach().numpy(),
                               np.asarray(logits_j), atol=1e-5, rtol=0)
    loss_p, _ = make_loss_fn("ce")(logits_p, b["labels"], b["sample_mask"])
    loss_p.backward()
    got = {n: p.grad.numpy() for n, p in pmodel.named_parameters()}
    assert set(got) == set(want)
    assert abs(loss_p.item() - float(loss_j)) <= 2e-5 * abs(float(loss_j))
    worst, where = _grad_worst(got, want)
    assert worst <= 2e-5, (worst, where)


def test_in_graph_assembly_equals_host_assembly():
    """The device-resident form (raw 16-d features + 7-d geometry, as
    steps.gather_micro gathers them) and the loader's 22-d assembly give
    equal logits, and the features equal JAX's oscar_batch_features."""
    _, _, pmodel = _models("linear", False)
    raw = _batch(seed=2)
    with torch.no_grad():
        host = pmodel(_t(_assembled(raw)))
        graph = pmodel(_t(raw))
    np.testing.assert_array_equal(graph.numpy(), host.numpy())
    np.testing.assert_array_equal(
        POS.oscar_batch_features(torch.from_numpy(raw["img_feat"]),
                                 torch.from_numpy(raw["img_pos_feat"])
                                 ).numpy(),
        np.asarray(JOS.oscar_batch_features(jnp.asarray(raw["img_feat"]),
                                            jnp.asarray(raw["img_pos_feat"]))))


def _reference_state(params, classifier):
    """A reference-layout Oscar state dict (model/oscar.py) from a flax tree:
    TF-era gamma/beta names in the embeddings' LayerNorm, a buffer and a
    discrete-code table the converters ignore."""
    sd = {k: v.numpy() for k, v in oscar_state_from_jax(params).items()}
    for w, tf in (("weight", "gamma"), ("bias", "beta")):
        sd["bert.embeddings.LayerNorm." + tf] = sd.pop(
            "bert.embeddings.LayerNorm." + w)
    sd["bert.embeddings.position_ids"] = np.arange(32)[None]
    sd["bert.code_embeddings.weight"] = np.zeros((4, 32), np.float32)
    assert ("classifier.0.weight" in sd) == (classifier == "mlp")
    return sd


@pytest.mark.parametrize("classifier,img_ln", [("linear", False),
                                               ("mlp", True)])
def test_oscar_state_from_torch_matches_jax(classifier, img_ln):
    """One reference-layout dump read by both packages' converters: the
    same logits (within 1e-5), head and image LayerNorm inferred from the
    keys by JAX, loaded strictly by the port."""
    jmodel, params, _ = _models(classifier, img_ln, seed=3)
    sd = _reference_state(params, classifier)
    jparams = oscar_params_from_torch(sd, JaxUniterConfig(**SMALL))
    pmodel = POS.ImageBertForSequenceClassification(
        UniterConfig(**SMALL), num_labels=2, classifier=classifier,
        img_feature_dim=22, use_img_layernorm=img_ln,
        img_layer_norm_eps=IMG_LN_EPS if img_ln else None)
    pmodel.load_state_dict(oscar_state_from_torch(
        {k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
        UniterConfig(**SMALL)), strict=True)
    batch = _assembled(_batch(seed=4))
    want = np.asarray(jmodel.apply({"params": jparams}, _j(batch)))
    with torch.no_grad():
        got = pmodel.eval()(_t(batch)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    with pytest.raises(KeyError):
        oscar_state_from_torch(sd, UniterConfig(**dict(
            SMALL, num_hidden_layers=3)))


# --------------------------------------------------------------- entry point

OSCAR = dict(vocab_size=64, hidden_size=32, num_hidden_layers=1,
             num_attention_heads=2, intermediate_size=64,
             img_dim=22,  # stored 16-d + 6-d geometry
             max_position_embeddings=32, **NO_DROPOUT)


@pytest.fixture
def jax_init(monkeypatch, threefry):
    """The port's Oscar init replaced by JAX's initial weights for the same
    seed (the JAX factory's model.init(PRNGKey(seed), example))."""
    def init_from_jax(config, num_labels, device, generator,
                      classifier="linear", img_feature_dim=None):
        jmodel = JOS.ImageBertForSequenceClassification(
            JaxUniterConfig(**config.to_dict()), num_labels=num_labels,
            classifier=classifier, img_feature_dim=config.img_dim)
        example = {k: jnp.asarray(v) for k, v in
                   _assembled(_batch(stored=config.img_dim - 6)).items()}
        params = jmodel.init(jax.random.PRNGKey(generator.initial_seed()),
                             example, deterministic=True)["params"]
        model = POS.ImageBertForSequenceClassification(
            config, num_labels=num_labels, classifier=classifier,
            img_feature_dim=config.img_dim)
        model.load_state_dict(oscar_state_from_jax(
            jax.tree_util.tree_map(np.asarray, params)), strict=True)
        return model.to(device).eval()

    monkeypatch.setattr(PTO, "init_oscar_model", init_from_jax)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return make_synthetic_dataset(
        str(tmp_path_factory.mktemp("oscar") / "d"), n_train=24, n_dev=8,
        n_test=8, img_dim=16, label_signal=3.0)


def test_oscar_entry_matches_jax(tmp_path, synth, jax_init):
    """Host batches and --device_resident_data in both packages (CE over
    2 labels, selection on accuracy, 2 epochs): each port run's scalars,
    CSVs and metrics JSON within 1e-5 of JAX's, and the port's two modes'
    CSVs equal."""
    kw = dict(data_path=synth["root"], feature_path=synth["feature_dir"],
              model_save_name="oscar.ckpt", lr=1e-3, batch_size=8,
              max_epoch=2, warmup_steps=2, max_txt_len=8, max_bb=8, seed=7,
              loss_func="ce", optimize_for="accuracy",
              adam_mu_dtype="float32", adam_nu_dtype="float32")
    csvs = {}
    for resident in (False, True):
        for who in ("jax", "port"):
            run = "%s%d" % (who, resident)
            cfg = (JaxTrainConfig if who == "jax" else TrainConfig)(
                model_path=str(tmp_path / run),
                vis_path=str(tmp_path / ("vis_" + run)),
                device_resident_data=resident, **kw)
            os.makedirs(cfg.model_path)
            if who == "jax":
                jax_set_seed(cfg.seed)
                lf, tl, factory = JTO.build_oscar_entry(
                    cfg, JaxUniterConfig(**OSCAR), synth["vocab"])
                jax_train_crossval(factory, cfg, lf, tl, num_folds=0)
            else:
                set_seed(cfg.seed)
                lf, tl, factory = PTO.build_oscar_entry(
                    cfg, UniterConfig(**OSCAR), synth["vocab"],
                    device="cpu")
                assert all(l.index_batches == resident for l in tl)
                train_crossval(factory, cfg, lf, tl, num_folds=0,
                               device="cpu")
        _assert_runs_match(str(tmp_path / ("jax%d" % resident)),
                           str(tmp_path / ("port%d" % resident)),
                           str(tmp_path / ("vis_jax%d" % resident)),
                           str(tmp_path / ("vis_port%d" % resident)))
        with open(tmp_path / ("port%d" % resident)
                  / "oscar_dev_seen_preds.csv") as f:
            csvs[resident] = f.read()
    assert csvs[True] == csvs[False]


def test_oscar_cli_reads_its_config(tmp_path, synth):
    """main(): --oscar_config JSON (fused attention on: the plain kernel
    versions on the CPU), --classifier mlp, CE over max(n_classes, 2) = 2
    labels, selection on accuracy, the checkpoint and metrics JSON."""
    cfg_path = tmp_path / "oscar.json"
    cfg_path.write_text(json.dumps(dict(OSCAR, use_pallas_attention=True)))
    best, _ = PTO.main([
        "--oscar_config", str(cfg_path), "--vocab_file", synth["vocab"],
        "--classifier", "mlp", "--data_path", synth["root"],
        "--feature_path", synth["feature_dir"],
        "--model_path", str(tmp_path / "ck"), "--model_save_name", "o.ckpt",
        "--max_epoch", "1", "--batch_size", "8", "--max_txt_len", "8",
        "--max_bb", "8", "--warmup_steps", "2", "--lr", "1e-3",
        "--device", "cpu"])
    assert "accuracy" in best and np.isfinite(best["accuracy"])
    assert (tmp_path / "ck" / "o.ckpt").is_file()
    assert (tmp_path / "ck" / "o_metrics.json").is_file()
