"""PyTorch port, the text-only slice: ``models/text_models.py``, the copies
``data/hatespeech.py`` and ``data/object_text.py``, the text converters of
``models/convert.py`` and the three trainers ``train/train_pure_text.py``,
``train_hatespeech.py`` and ``train_object_text.py``, against the JAX
package in the same process at small widths (hidden 32, 4 heads, 2 layers;
ALBERT's one shared layer applied 3 times; ALBERT and ELECTRA factorized at
16), JAX's weights carried across with ``text_model_state_from_jax``.

- The registry: the 8 entries with every field equal to JAX's.
- Backbones of the four families within 1e-5 (sequence and pooled output);
  classifier logits within 1e-5 in fp32 and 2e-2 with ``compute_bf16``;
  the loss and every gradient within 2e-5 of the gradient's largest
  magnitude against ``jax.value_and_grad``; RoBERTa positions equal.
- Backbones loaded through ``hf_text_backbone_state`` against HuggingFace
  models built from configs with random weights (transformers, if
  installed).
- ``head_lr_scales`` × ``layer_freeze_scales`` and the weight-decay mask:
  each parameter's value equal to JAX's for its counterpart.
- Dataset copies: batches identical to JAX's over two shuffled epochs under
  one seed, the object-text augmentations included.
- The entry functions against JAX's (the registry entry shrunk, dropout
  off, JAX's initial weights carried into the port by a monkeypatched
  init): epoch losses within 1e-5 relative, metrics, the early-stop epoch
  and CSV probabilities within 1e-5.
"""
import dataclasses
import functools
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meme_challenge_tpu.core.artifacts import load_predictions
from meme_challenge_tpu.core.config import TrainConfig as JaxTrainConfig
from meme_challenge_tpu.core.seeding import set_seed as jax_set_seed
from meme_challenge_tpu.data import hatespeech as JH
from meme_challenge_tpu.data import object_text as JOT
from meme_challenge_tpu.data.meme_dataset import BatchLoader as JaxLoader
from meme_challenge_tpu.data.tokenizer import BertTokenizer as JaxTokenizer
from meme_challenge_tpu.models import text_models as JT
from meme_challenge_tpu.train import optim as JO
from meme_challenge_tpu.train import train_hatespeech as JHS
from meme_challenge_tpu.train import train_object_text as JOTT
from meme_challenge_tpu.train import train_pure_text as JPT
from meme_challenge_tpu.train.crossval_driver import (
    train_crossval as jax_train_crossval,
)
from meme_challenge_tpu.train.losses import make_loss_fn as jax_loss_fn
from meme_challenge_tpu.utils.synthetic import make_synthetic_dataset
from meme_challenge_tpu_torch.core.config import TrainConfig
from meme_challenge_tpu_torch.core.seeding import set_seed
from meme_challenge_tpu_torch.data import hatespeech as PH
from meme_challenge_tpu_torch.data import object_text as POT
from meme_challenge_tpu_torch.data.meme_dataset import BatchLoader
from meme_challenge_tpu_torch.data.tokenizer import BertTokenizer
from meme_challenge_tpu_torch.models import text_models as PT
from meme_challenge_tpu_torch.models.convert import (
    hf_text_backbone_state,
    text_model_state_from_jax,
)
from meme_challenge_tpu_torch.train import train_hatespeech as PHS
from meme_challenge_tpu_torch.train import train_object_text as POTT
from meme_challenge_tpu_torch.train import train_pure_text as PPT
from meme_challenge_tpu_torch.train.crossval_driver import train_crossval
from meme_challenge_tpu_torch.train.losses import make_loss_fn
from meme_challenge_tpu_torch.train.optim import no_decay_mask

SMALL = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=64,
             max_position_embeddings=32)
# the family's own shape beside SMALL: ALBERT's shared layer applied three
# times, ALBERT and ELECTRA factorized at 16
FAMILY = {"bert": {}, "roberta": {},
          "albert": dict(embedding_size=16, num_hidden_layers=3),
          "electra": dict(embedding_size=16)}
BF16 = dict(dtype="bfloat16", attention_score_dtype="bfloat16",
            dropout_bits_dtype="uint8")
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


def _configs(name, **kw):
    """The registry entry at the small width: (JAX config, port config)."""
    kw = dict(SMALL, **FAMILY.get(name, {}), **kw)
    return (dataclasses.replace(JT.MODEL_DICT[name]["config"], **kw),
            dataclasses.replace(PT.MODEL_DICT[name]["config"], **kw))


def _batch(pad_id, seed=0, B=3, T=10):
    """Token ids in [2, 64) with padded rows (pad positions hold pad_id)."""
    rng = np.random.RandomState(seed)
    lens = np.array([T, 6, 4])[:B]
    mask = (np.arange(T)[None] < lens[:, None]).astype(np.int32)
    ids = np.where(mask == 1, rng.randint(2, 64, (B, T)), pad_id)
    return {"input_ids": ids.astype(np.int32), "txt_mask": mask}


def _jax_head(cfg, num_classes=1):
    return JT.TransformerClassificationHead(
        backbone=JT.TextBackbone(cfg), num_classes=num_classes, dropout=0.5)


def _port_head(cfg, num_classes=1):
    return PT.TransformerClassificationHead(
        PT.TextBackbone(cfg), num_classes=num_classes, dropout=0.5)


@functools.lru_cache(maxsize=None)
def _jax_params(name, num_classes=1, seed=0):
    """One flax init of the small head model (numpy leaves); the key's
    implementation is pinned (a JAX CLI's main() flips the default)."""
    cfg, _ = _configs(name)
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg.pad_token_id).items()}
    params = _jax_head(cfg, num_classes).init(
        jax.random.key(seed, impl="threefry2x32"), batch)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _loaded(name, cfg, num_classes=1):
    model = _port_head(cfg, num_classes)
    model.load_state_dict(text_model_state_from_jax(
        _jax_params(name, num_classes)), strict=True)
    return model.eval()


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# the port's own entries, which the JAX package does not have
PORT_ONLY = {"moonlight"}


@pytest.mark.parametrize("name", sorted(JT.MODEL_DICT))
def test_registry_matches_jax(name):
    assert set(PT.MODEL_DICT) - PORT_ONLY == set(JT.MODEL_DICT)
    assert (dataclasses.asdict(PT.MODEL_DICT[name]["config"])
            == dataclasses.asdict(JT.MODEL_DICT[name]["config"]))
    assert PT.MODEL_DICT[name]["pretrain"] == JT.MODEL_DICT[name]["pretrain"]
    enc_p = PT.MODEL_DICT[name]["config"].encoder_config().to_dict()
    enc_j = dataclasses.asdict(
        JT.MODEL_DICT[name]["config"].encoder_config())
    assert enc_p == {k: enc_j[k] for k in enc_p}


def test_roberta_position_ids_match_jax():
    ids = _batch(1, seed=3)["input_ids"]
    ids[0, 7:] = 1
    want = np.asarray(JT.roberta_position_ids(jnp.asarray(ids), 1))
    got = PT.roberta_position_ids(torch.from_numpy(ids), 1).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(FAMILY))
def test_backbone_matches_jax(name):
    """Sequence and pooled output (ELECTRA: the CLS state) within 1e-5,
    padded positions included."""
    jcfg, pcfg = _configs(name)
    batch = _batch(jcfg.pad_token_id, seed=1)
    seq_j, pooled_j = JT.TextBackbone(jcfg).apply(
        {"params": _jax_params(name)["backbone"]},
        jnp.asarray(batch["input_ids"]), jnp.asarray(batch["txt_mask"]))
    model = _loaded(name, pcfg)
    if name == "albert":
        assert {n.split(".")[3] for n, _ in model.named_parameters()
                if ".encoder.layer." in n} == {"0"}
    assert (model.backbone.pooler is None) == (name == "electra")
    with torch.no_grad():
        seq_p, pooled_p = model.backbone(*_t(batch).values())
    np.testing.assert_allclose(seq_p.numpy(), np.asarray(seq_j), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(pooled_p.numpy(), np.asarray(pooled_j),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(FAMILY))
def test_classifier_logits_match_jax(name, dtype):
    """Logits of the head model: 1e-5 in fp32; with compute_bf16 (bf16
    compute, bf16 score storage, uint8 dropout words) 2e-2."""
    extra = BF16 if dtype == "bfloat16" else {}
    jcfg, pcfg = _configs(name, **extra)
    batch = _batch(jcfg.pad_token_id, seed=2)
    want = np.asarray(_jax_head(jcfg, 3).apply(
        {"params": _jax_params(name, 3)}, _j(batch)))
    with torch.no_grad():
        got = _loaded(name, pcfg, 3)(_t(batch)).float().numpy()
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


def _grad_worst(got: dict, want: dict) -> tuple:
    """Largest |got − want| over each gradient's largest magnitude, floored
    at a thousandth of the model's largest gradient. The key bias's
    gradient is zero up to rounding in both packages (softmax ignores a
    shift of a whole score row), so it is held to the model's largest
    gradient."""
    top = max(float(np.abs(w).max()) for w in want.values())
    worst = (0.0, "")
    for k, w in want.items():
        scale = (top if k.endswith("attention.self.key.bias")
                 else max(float(np.abs(w).max()), 1e-3 * top))
        worst = max(worst, (float(np.abs(got[k] - w).max()) / scale, k))
    return worst


@pytest.mark.parametrize("name", sorted(FAMILY))
def test_loss_and_gradients_match_jax(name):
    """bce_logits (pos_wt 1.8, one sample masked out), dropout off: the loss
    and every gradient within 2e-5 of its largest magnitude; ALBERT's shared
    layer gets the sum over its applications."""
    jcfg, pcfg = _configs(name)
    batch = dict(_batch(jcfg.pad_token_id, seed=4),
                 labels=np.array([1, 0, 1]), sample_mask=np.array([1, 1, 0]))
    jmodel, jloss = _jax_head(jcfg), jax_loss_fn("bce_logits", 1.8)

    @jax.jit
    def value_and_grad(params, b):
        def f(p):
            logits = jmodel.apply({"params": p}, b)
            return jloss(logits, b["labels"], b["sample_mask"])[0]
        return jax.value_and_grad(f)(params)

    loss_j, grads_j = value_and_grad(_jax_params(name), _j(batch))
    want = {k: v.numpy() for k, v in text_model_state_from_jax(
        jax.tree_util.tree_map(np.asarray, grads_j)).items()}
    model = _loaded(name, pcfg)
    b = _t(batch)
    loss_p, _ = make_loss_fn("bce_logits", 1.8)(model(b), b["labels"],
                                                b["sample_mask"])
    loss_p.backward()
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    assert abs(loss_p.item() - float(loss_j)) <= 2e-5 * abs(float(loss_j))
    worst, where = _grad_worst(got, want)
    assert worst <= 2e-5, (worst, where)


def _hf(name):
    """A HuggingFace backbone from a config with random weights, and the
    port's small config of the same architecture."""
    transformers = pytest.importorskip("transformers")
    jcfg, pcfg = _configs(name, **NO_DROPOUT)
    common = dict(vocab_size=64, hidden_size=32, num_attention_heads=4,
                  intermediate_size=64, max_position_embeddings=32,
                  hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                  num_hidden_layers=pcfg.num_hidden_layers)
    torch.manual_seed(0)
    if name == "bert":
        hf = transformers.BertModel(transformers.BertConfig(**common))
    elif name == "roberta":
        hf = transformers.RobertaModel(transformers.RobertaConfig(
            type_vocab_size=1, pad_token_id=1, layer_norm_eps=1e-5,
            **common))
    elif name == "albert":
        hf = transformers.AlbertModel(transformers.AlbertConfig(
            embedding_size=16, hidden_act="gelu_new", **common))
    else:
        hf = transformers.ElectraModel(transformers.ElectraConfig(
            embedding_size=16, **common))
    return hf.eval(), pcfg


@pytest.mark.parametrize("name", sorted(FAMILY))
def test_backbone_from_hf_matches_hf(name):
    """hf_text_backbone_state maps each family's HF names (ELECTRA's
    embeddings_project, ALBERT's shared layer group and pooler) onto the
    port's backbone: outputs within 3e-5 at the valid positions."""
    hf, pcfg = _hf(name)
    model = PT.TextBackbone(pcfg)
    model.load_state_dict(hf_text_backbone_state(hf.state_dict(), pcfg),
                          strict=True)
    batch = _batch(pcfg.pad_token_id, seed=5)
    ids, mask = (torch.from_numpy(v).long() for v in batch.values())
    with torch.no_grad():
        out = hf(input_ids=ids, attention_mask=mask)
        seq, pooled = model.eval()(ids, mask)
    valid = mask.bool()
    np.testing.assert_allclose(seq[valid].numpy(),
                               out.last_hidden_state[valid].numpy(),
                               atol=3e-5, rtol=0)
    if name != "electra":
        np.testing.assert_allclose(pooled.numpy(), out.pooler_output.numpy(),
                                   atol=3e-5, rtol=0)


@pytest.mark.parametrize("name,freeze", [("bert", 1), ("albert", 1),
                                         ("electra", 0)])
def test_update_scales_and_decay_mask_match_jax(name, freeze):
    """Two LR groups × layer freezing, and the weight-decay mask: each port
    parameter gets the value JAX gives its counterpart (JAX's per-leaf
    values broadcast to the leaf and carried across by the converter);
    ALBERT's one shared layer is frozen whole by --num_layers_freeze 1."""
    params = _jax_params(name)
    lr, lr_head = 5e-5, 1e-4
    scales = JO.head_lr_scales(params, lr, lr_head, JPT._is_head)
    if freeze:
        scales = jax.tree.map(lambda a, b: np.asarray(a) * np.asarray(b),
                              scales, JO.layer_freeze_scales(params, freeze))
    decay = JO.no_decay_mask(params)

    def carried(tree):
        full = jax.tree.map(lambda s, p: np.broadcast_to(
            np.asarray(s, np.float32), p.shape), tree, params)
        return {k: np.unique(v.numpy())
                for k, v in text_model_state_from_jax(full).items()}

    _, pcfg = _configs(name)
    names = [n for n, _ in _port_head(pcfg).named_parameters()]
    want_scales, want_decay = carried(scales), carried(decay)
    assert set(want_scales) == set(names)
    got_scales = PPT.text_update_scales(names, lr, lr_head, freeze)
    got_decay = no_decay_mask(names)
    for n in names:
        assert want_scales[n].tolist() == [np.float32(got_scales[n])], n
        assert want_decay[n].tolist() == [float(got_decay[n])], n
    frozen = {n for n in names if got_scales[n] == 0.0}
    assert frozen == {n for n in names
                      if ".encoder.layer." in n
                      and int(n.split(".")[3]) < freeze}
    assert any(got_scales[n] == lr_head / lr for n in names)


# ------------------------------------------------------------------ datasets


@pytest.fixture(scope="module")
def vocab(tmp_path_factory):
    from meme_challenge_tpu.utils.synthetic import make_vocab

    return make_vocab(str(tmp_path_factory.mktemp("voc") / "vocab.txt"))


def _tweets(path, n=24):
    labels = ["none", "racism", "sexism"]
    rows = ["id,text,label"] + [
        "%d,the meme text number %d @user #tag https://t.co/x,%s"
        % (i, i, labels[(i * 7) % 3]) for i in range(n)]
    path.write_text("\n".join(rows) + "\n")
    return str(path)


def _epochs(loader, seed, n=2):
    random.seed(seed)
    np.random.seed(seed)
    return [dict(b) for _ in range(n) for b in loader]


def _assert_same_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_hatespeech_dataset_matches_jax(tmp_path, vocab):
    csv = _tweets(tmp_path / "tweets.csv")
    jds = JH.TwitterHatespeechDataset(csv, JaxTokenizer(vocab), 16)
    pds = PH.TwitterHatespeechDataset(csv, BertTokenizer(vocab), 16)
    assert pds.label_names == jds.label_names and pds.num_classes == 3
    assert pds.texts == jds.texts
    _assert_same_batches(_epochs(JaxLoader(jds, 5, shuffle_data=True), 3),
                         _epochs(BatchLoader(pds, 5, shuffle_data=True), 3))


def _object_files(root, n=20, seed=0):
    root.mkdir(exist_ok=True)
    rng = np.random.RandomState(seed)
    recs = [{"id": 100 + i, "img": "img/%i.png" % i, "label": i % 2,
             "text": "a meme about things %i" % i} for i in range(n)]
    np.savez(root / "objects.npz", ids=np.array([r["id"] for r in recs]),
             objects=rng.randint(0, 5, (n, 6)), probs=rng.rand(n, 6))
    (root / "obj2text.json").write_text(json.dumps(
        {str(i): w for i, w in enumerate(["cat", "dog", "hat", "person",
                                          "car"])}))
    return recs, str(root / "objects.npz"), str(root / "obj2text.json")


@pytest.mark.parametrize("thresh,swap", [((0.2, 0.8), 0.5), (0.5, 0.0)],
                         ids=["threshold_range-swaps", "fixed"])
def test_object_text_dataset_matches_jax(tmp_path, vocab, thresh, swap):
    """Per-sample thresholds and adjacent swaps draw from numpy's global
    RNG in the same places: two shuffled epochs under one seed give the
    same token batches."""
    recs, objects, obj2text = _object_files(tmp_path)
    memes = tmp_path / "memes.jsonl"
    memes.write_text("\n".join(json.dumps(r) for r in recs) + "\n")
    kw = dict(max_txt_len=24, confidence_threshold=thresh, swap_prob=swap,
              return_ids=True)
    jds = JOT.ObjectTextDataset(str(memes), objects, obj2text,
                                tokenizer=JaxTokenizer(vocab), **kw)
    pds = POT.ObjectTextDataset(str(memes), objects, obj2text,
                                tokenizer=BertTokenizer(vocab), **kw)
    want = _epochs(JaxLoader(jds, 6, shuffle_data=True), 11)
    got = _epochs(BatchLoader(pds, 6, shuffle_data=True), 11)
    _assert_same_batches(want, got)
    if swap:  # the augmentations did draw: epoch 2 differs from epoch 1
        assert any((a["input_ids"] != b["input_ids"]).any()
                   for a, b in zip(got[:4], got[4:]))


# --------------------------------------------------------------- entry points

TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=64, max_position_embeddings=32, **NO_DROPOUT)
TOL = 1e-5


@pytest.fixture
def threefry():
    """JAX's default PRNG pinned to threefry for the test: a JAX CLI's
    main() run earlier in the same worker switches the process to rbg,
    which would give both packages other initial weights, and so another
    rounding drift to compare."""
    old = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    yield
    jax.config.update("jax_default_prng_impl", old)


@pytest.fixture
def tiny_registry(monkeypatch, vocab, threefry):
    """MODEL_DICT["bert"] shrunk to TINY (dropout off) in both packages, the
    head's dropout off in both trainers (the two frameworks' dropout
    streams cannot match), and the port's init replaced by JAX's initial
    weights for the same seed."""
    tiny = dataclasses.replace(JT.MODEL_DICT["bert"]["config"],
                               vocab_size=JaxTokenizer(vocab).vocab_size,
                               **TINY)
    monkeypatch.setitem(JT.MODEL_DICT["bert"], "config", tiny)
    monkeypatch.setitem(PT.MODEL_DICT["bert"], "config", PT.TextModelConfig(
        **dataclasses.asdict(tiny)))
    no_dropout = functools.partial(JT.build_text_model, dropout=0.0)
    for module in (JPT, JHS, JOTT):
        monkeypatch.setattr(module, "build_text_model", no_dropout)

    def init_from_jax(name, num_classes, device, generator,
                      compute_bf16=False):
        seed = generator.initial_seed()
        jmodel = no_dropout(name, num_classes=num_classes,
                            compute_bf16=compute_bf16)
        batch = {"input_ids": jnp.ones((2, 8), jnp.int32),
                 "txt_mask": jnp.ones((2, 8), jnp.int32)}
        params = jmodel.init(jax.random.PRNGKey(seed), batch,
                             deterministic=True)["params"]
        model = PT.build_text_model(name, num_classes=num_classes,
                                    dropout=0.0, compute_bf16=compute_bf16)
        model.load_state_dict(text_model_state_from_jax(
            jax.tree_util.tree_map(np.asarray, params)), strict=True)
        return model.to(device).eval()

    for module in (PPT, PHS, POTT):
        monkeypatch.setattr(module, "init_text_model", init_from_jax)
    return vocab


def _scalars(vis_dir):
    """Every run's scalar log under ``vis_dir`` (one a fold): (run, name,
    step) → value, the host timings left out."""
    out = {}
    for d, _, files in os.walk(vis_dir):
        if "scalars.jsonl" in files:
            with open(os.path.join(d, "scalars.jsonl")) as f:
                for r in map(json.loads, f):
                    if not r["name"].startswith("Stats/time"):
                        out[os.path.relpath(d, vis_dir), r["name"],
                            r["step"]] = r["value"]
    assert out, vis_dir
    return out


def _assert_runs_match(jax_dir, port_dir, jax_vis, port_vis, tol=TOL):
    """Every scalar (epoch losses, validation metrics and loss, learning
    rate) and every number of the metrics JSONs within tol relative to
    max(1, |value|) (the losses relative, the metrics in [0, 1] absolute),
    the same scalars logged (the same early-stop epoch), the same CSV files
    with equal ids and probabilities within tol."""
    s_jax, s_port = _scalars(jax_vis), _scalars(port_vis)
    assert set(s_port) == set(s_jax)
    for key, value in s_jax.items():
        assert abs(s_port[key] - value) <= tol * max(1.0, abs(value)), key
    files = sorted(os.listdir(jax_dir))
    assert files == sorted(os.listdir(port_dir))
    for name in files:
        a, b = os.path.join(jax_dir, name), os.path.join(port_dir, name)
        if name.endswith(".csv"):
            pa, pb = load_predictions(a), load_predictions(b)
            np.testing.assert_array_equal(pa["id"], pb["id"])
            np.testing.assert_allclose(pb["proba"], pa["proba"], atol=tol,
                                       rtol=0, err_msg=name)
        elif name.endswith("_metrics.json"):
            with open(a) as f, open(b) as g:
                _assert_close(json.load(g), json.load(f), tol, name)
    return s_jax


def _assert_close(got, want, tol, path):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_close(got[k], want[k], tol, path + "/" + k)
    else:
        assert abs(float(got) - float(want)) <= tol * max(
            1.0, abs(float(want))), (path, got, want)


def _configs_for(who, tmp_path, **kw):
    vis = str(tmp_path / ("vis_" + who))
    base = dict(model_path=str(tmp_path / who), vis_path=vis,
                adam_mu_dtype="float32", adam_nu_dtype="float32", **kw)
    return JaxTrainConfig(**base) if who == "jax" else TrainConfig(**base)


@pytest.mark.parametrize("resident,folds", [(False, 2), (True, 0)],
                         ids=["host_batches-2_folds",
                              "device_resident-one_split"])
def test_pure_text_entry_matches_jax(tmp_path, tiny_registry, resident,
                                     folds):
    """build_text_entry with --num_layers_freeze 1 and --lr_head, over 2
    folds with host batches and on the default split with
    --device_resident_data: every run's scalars (epoch losses, validation
    metrics, the early-stop epoch), CSVs and metrics JSONs as JAX's; the
    frozen layer keeps its initial weights in the port."""
    kw = dict(model_save_name="txt.ckpt", max_epoch=3, patience=1, lr=3e-3,
              warmup_steps=2, batch_size=8, max_txt_len=16, seed=7,
              confounder_repeat=2, num_folds=folds, crossval_dev_size=8,
              device_resident_data=resident)
    frozen = {}
    for who in ("jax", "port"):
        # no confounder pairs: a text-only model scores a pair's one text
        # equally, and the train AUROC of an exact tie would hang on how
        # each framework's rounding breaks it
        synth = make_synthetic_dataset(str(tmp_path / ("data_" + who)),
                                       n_train=24, n_dev=12, n_test=8,
                                       img_dim=16, seed=3, label_signal=0.7,
                                       n_confounder_pairs=0)
        cfg = _configs_for(who, tmp_path, data_path=synth["root"], **kw)
        entry = dict(lr_head=1e-2, num_layers_freeze=1,
                     max_txt_len=cfg.max_txt_len)
        os.makedirs(cfg.model_path)
        if who == "jax":
            jax_set_seed(cfg.seed)
            lf, tl, factory = JPT.build_text_entry(
                cfg, "bert", synth["vocab"], **entry)
            jax_train_crossval(factory, cfg, lf, tl, num_folds=folds,
                               dev_size=8)
        else:
            set_seed(cfg.seed)
            lf, tl, factory = PPT.build_text_entry(
                cfg, "bert", synth["vocab"], device="cpu", **entry)

            def watched(c, *loaders):
                trainer = factory(c, *loaders)
                frozen[c.seed] = (trainer.model, {
                    n: p.detach().clone()
                    for n, p in trainer.model.named_parameters()
                    if ".encoder.layer.0." in n})
                return trainer

            train_crossval(watched, cfg, lf, tl, num_folds=folds,
                           dev_size=8, device="cpu")
    s_jax = _assert_runs_match(str(tmp_path / "jax"), str(tmp_path / "port"),
                               str(tmp_path / "vis_jax"),
                               str(tmp_path / "vis_port"))
    epochs = {}
    for run, name, step in s_jax:
        if name == "Validation/Loss":
            epochs[run] = max(epochs.get(run, 0), step)
    print(epochs)
    assert set(frozen) == ({7, 8} if folds else {7})  # fold seeds: 7 + fold
    for model, before in frozen.values():
        params = dict(model.named_parameters())
        assert before
        for n, p0 in before.items():
            assert torch.equal(params[n].detach(), p0), n


def test_hatespeech_entry_matches_jax(tmp_path, tiny_registry):
    """run_hatespeech: CE over the data's 3 labels, selection on accuracy,
    one run; scalars, CSV and metrics JSON as JAX's."""
    vocab = tiny_registry
    train = _tweets(tmp_path / "train.csv", 30)
    val = _tweets(tmp_path / "val.csv", 13)
    kw = dict(model_save_name="hs.ckpt", max_epoch=2, batch_size=8,
              max_txt_len=16, warmup_steps=2, lr=1e-3, seed=7,
              loss_func="ce", optimize_for="accuracy")
    for who in ("jax", "port"):
        cfg = _configs_for(who, tmp_path, **kw)
        os.makedirs(cfg.model_path)
        if who == "jax":
            jax_set_seed(cfg.seed)
            JHS.run_hatespeech(cfg, "bert", vocab, train, val, 16)
        else:
            set_seed(cfg.seed)
            best, _ = PHS.run_hatespeech(cfg, "bert", vocab, train, val, 16,
                                         device="cpu")
            assert "accuracy" in best
    _assert_runs_match(str(tmp_path / "jax"), str(tmp_path / "port"),
                       str(tmp_path / "vis_jax"), str(tmp_path / "vis_port"))


def test_object_text_entry_matches_jax(tmp_path, tiny_registry):
    """build_object_text_entry with a threshold range and swaps on the
    train loader (numpy's global RNG, as JAX draws it): scalars, CSVs and
    metrics JSON as JAX's."""
    vocab = tiny_registry
    recs, objects, obj2text = _object_files(tmp_path / "obj", n=28)
    data = tmp_path / "data"
    data.mkdir()
    for name, part in (("train", recs[:16]), ("dev_seen", recs[16:22]),
                       ("test_seen", recs[22:])):
        (data / (name + ".jsonl")).write_text(
            "\n".join(json.dumps(r) for r in part) + "\n")
    kw = dict(data_path=str(data), model_save_name="ot.ckpt", max_epoch=2,
              batch_size=8, max_txt_len=20, warmup_steps=2, lr=1e-3, seed=7)
    entry = dict(thresh_min=0.2, thresh_max=0.6, swap_prob=0.3,
                 max_txt_len=20)
    for who in ("jax", "port"):
        cfg = _configs_for(who, tmp_path, **kw)
        os.makedirs(cfg.model_path)
        if who == "jax":
            jax_set_seed(cfg.seed)
            lf, tl, factory = JOTT.build_object_text_entry(
                cfg, "bert", vocab, objects, obj2text, **entry)
            jax_train_crossval(factory, cfg, lf, tl, num_folds=0)
        else:
            set_seed(cfg.seed)
            lf, tl, factory = POTT.build_object_text_entry(
                cfg, "bert", vocab, objects, obj2text, device="cpu", **entry)
            train_crossval(factory, cfg, lf, tl, num_folds=0, device="cpu")
    _assert_runs_match(str(tmp_path / "jax"), str(tmp_path / "port"),
                       str(tmp_path / "vis_jax"), str(tmp_path / "vis_port"))
