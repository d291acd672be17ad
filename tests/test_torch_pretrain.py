"""PyTorch port, the pretraining slice: ``data/pretrain.py``,
``models/uniter.py`` (``UniterForPretraining`` and its heads),
``models/convert.py`` (pretraining weights), ``train/pretrain_{init,driver,
uniter}.py`` and the host tools, against the JAX package in the same
process at the tiny size of JAX tests/test_pretrain.py (hidden 32, 2
layers, 2 heads, img_dim 32, ``max_txt_len`` 12, ``max_bb`` 10, 24 + 8
memes), JAX's weights carried across with ``pretrain_state_from_jax``.

- Batches: byte-identical to JAX over 30 MetaLoader draws from one seed
  (vectorized and ``reference_rng`` batchers, host and index mode).
- Heads: per-position outputs of every task within 1e-5 on the plain and
  the fused attention branch (JAX's Pallas kernel in interpret mode); each
  task's reduced loss and every gradient (``ot_weight`` 0.1 on ITM) within
  2e-5 of the gradient's largest magnitude against ``jax.value_and_grad``.
- Driver: the port's ``PretrainTrainer`` beside JAX's with SGD, dropout 0,
  the same weights: per-task losses and final weights within 1e-5; within
  the port index mode, chunked dispatch and kill-and-resume bit-equal,
  ``fuse_accum`` within fp32 rounding of the per-micro path.
- CLI: both CLIs from one JAX pretraining dump (SGD, every task, OT,
  ``--device_resident_data``): final losses within 1e-4; the port's dump
  feeds the port's fine-tune CLI in "pretrain" mode and loads through JAX
  ``pretrain_params_from_torch`` to the port's weights exactly.
"""
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meme_challenge_tpu.core.config import TrainConfig as JaxTrainConfig
from meme_challenge_tpu.core.config import UniterConfig as JaxUniterConfig
from meme_challenge_tpu.data import pretrain as JP
from meme_challenge_tpu.data.tokenizer import BertTokenizer as JaxTokenizer
from meme_challenge_tpu.models.convert import (
    load_torch_state_dict as jax_load_torch_state_dict,
    pretrain_params_from_torch,
)
from meme_challenge_tpu.models.uniter import (
    UniterForPretraining as JaxPretrainModel,
)
from meme_challenge_tpu.train import pretrain_driver as JD
from meme_challenge_tpu.train.checkpoint import ModelSaver as JaxModelSaver
from meme_challenge_tpu.train.pretrain_init import init_pretrain_params
from meme_challenge_tpu.utils.synthetic import make_synthetic_dataset
from meme_challenge_tpu_torch.core.config import TrainConfig, UniterConfig
from meme_challenge_tpu_torch.core.seeding import torch_generator
from meme_challenge_tpu_torch.data import pretrain as PP
from meme_challenge_tpu_torch.data.tokenizer import BertTokenizer
from meme_challenge_tpu_torch.models.convert import (
    load_pretrain_weights,
    pretrain_state_from_checkpoint,
    pretrain_state_from_jax,
)
from meme_challenge_tpu_torch.models.uniter import UniterForPretraining
from meme_challenge_tpu_torch.train import pretrain_driver as PD
from meme_challenge_tpu_torch.train.pretrain_init import init_pretrain_model
from meme_challenge_tpu_torch.train.steps import to_device

TXT, BB, IMG = 12, 10, 32
TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=64, img_dim=IMG, max_position_embeddings=32,
            initializer_range=0.1, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
ATTENTION = {"plain": {}, "fused": dict(use_pallas_attention=True)}
TASKS = ("mlm", "itm", "mrfr", "mrc", "mrc-kl")


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The tensors here are tiny, and the suite runs several workers side by
    side: one intra-op thread a worker keeps them from contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("pretrain_synth")
    return make_synthetic_dataset(str(root), n_train=24, n_dev=8,
                                  img_dim=IMG)


def _corpus(P, Tok, synth):
    tok = Tok(synth["vocab"])
    ds = P.pretrain_corpus(synth["root"], synth["feature_dir"], tok,
                           max_txt_len=TXT, max_bb=BB, img_dim=IMG)
    return ds, tok


@pytest.fixture(scope="module")
def corpora(synth):
    return {"jax": _corpus(JP, JaxTokenizer, synth),
            "port": _corpus(PP, BertTokenizer, synth)}


def _configs(vocab_size, **extra):
    kw = dict(TINY, vocab_size=vocab_size, **extra)
    return JaxUniterConfig(**kw), UniterConfig(**kw)


@pytest.fixture(scope="module")
def jax_params(corpora):
    """One flax UniterForPretraining init (numpy leaves); the key's
    implementation is pinned (the JAX CLIs switch the process default)."""
    ds, tok = corpora["jax"]
    jcfg, _ = _configs(tok.vocab_size)
    example = ds.batch(np.arange(4))
    example.pop("ids")
    example.pop("labels")
    model = JaxPretrainModel(jcfg)
    params = jax.jit(lambda key: init_pretrain_params(model, key, example))(
        jax.random.key(0, impl="threefry2x32"))
    return jax.tree_util.tree_map(np.asarray, params)


def _port_model(params, vocab_size, **cfg):
    _, pcfg = _configs(vocab_size, **cfg)
    model = UniterForPretraining(pcfg)
    model.load_state_dict(pretrain_state_from_jax(params), strict=True)
    return model.eval()


def _copy(params):
    return jax.tree_util.tree_map(np.copy, params)


# ------------------------------------------------------------------- data

def _loaders(P, ds, tok, index, reference_rng, B=4):
    def mrc(name):
        return P.TaskLoader(name, ds, B, P.MRCBatcher(
            ds, mask_prob=0.3, reference_rng=reference_rng),
            needs_indices=True, index_batches=index)

    return {
        "mlm": (P.TaskLoader("mlm", ds, B, P.MLMBatcher(
            ds, tok, mask_prob=0.3, reference_rng=reference_rng),
            index_batches=index), 2),
        "itm": P.TaskLoader("itm", ds, B, P.ITMBatcher(ds, replace_prob=0.5),
                            needs_indices=True, index_batches=index),
        "mrfr": P.TaskLoader("mrfr", ds, B, P.MRFRBatcher(
            ds, mask_prob=0.3, reference_rng=reference_rng),
            index_batches=index),
        "mrc": mrc("mrc"),
        "mrc-kl": mrc("mrc-kl"),
    }


def _draws(P, corpus, index, reference_rng, n=30, seed=7):
    random.seed(seed)
    np.random.seed(seed)
    meta = P.MetaLoader(_loaders(P, *corpus, index, reference_rng),
                        accum_steps=2)
    stream = iter(meta)
    return [next(stream) for _ in range(n)], meta.state()


@pytest.mark.parametrize("index", [False, True], ids=["host", "index"])
@pytest.mark.parametrize("reference_rng", [False, True],
                         ids=["vectorized", "reference_rng"])
def test_batches_byte_identical_to_jax(corpora, index, reference_rng):
    want, want_state = _draws(JP, corpora["jax"], index, reference_rng)
    got, got_state = _draws(PP, corpora["port"], index, reference_rng)
    assert [t for t, _ in got] == [t for t, _ in want]
    assert len({t for t, _ in got}) == 5
    for (task, g), (_, w) in zip(got, want):
        assert set(g) == set(w), task
        for k in w:
            assert g[k].dtype == w[k].dtype, (task, k)
            np.testing.assert_array_equal(g[k], w[k], err_msg=task + k)
    assert got_state == want_state


def test_set_state_without_order_starts_a_fresh_epoch(corpora):
    """A record taken before a task's first batch has ``order=None``.
    Restored after that task was consumed in the same process, the port
    resets the loader's position (``TaskLoader.reset_position``), so
    ``state()`` reads "no epoch started" again and the stream equals a fresh
    loader's. JAX's ``set_state`` keeps the stale order and position
    (JAX data/pretrain.py:471-474): the port differs there on
    purpose, and this test holds both behaviours."""
    results = {}
    for name, P in (("jax", JP), ("port", PP)):
        random.seed(3)
        np.random.seed(3)
        meta = P.MetaLoader(_loaders(P, *corpora[name], False, False),
                            accum_steps=2)
        record = meta.state()
        rng = (random.getstate(), np.random.get_state())
        stream = iter(meta)
        for _ in range(12):
            next(stream)
        random.setstate(rng[0])
        np.random.set_state(rng[1])
        meta.set_state(record)
        state = meta.state()
        stream = iter(meta)
        results[name] = (record, state, [next(stream) for _ in range(10)])
    record, state, after = results["port"]
    assert all(ls["order"] is None for ls in record["loaders"].values())
    assert state == record
    j_record, j_state, j_after = results["jax"]
    assert j_state != j_record  # the stale positions
    # the stream itself is the fresh one in both
    random.seed(3)
    np.random.seed(3)
    fresh = iter(PP.MetaLoader(_loaders(PP, *corpora["port"], False, False),
                               accum_steps=2))
    for (t, got), (tj, want), (tf, ref) in zip(after, j_after,
                                               (next(fresh)
                                                for _ in range(10))):
        assert t == tj == tf
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])
            np.testing.assert_array_equal(want[k], ref[k])


def test_parse_tasks():
    from meme_challenge_tpu_torch.train.pretrain_uniter import parse_tasks

    assert parse_tasks("mlm:2,itm,mrfr,mrc-kl") == {
        "mlm": 2, "itm": 1, "mrfr": 1, "mrc-kl": 1}
    assert parse_tasks("mlm") == {"mlm": 1}
    with pytest.raises(ValueError):
        parse_tasks("mlm,bogus")


# ------------------------------------------------------------------ heads

def _head_batch(vocab, seed=0, B=4):
    """One micro-batch with every task's keys: padded text and regions,
    several masked regions (the mask embedding), soft region labels with
    zeros, the last sample masked out."""
    rng = np.random.RandomState(seed)
    txt_len = np.array([TXT, 7, 5, 9])
    n_bb = np.array([BB, 4, 6, 3])
    txt_mask = (np.arange(TXT)[None] < txt_len[:, None]).astype(np.int32)
    img_mask = (np.arange(BB)[None] < n_bb[:, None]).astype(np.int32)
    labels = np.full((B, TXT), -1, np.int32)
    labels[:, 1:4] = rng.randint(5, vocab, (B, 3))
    img_masks = ((rng.rand(B, BB) < 0.4) & (img_mask == 1)).astype(np.int32)
    img_masks[:, 0] = 1
    soft = rng.rand(B, BB, 1601).astype(np.float32)
    soft[soft < 0.7] = 0.0
    soft /= soft.sum(-1, keepdims=True)
    soft[img_mask == 0] = 0.0
    return {
        "input_ids": rng.randint(0, vocab, (B, TXT)).astype(np.int32),
        "position_ids": np.tile(np.arange(TXT, dtype=np.int32), (B, 1)),
        "txt_mask": txt_mask,
        "img_feat": rng.randn(B, BB, IMG).astype(np.float16),
        "img_pos_feat": rng.rand(B, BB, 7).astype(np.float32),
        "img_mask": img_mask,
        "txt_labels": labels,
        "img_masks": img_masks,
        "feat_targets": rng.randn(B, BB, IMG).astype(np.float16),
        "targets": np.array([1, 0, 1, 0]),
        "label_targets": soft,
        "sample_mask": np.array([1, 1, 1, 0], np.int32),
    }


def _jax_outputs(jmodel, params, batch, task):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if task == "itm_with_seq":
        out = jmodel.apply({"params": params}, jb,
                           method=JaxPretrainModel.forward_itm_with_seq)
    else:
        out = jmodel.apply({"params": params}, jb, task)
    return [np.asarray(o) for o in (out if isinstance(out, tuple)
                                    else (out,))]


@pytest.mark.parametrize("attention", list(ATTENTION))
@pytest.mark.parametrize("task", TASKS + ("itm_with_seq",))
def test_head_outputs_match_jax(corpora, jax_params, task, attention):
    vocab = corpora["jax"][1].vocab_size
    jcfg, _ = _configs(vocab, **ATTENTION[attention])
    batch = _head_batch(vocab)
    want = _jax_outputs(JaxPretrainModel(jcfg), jax_params, batch, task)
    model = _port_model(jax_params, vocab, **ATTENTION[attention])
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got = (model.forward_itm_with_seq(tb) if task == "itm_with_seq"
               else model(tb, task))
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.shape == w.shape
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-5)


def _grad_worst(got: dict, want: dict) -> tuple:
    """Largest |got − want| over each gradient's largest magnitude (floored
    at a thousandth of the largest gradient: the key bias's gradient is
    zero up to rounding, since softmax ignores a shift of a score row)."""
    top = max(float(np.abs(w).max()) for w in want.values())
    worst = (0.0, "")
    for k, w in want.items():
        scale = max(float(np.abs(w).max()), 1e-3 * top)
        err = float(np.abs(got[k] - w).max()) / scale
        worst = max(worst, (err, k))
    return worst


@pytest.mark.parametrize("task", TASKS)
def test_task_loss_and_gradients_match_jax(corpora, jax_params, task):
    """The reduced loss (``sample_mask`` weighting, OT on ITM) and every
    parameter's gradient, including the tied word and ``img_linear``
    weights and the mask embedding that MRFR/MRC's nonzero ``img_masks``
    reach."""
    vocab = corpora["jax"][1].vocab_size
    jcfg, _ = _configs(vocab)
    batch = _head_batch(vocab, seed=1)
    jmodel = JaxPretrainModel(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: JD._task_loss(jmodel, p, jb, task,
                                jax.random.key(0, impl="threefry2x32"),
                                ot_weight=0.1)))(
        jax.tree_util.tree_map(jnp.asarray, jax_params))
    want = {k: v.numpy() for k, v in pretrain_state_from_jax(
        jax.tree_util.tree_map(np.asarray, want_grads)).items()}
    model = _port_model(jax_params, vocab)
    loss = PD._task_loss(model, {k: torch.from_numpy(v)
                                 for k, v in batch.items()}, task,
                         ot_weight=0.1)
    loss.backward()
    got = {n: (p.grad.numpy() if p.grad is not None
               else np.zeros(tuple(p.shape), np.float32))
           for n, p in model.named_parameters()}
    assert loss.item() == pytest.approx(float(want_loss), rel=2e-5)
    err, name = _grad_worst(got, want)
    assert err <= 2e-5, (name, err)
    for tied in ("uniter.embeddings.word_embeddings.weight",
                 "uniter.img_embeddings.img_linear.weight"):
        assert np.abs(want[tied]).max() > 0
    if task in ("mrfr", "mrc", "mrc-kl"):
        assert np.abs(got["uniter.img_embeddings.mask_embedding.weight"]
                      ).max() > 0


@pytest.mark.parametrize("task", ["mrfr", "mrc", "mrc-kl"])
def test_index_mode_prepare_matches_host(corpora, task):
    """Index mode builds MRFR's zeroed features and targets and MRC's
    one-hot on the device from the resident arrays: equal to the host
    batchers' arrays, padded regions (class id −1 → an all-zero row)
    included."""
    ds, tok = corpora["port"]
    model = init_pretrain_model(_configs(64)[1], 1601, "cpu",
                                torch_generator(0, "cpu"))
    idx = np.arange(6)
    out = {}
    for index in (False, True):
        random.seed(5)
        loader = _loaders(PP, ds, tok, index, False, B=6)[task]
        batch = next(iter(loader))
        assert ("img_feat" in batch) != index
        data = (to_device(ds.device_arrays(), "cpu",
                          keys=ds.device_arrays()) if index else None)
        tb = to_device(batch, "cpu", keys=batch)
        out[index] = PD._task_prepare(model, tb, task, data)
    host, dev = out[False], out[True]
    assert (ds.img_mask[np.asarray(host["indices"] if "indices" in host
                                   else idx)] == 0).any()
    for k in ("img_feat", "feat_targets", "label_targets", "img_masks"):
        if k in host:
            torch.testing.assert_close(dev[k].float(), host[k].float(),
                                       atol=0, rtol=0)
    if task.startswith("mrc"):
        pad = host["img_mask"] == 0
        assert (dev["label_targets"][pad] == 0).all()
        assert (dev["label_targets"].sum(-1)[~pad] == 1).all()


# ----------------------------------------------------------------- driver

def _trainer_config(tmp, **kw):
    base = dict(model_path=str(tmp), model_save_name="pre.ckpt", lr=2e-3,
                optimizer="sgd", gradient_accumulation=2, batch_size=4,
                max_epoch=1, warmup_steps=2, scheduler="warmup_cosine",
                seed=11)
    base.update(kw)
    return base


def _port_trainer(corpus, params, tmp, index=False, tasks=TASKS, steps=8,
                  ot_weight=0.1, model_cfg=None, **kw):
    ds, tok = corpus
    random.seed(17)
    np.random.seed(17)
    loaders = _loaders(PP, ds, tok, index, False)
    meta = PP.MetaLoader({t: loaders[t] for t in tasks}, accum_steps=2)
    model = _port_model(params, tok.vocab_size, **(model_cfg or {}))
    return PD.PretrainTrainer(
        TrainConfig(**_trainer_config(tmp, **kw)), model, meta,
        steps_per_epoch=steps, ot_weight=ot_weight,
        data_arrays=ds.device_arrays() if index else None)


def _state(trainer):
    return {k: v.detach().clone() for k, v in
            trainer.model.state_dict().items()}


@pytest.mark.parametrize("index,fuse", [(False, False), (True, True)],
                         ids=["host", "index_fused"])
def test_driver_matches_jax(corpora, jax_params, tmp_path, index, fuse):
    """Eight optimizer steps over all four task heads (ITM with OT), SGD
    with momentum, weight decay and clipping, dropout off: the per-task
    running mean losses both drivers log after every step, the final
    per-task means and every final weight within 1e-5."""
    import logging

    logged = {"meme_challenge_tpu.pretrain": [],
              "meme_challenge_tpu_torch.pretrain": []}
    handlers = {}
    for name, records in logged.items():
        handlers[name] = logging.Handler()
        handlers[name].emit = (
            lambda r, records=records: r.msg.startswith("pretrain step")
            and records.append(dict(r.args[2])))
        logging.getLogger(name).addHandler(handlers[name])
        logging.getLogger(name).setLevel(logging.INFO)
    ds, tok = corpora["jax"]
    jcfg, _ = _configs(tok.vocab_size)
    random.seed(17)
    np.random.seed(17)
    loaders = _loaders(JP, ds, tok, index, False)
    meta = JP.MetaLoader({t: loaders[t] for t in TASKS}, accum_steps=2)
    jtrainer = JD.PretrainTrainer(
        JaxTrainConfig(**_trainer_config(tmp_path, fuse_accum=fuse)),
        JaxPretrainModel(jcfg), _copy(jax_params), meta, steps_per_epoch=8,
        ot_weight=0.1, data_arrays=ds.device_arrays() if index else None)
    try:
        want = jtrainer.train(total_steps=8, log_every=1,
                              save_checkpoint=False)
        # seeded again as the JAX run was: the same batch stream
        ptrainer = _port_trainer(corpora["port"], jax_params, tmp_path,
                                 index=index, fuse_accum=fuse)
        got = ptrainer.train(total_steps=8, log_every=1,
                             save_checkpoint=False)
    finally:
        for name, handler in handlers.items():
            logging.getLogger(name).removeHandler(handler)
    steps_want = logged["meme_challenge_tpu.pretrain"]
    steps_got = logged["meme_challenge_tpu_torch.pretrain"]
    assert len(steps_got) == len(steps_want) == 8
    for g, w in zip(steps_got, steps_want):
        assert set(g) == set(w)
        for task in w:
            assert g[task] == pytest.approx(w[task], abs=1e-5), task
    assert set(got) == set(want) and len(got) >= 3
    for task in want:
        assert got[task] == pytest.approx(want[task], abs=1e-5), task
    want_w = pretrain_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jtrainer.state.params))
    for k, v in ptrainer.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want_w[k].numpy(), atol=1e-5,
                                   rtol=0, err_msg=k)


def test_driver_modes_equal_within_port(corpora, jax_params, tmp_path):
    """Index mode and chunked dispatch (``steps_per_dispatch`` 4 on a
    single-task stream: two chunks and two single steps) give the host
    path's weights bit for bit, dropout on (every step draws from (seed,
    step)). ``fuse_accum`` runs one forward over ``[accum·B]``: its dropout
    masks are drawn in another shape and its weight gradients summed in
    another order, so it is held, dropout off, to fp32 rounding of the
    per-micro path (SGD: Adam would turn the rounding of near-zero
    gradients into ±lr steps)."""
    drop = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    runs = {}
    for name, index, kw in (
            ("host", False, dict(model_cfg=drop, optimizer="adam")),
            ("index", True, dict(model_cfg=drop, optimizer="adam")),
            ("sgd", False, {}), ("fused", False, dict(fuse_accum=True))):
        t = _port_trainer(corpora["port"], jax_params, tmp_path, index=index,
                          **kw)
        runs[name] = (t.train(total_steps=8, save_checkpoint=False),
                      _state(t))
    assert runs["index"][0] == runs["host"][0]
    for k, v in runs["host"][1].items():
        torch.testing.assert_close(runs["index"][1][k], v, atol=0, rtol=0)
    for task, loss in runs["sgd"][0].items():
        assert runs["fused"][0][task] == pytest.approx(loss, abs=1e-6)
    for k, v in runs["sgd"][1].items():
        torch.testing.assert_close(runs["fused"][1][k], v, atol=1e-6,
                                   rtol=0)
    chunked = {}
    for K in (1, 4):
        t = _port_trainer(corpora["port"], jax_params, tmp_path, index=True,
                          tasks=("mlm",), steps=10, model_cfg=drop,
                          steps_per_dispatch=K)
        chunked[K] = (t.train(total_steps=10, save_checkpoint=False),
                      _state(t))
    assert chunked[4][0] == chunked[1][0]
    for k, v in chunked[1][1].items():
        torch.testing.assert_close(chunked[4][1][k], v, atol=0, rtol=0)


def test_kill_and_resume_bit_equal(corpora, jax_params, tmp_path):
    """12 steps uninterrupted against 6 steps, a kill, and a fresh trainer
    (fresh loaders, another host seed) resuming from the one-file
    checkpoint: the same weights and Adam moments bit for bit, dropout on.
    The file restores the host RNGs and every loader's position (no
    replay); a record without loader positions is refused."""
    drop = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
    kw = dict(index=True, model_cfg=drop, optimizer="adam", steps=12,
              adam_mu_dtype="float32", adam_nu_dtype="float32")
    full = _port_trainer(corpora["port"], jax_params, tmp_path, **kw)
    full.train(total_steps=12, save_checkpoint=False)
    ck = str(tmp_path / "resume.pt")
    part = _port_trainer(corpora["port"], jax_params, tmp_path, **kw)
    part.train(total_steps=6, save_checkpoint=False, checkpoint_path=ck,
               checkpoint_every=3)
    assert os.path.isfile(ck) and not os.path.isfile(ck + ".tmp")
    random.seed(99)  # irrelevant: the record restores the stream
    resumed = _port_trainer(corpora["port"], jax_params, tmp_path, **kw)
    resumed.train(total_steps=12, save_checkpoint=False, checkpoint_path=ck,
                  checkpoint_every=100)
    assert resumed.state.step == full.state.step == 12
    for k, v in _state(full).items():
        torch.testing.assert_close(resumed.model.state_dict()[k], v, atol=0,
                                   rtol=0)
    for slot in ("mu", "nu"):
        for k, v in full.state.opt_state[slot].items():
            torch.testing.assert_close(resumed.state.opt_state[slot][k], v,
                                       atol=0, rtol=0)
    payload = torch.load(ck, weights_only=True)
    payload["stream_record"] = json.dumps({"consumed_micros": 0})
    torch.save(payload, ck)
    with pytest.raises(ValueError, match="legacy"):
        _port_trainer(corpora["port"], jax_params, tmp_path,
                      **kw).load_checkpoint(ck)


# -------------------------------------------------------------- weights

def test_init_pretrain_model(corpora):
    """Every head initialized as the JAX package does: unit LayerNorm
    scales (the heads' ``net.2`` too), zero biases, normal matrices; no
    host RNG consumed."""
    _, pcfg = _configs(64)
    state = random.getstate(), np.random.get_state()
    model = init_pretrain_model(pcfg, 1601, "cpu", torch_generator(0, "cpu"))
    assert random.getstate() == state[0]
    assert np.random.get_state()[1].tolist() == state[1][1].tolist()
    sd = model.state_dict()
    for k in ("feat_regress.net.2.weight", "region_classifier.net.2.weight",
              "cls.predictions.transform.LayerNorm.weight"):
        assert (sd[k] == 1).all(), k
    for k in ("cls.predictions.bias", "feat_regress.bias",
              "region_classifier.net.3.bias", "itm_output.bias"):
        assert (sd[k] == 0).all(), k
    assert 0.05 < float(sd["region_classifier.net.3.weight"].std()) < 0.15
    twin = init_pretrain_model(pcfg, 1601, "cpu", torch_generator(0, "cpu"))
    for k, v in twin.state_dict().items():
        torch.testing.assert_close(v, sd[k], atol=0, rtol=0)


@pytest.mark.parametrize("heads", [True, False], ids=["heads", "trunk_only"])
def test_reference_checkpoint_loads_like_jax(corpora, jax_params, tmp_path,
                                             heads):
    """A reference-layout pretraining checkpoint (``bert.`` prefix, the
    tied decoder copies) loads as JAX ``pretrain_params_from_torch`` reads
    it; heads it lacks keep their initial weights."""
    vocab = corpora["jax"][1].vocab_size
    jcfg, pcfg = _configs(vocab)
    src = _port_model(jax_params, vocab).state_dict()
    sd = {"bert." + k: v for k, v in src.items()
          if heads or k.startswith("uniter.")}
    if heads:
        sd["bert.cls.predictions.decoder.weight"] = src[
            "uniter.embeddings.word_embeddings.weight"]
        sd["bert.feat_regress.weight"] = src[
            "uniter.img_embeddings.img_linear.weight"]
    path = str(tmp_path / "ref.pt")
    torch.save({"model_state_dict": sd}, path)
    jax_tree = pretrain_params_from_torch(jax_load_torch_state_dict(path),
                                          jcfg)
    want = pretrain_state_from_jax(jax_tree)
    got = pretrain_state_from_checkpoint(torch.load(path)["model_state_dict"])
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], atol=0, rtol=0)
    model = init_pretrain_model(pcfg, 1601, "cpu", torch_generator(1, "cpu"))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    assert load_pretrain_weights(model, path) == "pretrain"
    for k, v in model.state_dict().items():
        ref = src[k] if (heads or k.startswith("uniter.")) else init[k]
        torch.testing.assert_close(v, ref, atol=0, rtol=0)


# -------------------------------------------------------------------- CLI

def test_cli_matches_jax_and_feeds_finetune(synth, corpora, jax_params,
                                            tmp_path):
    from meme_challenge_tpu.train import pretrain_uniter as jax_cli
    from meme_challenge_tpu_torch.train import pretrain_uniter, train_uniter

    vocab = corpora["jax"][1].vocab_size
    cfg_json = str(tmp_path / "tiny.json")
    with open(cfg_json, "w") as f:
        json.dump(dict(TINY, vocab_size=vocab), f)
    dump = str(tmp_path / "jax_pre.msgpack")
    JaxModelSaver(dump).save(jax_params)

    def argv(model_path):
        return ["--data_path", synth["root"],
                "--feature_path", synth["feature_dir"],
                "--model_path", model_path, "--vocab_file", synth["vocab"],
                "--uniter_config", cfg_json, "--batch_size", "8",
                "--gradient_accumulation", "2", "--lr", "3e-3",
                "--warmup_steps", "2", "--max_txt_len", str(TXT),
                "--max_bb", str(BB), "--seed", "43", "--optimizer", "sgd",
                "--model_save_name", "pre.ckpt", "--max_epoch", "3",
                "--tasks", "mlm,itm,mrfr,mrc-kl", "--ot_weight", "0.1",
                "--device_resident_data", "--pretrained_model_file", dump,
                "--slow_rng"]

    want = jax_cli.main(argv(str(tmp_path / "jax")))
    port_dir = str(tmp_path / "port")
    got = pretrain_uniter.main(argv(port_dir) + ["--device", "cpu"])
    assert set(got) == set(want) and len(got) >= 2
    for task in want:
        assert got[task] == pytest.approx(want[task], abs=1e-4), task
    assert os.path.isfile(os.path.join(port_dir, "log", "hps.json"))
    assert os.path.isfile(os.path.join(port_dir, "pre.ckpt.resume.pt"))

    # the dump is a reference-layout checkpoint: JAX reads it back to the
    # port's weights exactly
    _, pcfg = _configs(vocab)
    port_model = UniterForPretraining(pcfg)
    load_pretrain_weights(port_model, os.path.join(port_dir, "pre.ckpt"))
    back = pretrain_state_from_jax(pretrain_params_from_torch(
        jax_load_torch_state_dict(os.path.join(port_dir, "pre.ckpt")),
        JaxUniterConfig(**dict(TINY, vocab_size=vocab))))
    assert set(back) == set(port_model.state_dict())
    for k, v in port_model.state_dict().items():
        torch.testing.assert_close(back[k], v, atol=0, rtol=0)

    # the handoff: the port's fine-tune CLI loads the trunk ("pretrain")
    import logging

    records = []
    handler = logging.Handler()
    handler.emit = records.append
    log = logging.getLogger("meme_challenge_tpu_torch.train_uniter")
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        train_uniter.main(argv(port_dir)[:22] + [
            "--model_save_name", "ft.ckpt", "--max_epoch", "1",
            "--num_folds", "0", "--pretrained_model_file", "pre.ckpt",
            "--device", "cpu"])
    finally:
        log.removeHandler(handler)
    assert any(r.getMessage().endswith("(pretrain dump)") for r in records)
    assert os.path.isfile(os.path.join(port_dir, "ft_metrics.json"))


# ------------------------------------------------------------ host tools

@pytest.mark.parametrize("tool", ["prep_memotion", "misclassification",
                                  "convert_feature_export"])
def test_host_tools_match_jax(tmp_path, tool):
    """Each copied tool writes the same files as the JAX package's."""
    import importlib

    outputs = {}
    for pkg in ("meme_challenge_tpu", "meme_challenge_tpu_torch"):
        mod = importlib.import_module("%s.tools.%s" % (pkg, tool))
        work = tmp_path / pkg
        work.mkdir()
        rng = np.random.RandomState(0)
        if tool == "prep_memotion":
            feats = work / "img_feats"
            feats.mkdir()
            for i in (1, 3):
                np.save(feats / ("image_%d.npy" % i),
                        rng.randn(3, 4).astype(np.float32))
                np.save(feats / ("image_%d_info.npy" % i),
                        np.array({"bbox": rng.rand(3, 4)}, dtype=object))
            with open(work / "labels.csv", "w") as f:
                f.write(",image_name,text_corrected\n"
                        "0,image_1.jpg,funny www.spam.com text\n"
                        "1,image_2.jpg,no features\n"
                        "2,image_3.jpg,see https://x.org/a b\n")
            assert mod.rename_img_feats(str(feats)) == 4
            mod.generate_jsonl_file(str(work))
        elif tool == "misclassification":
            from meme_challenge_tpu_torch.core.artifacts import (
                export_predictions,
            )

            export_predictions(str(work / "res.csv"), np.arange(1, 7),
                               rng.rand(6), np.array([1, 0, 1, 1, 0, 0]),
                               labels=np.array([1, 1, 0, 1, 0, 1]))
            imgs = work / "imgs"
            imgs.mkdir()
            for i in range(1, 7):
                (imgs / ("%05d.png" % i)).write_bytes(b"png%d" % i)
            mod.main(["--results_file", str(work / "res.csv"),
                      "--img_dir", str(imgs),
                      "--save_dir", str(work / "save")])
        else:
            np.savez(work / "00042.npz", x=rng.randn(5, 8).astype(np.float32),
                     bbox=rng.rand(5, 4).astype(np.float32),
                     info=np.array({"image_h": 30, "image_w": 40,
                                    "objects_id": rng.randint(0, 9, 5),
                                    "objects_conf": rng.rand(5)},
                                   dtype=object))
            (work / "out").mkdir()
            mod.main(["--input_dir", str(work), "--output_dir",
                      str(work / "out")])
        outputs[pkg] = {
            os.path.relpath(os.path.join(d, f), work): open(
                os.path.join(d, f), "rb").read()
            for d, _, fs in os.walk(work) for f in fs}
    jax_files, port_files = (outputs["meme_challenge_tpu"],
                             outputs["meme_challenge_tpu_torch"])
    assert set(port_files) == set(jax_files)
    assert len(port_files) >= 3
    for name, data in jax_files.items():
        assert port_files[name] == data, name
