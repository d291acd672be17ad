"""PyTorch port, UNITER-large (``configs/uniter-large.json``: 24 layers, 1 024
wide, 16 heads of 64) against the JAX package in the same process, and the
embedding lookups that index their table.

- ``UniterConfig`` read from ``configs/uniter-large.json`` through each
  package's ``from_json_file`` (the CLI's loader) is the same, field for
  field, and equal to each package's ``UNITER_LARGE``.
- A narrow model of UNITER-large's shape (16 heads of D 4, hidden 64, 3
  layers, intermediate 256) with the fused attention kernels: JAX's Pallas
  kernels in interpret mode against the port's plain versions. Logits
  within 1e-5; the loss, and every gradient within 2e-5 of its largest
  magnitude; per-sample, and pair-blocked at B 2 and B 4, where the blocks
  hold 16 pairs (UNITER-base's 12 heads give 24).
- ``models/convert.py`` at UNITER-large's depth: a 24-layer narrow flax init
  loads into the port with every key and gives JAX's logits.
- ``blocked_seed_count`` and the block of one fold at UNITER-large's head
  count, B 16 and B 32 (``--fuse_accum``), and three folds of 16.
- The repair of the embedding backward: no gradient pass of
  ``MemeUniter`` (with MRFR's ``img_masks``), ``UniterForPretraining``,
  the ``MODEL_DICT`` text models or Oscar reaches ``F.embedding``, and the
  tables' gradients equal ``F.embedding``'s backward within 1e-6 of their
  largest magnitude.
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_parity import make_batch, port_tree_from_jax

from meme_challenge_tpu.core import config as JC
from meme_challenge_tpu.models.uniter import MemeUniter as JaxMemeUniter
from meme_challenge_tpu.ops import attention as JA
from meme_challenge_tpu.train.losses import bce_logits_loss as jax_bce_logits
from meme_challenge_tpu_torch.core import config as PC
from meme_challenge_tpu_torch.core.seeding import torch_generator
from meme_challenge_tpu_torch.models import oscar as POS
from meme_challenge_tpu_torch.models import text_models as PT
from meme_challenge_tpu_torch.models import uniter as U
from meme_challenge_tpu_torch.models.convert import meme_uniter_state_from_jax
from meme_challenge_tpu_torch.ops import attention as PA
from meme_challenge_tpu_torch.train.losses import bce_logits_loss
from meme_challenge_tpu_torch.train.pretrain_init import init_pretrain_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LARGE_JSON = os.path.join(ROOT, "configs", "uniter-large.json")

# UNITER-large's head count and layout at a width the CPU runs quickly: 16
# heads of 4, intermediate 4 × hidden; initializer_range 0.2 keeps the
# logits O(1) so an absolute tolerance means something
NARROW = dict(vocab_size=64, hidden_size=64, num_hidden_layers=3,
              num_attention_heads=16, intermediate_size=256, img_dim=16,
              max_position_embeddings=32, initializer_range=0.2)
FUSED = {"per_sample": dict(use_pallas_attention=True),
         "blocked": dict(use_pallas_attention=True, pallas_blocked=True)}
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
CASES = [("per_sample", 2), ("blocked", 2), ("blocked", 4)]
LOGIT_TOL = 1e-5
GRAD_TOL = 2e-5
# the key bias's gradient is zero up to rounding (softmax ignores a shift of
# a whole score row): held below a thousandth of the model's largest
# gradient instead of compared, as tests/test_torch_model.py does
NOISE_ONLY = "attention.self.key.bias"
NOISE_TOL = 1e-3


def _flax_params(cfg: dict, B: int, seed: int = 0):
    """One flax MemeUniter init (numpy leaves) on a batch of ``B`` (the
    weights do not depend on it); the key's implementation is pinned, as
    tests/torch_parity.py does."""
    model = JaxMemeUniter(JC.UniterConfig(**cfg), n_classes=1)
    batch = {k: jnp.asarray(v) for k, v in _batch(B).items()}
    params = model.init(jax.random.key(seed, impl="threefry2x32"), batch,
                        deterministic=True)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def _batch(B: int, seed: int = 0):
    return make_batch(seed=seed, B=B, T=8, R=6, img_dim=NARROW["img_dim"],
                      vocab=NARROW["vocab_size"])


def _port_model(cfg: dict, params):
    model = U.MemeUniter(PC.UniterConfig(**cfg), n_classes=1)
    model.load_state_dict(meme_uniter_state_from_jax(params), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def narrow_params():
    return _flax_params(NARROW, 2)


# ----------------------------------------------------------------- config

def test_config_file_matches_jax_field_for_field():
    port = PC.UniterConfig.from_json_file(LARGE_JSON)
    jax_cfg = JC.UniterConfig.from_json_file(LARGE_JSON)
    assert dataclasses.asdict(port) == dataclasses.asdict(jax_cfg)
    assert port == PC.UNITER_LARGE
    assert dataclasses.asdict(PC.UNITER_LARGE) == dataclasses.asdict(
        JC.UNITER_LARGE)
    with open(LARGE_JSON) as f:
        raw = json.load(f)
    assert (port.num_hidden_layers, port.hidden_size,
            port.num_attention_heads, port.head_dim) == (24, 1024, 16, 64)
    assert all(getattr(port, k) == v for k, v in raw.items())


# ------------------------------------------------------------ block policy

@pytest.mark.parametrize("B,H,folds", [(16, 16, 1), (32, 16, 1),
                                       (48, 16, 3)])
def test_block_and_seed_count_match_jax(B, H, folds):
    """The port's block of one fold and its seed count for ``folds`` folds
    equal JAX's per-fold policy (JAX vmaps a fold's model, so its kernel
    sees one fold's batch): blocks of 16 pairs at 16 heads."""
    fold_b = B // folds
    assert PA._fold_block(B, H, folds) == JA._largest_block(fold_b * H) == 16
    assert (PA.blocked_seed_count(B, H, folds)
            == folds * JA.blocked_seed_count(fold_b, H))
    assert PA.blocked_seed_count(fold_b, H) == JA.blocked_seed_count(fold_b,
                                                                     H)


# ------------------------------------------------------------------ model

@pytest.mark.parametrize("kernel,B", CASES)
def test_narrow_large_logits_match_jax(narrow_params, kernel, B):
    cfg = dict(NARROW, **FUSED[kernel])
    params = narrow_params
    batch = _batch(B, seed=1)
    jmodel = JaxMemeUniter(JC.UniterConfig(**cfg), n_classes=1)
    ref = np.asarray(jmodel.apply(
        {"params": params}, {k: jnp.asarray(v) for k, v in batch.items()},
        deterministic=True), np.float32)
    with torch.no_grad():
        out = _port_model(cfg, params)(
            {k: torch.from_numpy(v) for k, v in batch.items()}).numpy()
    assert out.shape == ref.shape == (B, 1)
    assert np.abs(ref).max() > 0.05  # the logits carry signal
    np.testing.assert_allclose(out, ref, atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("kernel,B", CASES)
def test_narrow_large_loss_and_grads_match_jax(narrow_params, kernel, B):
    """bce_logits (pos_wt 1.8, the last sample masked out) in training mode
    with dropout off: the loss, and the gradient of every parameter."""
    cfg = dict(NARROW, **FUSED[kernel], **NO_DROPOUT)
    params = narrow_params
    batch = _batch(B, seed=6)
    labels = (np.arange(B) % 2).astype(np.int32)
    mask = (np.arange(B) < B - 1).astype(np.int32)
    jmodel = JaxMemeUniter(JC.UniterConfig(**cfg), n_classes=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jb, deterministic=False)
        return jax_bce_logits(logits, jnp.asarray(labels), jnp.asarray(mask),
                              pos_weight=1.8)[0]

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    ref = port_tree_from_jax(jgrads)
    model = _port_model(cfg, params)
    logits = model({k: torch.from_numpy(v) for k, v in batch.items()},
                   deterministic=False)
    loss, _ = bce_logits_loss(logits, torch.from_numpy(labels),
                              torch.from_numpy(mask), pos_weight=1.8)
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= GRAD_TOL * abs(float(jloss))
    grads = dict(model.named_parameters())
    assert set(grads) == set(ref)
    top = max(np.abs(r).max() for r in ref.values())
    for n, p in grads.items():
        g = (p.grad.numpy() if p.grad is not None
             else np.zeros(p.shape, np.float32))
        r = ref[n]
        if n.endswith(NOISE_ONLY):
            assert max(np.abs(g).max(), np.abs(r).max()) <= NOISE_TOL * top, n
            continue
        err = np.abs(g - r).max()
        assert err <= GRAD_TOL * np.abs(r).max(), (n, err, np.abs(r).max())
    assert np.abs(ref["linear.weight"]).max() > 1e-3  # the loss has signal


def test_converter_at_large_depth():
    """A flax init at UNITER-large's 24 layers (narrow widths) loads into
    the port key for key and gives JAX's logits (plain attention)."""
    cfg = dict(NARROW, num_hidden_layers=24, initializer_range=0.05)
    params = _flax_params(cfg, 2, seed=3)
    state = meme_uniter_state_from_jax(params)
    model = _port_model(cfg, params)
    layers = {k.split(".")[3] for k in state
              if k.startswith("uniter_model.encoder.layer.")}
    assert layers == {str(i) for i in range(24)}
    assert set(state) == set(model.state_dict())
    batch = _batch(2, seed=2)
    ref = np.asarray(JaxMemeUniter(JC.UniterConfig(**cfg), n_classes=1).apply(
        {"params": params}, {k: jnp.asarray(v) for k, v in batch.items()},
        deterministic=True), np.float32)
    with torch.no_grad():
        out = model({k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(out.numpy(), ref, atol=LOGIT_TOL, rtol=0)


# ------------------------------------------- the embedding backward repair

TINY = dict(vocab_size=64, hidden_size=32, num_hidden_layers=1,
            num_attention_heads=4, intermediate_size=64, img_dim=16,
            max_position_embeddings=32, **NO_DROPOUT)


def _uniter_loss(model):
    b = {k: torch.from_numpy(v) for k, v in make_batch(seed=5).items()}
    img_masks = torch.from_numpy(
        np.random.RandomState(5).randint(0, 2, b["img_mask"].shape))
    seq, _ = model.uniter_model(
        b["input_ids"], b["position_ids"], b["img_feat"], b["img_pos_feat"],
        b["txt_mask"], b["img_mask"], img_masks=img_masks)
    return model.linear(model.uniter_model.pool(seq)).sum()


def _pretrain_loss(model):
    b = {k: torch.from_numpy(v) for k, v in make_batch(seed=6).items()}
    rng = np.random.RandomState(6)
    b["img_masks"] = torch.from_numpy(rng.randint(0, 2, b["img_mask"].shape))
    b["feat_targets"] = torch.from_numpy(
        rng.randn(*b["img_feat"].shape).astype(np.float32))
    err, _ = model(b, "mrfr")
    return err.sum()


def _text_loss(model):
    rng = np.random.RandomState(7)
    ids = torch.from_numpy(rng.randint(2, 64, (3, 10)))
    mask = torch.ones(3, 10, dtype=torch.int32)
    types = torch.from_numpy(rng.randint(0, 2, (3, 10)))
    return model({"input_ids": ids, "txt_mask": mask,
                  "token_type_ids": types}).sum()


def _oscar_loss(model):
    b = make_batch(seed=8)
    feat = np.concatenate([b["img_feat"].astype(np.float32),
                           b["img_pos_feat"][..., :6]], -1)
    return model({"input_ids": torch.from_numpy(b["input_ids"]),
                  "txt_mask": torch.from_numpy(b["txt_mask"]),
                  "img_feat": torch.from_numpy(feat),
                  "img_mask": torch.from_numpy(b["img_mask"])}).sum()


def _uniter():
    return (U.init_meme_uniter(PC.UniterConfig(**TINY), 1, "cpu",
                               torch_generator(0, "cpu")), _uniter_loss)


def _pretrain():
    return (init_pretrain_model(PC.UniterConfig(**TINY), img_label_dim=5,
                                generator=torch_generator(0, "cpu")),
            _pretrain_loss)


def _text(name):
    def build():
        cfg = dataclasses.replace(
            PT.MODEL_DICT[name]["config"], vocab_size=64, hidden_size=32,
            num_hidden_layers=1, num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=32,
            type_vocab_size=max(PT.MODEL_DICT[name]["config"]
                                .type_vocab_size, 2),
            **({"embedding_size": 16}
               if PT.MODEL_DICT[name]["config"].embedding_size else {}),
            **NO_DROPOUT)
        model = PT.TransformerClassificationHead(PT.TextBackbone(cfg))
        PT.init_text_weights(model, torch_generator(0, "cpu"))
        return model, _text_loss
    return build


def _oscar():
    return (POS.init_oscar_model(PC.UniterConfig(**TINY), 2, "cpu",
                                 torch_generator(0, "cpu"),
                                 img_feature_dim=22), _oscar_loss)


MODELS = {"meme_uniter": _uniter, "uniter_for_pretraining": _pretrain,
          "oscar": _oscar,
          **{"text_" + name: _text(name) for name in sorted(PT.MODEL_DICT)}}


def _table_grads(build, monkeypatch, reference: bool):
    """Gradients of every parameter after one backward of ``build``'s
    model: through ``embedding_lookup`` with ``F.embedding`` raising, or
    with ``embedding_lookup`` swapped for ``F.embedding`` (the reference
    backward)."""
    with monkeypatch.context() as m:
        if reference:
            embedding = F.embedding
            lookup = lambda weight, ids: embedding(ids.long(), weight)  # noqa
            m.setattr(U, "embedding_lookup", lookup)
            m.setattr(PT, "embedding_lookup", lookup)
        else:
            def refuse(*args, **kwargs):
                raise AssertionError("F.embedding reached")
            m.setattr(F, "embedding", refuse)
        model, loss_fn = build()
        loss_fn(model).backward()
    return {n: p.grad.clone() for n, p in model.named_parameters()
            if p.grad is not None}


def test_lookup_backward_repeats_on_cpu():
    """``embedding_lookup``'s backward on the CPU gives the same bits pass
    after pass with several threads, at a lookup large enough (32 × 100
    ids of 768) that an index's backward would add across threads with
    atomics, and equals F.embedding's backward."""
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        gen = torch.Generator().manual_seed(0)
        weight = torch.randn(2, 768, generator=gen).requires_grad_()
        ids = torch.randint(0, 2, (32, 100), generator=gen)
        cot = torch.randn(32, 100, 768, generator=gen)
        grads = []
        for lookup in [U.embedding_lookup] * 4 + [
                lambda w, i: F.embedding(i, w)]:
            weight.grad = None
            lookup(weight, ids).backward(cot)
            grads.append(weight.grad.clone())
    finally:
        torch.set_num_threads(threads)
    assert all(torch.equal(grads[0], g) for g in grads[1:4])
    torch.testing.assert_close(grads[0], grads[4], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_no_gradient_path_reaches_f_embedding(name, monkeypatch):
    """One forward and backward with ``F.embedding`` patched to raise; the
    tables' gradients equal those of the ``F.embedding`` backward, every
    other gradient too, within 1e-6 of its largest magnitude. The state
    dict's keys stay ``*_embeddings.weight`` / ``mask_embedding.weight``."""
    build = MODELS[name]
    got = _table_grads(build, monkeypatch, reference=False)
    ref = _table_grads(build, monkeypatch, reference=True)
    assert set(got) == set(ref)
    tables = [n for n in got if "embedding" in n and n.endswith(".weight")
              and "img_embedding." not in n]
    assert tables, sorted(got)
    for n in got:
        scale = max(float(ref[n].abs().max()), 1e-30)
        assert float((got[n] - ref[n]).abs().max()) <= 1e-6 * scale, n
    if name == "meme_uniter":
        # MRFR's mask row 1 is looked up and trained; row 0 stays pinned
        w = "uniter_model.img_embeddings.mask_embedding.weight"
        assert float(got[w][1].abs().max()) > 0
        assert float(got[w][0].abs().max()) == 0
    keys = set(build()[0].state_dict())
    assert any(k.endswith("word_embeddings.weight") for k in keys)
