"""PyTorch port, the encoder's row list (``ops/linear.py: row_list``,
``models/uniter.py: StackedEncoder``) against every caller of the encoder.

On a card the float32 products compute only the rows the list names (the
batch's valid tokens) and write zeros to the others; dgrad writes zeros
there too and wgrad sums over the listed rows. Here the products are
wrapped (``_listed``) so that they do the same on the CPU: the list is
built as on a card, each product's rows outside it come out zero, and
autograd's gradient of that zeroing is the card's dgrad and wgrad. For
every caller of ``StackedEncoder`` (``MemeUniter`` through the three
attention branches and remat, the pretraining tasks with the IPOT term,
Oscar's classifier, every ``MODEL_DICT`` text model but Moonlight, which
has no such encoder, ALBERT's shared layer among them) the loss, the
outputs the caller reads and every parameter's gradient equal the
unwrapped run's within 1e-6 of their largest magnitude, dropout on. The
counter ``LISTED_ROWS`` adds the list's count and its rows once an encoder
forward. This file imports no JAX."""
import dataclasses

import numpy as np
import pytest
import torch

from meme_challenge_tpu_torch.core import config as PC
from meme_challenge_tpu_torch.core.seeding import torch_generator
from meme_challenge_tpu_torch.models import oscar as POS
from meme_challenge_tpu_torch.models import text_models as PT
from meme_challenge_tpu_torch.models import uniter as U
from meme_challenge_tpu_torch.models.moe_mla import MoeMlaConfig
from meme_challenge_tpu_torch.ops import linear as L
from meme_challenge_tpu_torch.train import pretrain_driver as PD
from meme_challenge_tpu_torch.train.losses import bce_logits_loss, ce_loss
from meme_challenge_tpu_torch.train.pretrain_init import init_pretrain_model

TOL = 1e-6
DROPOUT = dict(hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1)
TINY = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64, img_dim=16,
            max_position_embeddings=32, initializer_range=0.2, **DROPOUT)
B, T, R, IMG = 4, 8, 6, 16
# [text | pad | regions | pad]: a full meme, two with gaps, one whose only
# valid token is CLS and whose regions are all but one padding
TXT_LEN = np.array([T, 5, 1, 3])
N_BB = np.array([R, 3, 1, 2])


def _batch(seed: int = 0) -> dict:
    rng = np.random.RandomState(seed)
    txt_mask = (np.arange(T)[None] < TXT_LEN[:, None]).astype(np.int32)
    img_mask = (np.arange(R)[None] < N_BB[:, None]).astype(np.int32)
    labels = np.full((B, T), -1, np.int32)
    labels[:, :3] = rng.randint(5, 64, (B, 3))
    labels[txt_mask == 0] = -1
    img_masks = ((rng.rand(B, R) < 0.5) & (img_mask == 1)).astype(np.int32)
    img_masks[:, 0] = 1
    soft = rng.rand(B, R, 5).astype(np.float32)
    soft /= soft.sum(-1, keepdims=True)
    soft[img_mask == 0] = 0.0
    b = {
        "input_ids": rng.randint(2, 64, (B, T)).astype(np.int32),
        "position_ids": np.tile(np.arange(T, dtype=np.int32), (B, 1)),
        "txt_mask": txt_mask,
        "img_feat": rng.randn(B, R, IMG).astype(np.float16),
        "img_pos_feat": rng.rand(B, R, 7).astype(np.float32),
        "img_mask": img_mask,
        "txt_labels": labels,
        "img_masks": img_masks,
        "feat_targets": rng.randn(B, R, IMG).astype(np.float16),
        "targets": np.array([1, 0, 1, 0]),
        "label_targets": soft,
        "labels": np.array([1, 0, 1, 0], np.int32),
        "sample_mask": np.ones(B, np.int32),
    }
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _listed(x, weight, bias, rows=None):
    """The card's listed product on the CPU: every row computed, those
    outside the list then zeroed (their gradient too)."""
    y = L.linear_plain(x, weight, bias)
    if rows is None:
        return y
    keep = torch.zeros(rows.numel() - 1, dtype=torch.bool)
    keep[rows[1:1 + int(rows[0])].long()] = True
    _listed.calls += 1
    return torch.where(keep.view(*y.shape[:-1], 1), y,
                       torch.zeros((), dtype=y.dtype))


# --------------------------------------------------------------- the callers

def _meme_uniter(**cfg):
    def build():
        model = U.init_meme_uniter(PC.UniterConfig(**{**TINY, **cfg}), 1,
                                   "cpu", torch_generator(0, "cpu"))

        def run(b, gen):
            logits = model(b, deterministic=False, generator=gen)
            loss, _ = bce_logits_loss(logits, b["labels"], b["sample_mask"])
            return loss, {"logits": logits}
        return model, run
    return build


def _pretrain(task):
    def build():
        model = init_pretrain_model(PC.UniterConfig(**TINY), img_label_dim=5,
                                    generator=torch_generator(0, "cpu"))

        def run(b, gen):
            loss = PD._task_loss(model, dict(b), task, generator=gen,
                                 ot_weight=0.1)
            return loss, {}
        return model, run
    return build


def _oscar():
    model = POS.init_oscar_model(PC.UniterConfig(**TINY), 2, "cpu",
                                 torch_generator(0, "cpu"),
                                 img_feature_dim=IMG + 6)

    def run(b, gen):
        feat = torch.cat([b["img_feat"].float(), b["img_pos_feat"][..., :6]],
                         -1)
        logits = model({"input_ids": b["input_ids"],
                        "txt_mask": b["txt_mask"], "img_feat": feat,
                        "img_mask": b["img_mask"]}, deterministic=False,
                       generator=gen)
        loss, _ = ce_loss(logits, b["labels"], b["sample_mask"])
        return loss, {"logits": logits}
    return model, run


def _text(name):
    def build():
        base = PT.MODEL_DICT[name]["config"]
        cfg = dataclasses.replace(
            base, vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64,
            max_position_embeddings=32,
            type_vocab_size=max(base.type_vocab_size, 2),
            **({"embedding_size": 16} if base.embedding_size else {}),
            **DROPOUT)
        model = PT.TransformerClassificationHead(PT.TextBackbone(cfg),
                                                 dropout=0.1)
        PT.init_text_weights(model, torch_generator(0, "cpu"))

        def run(b, gen):
            ids = torch.where(b["txt_mask"] == 1, b["input_ids"],
                              torch.full_like(b["input_ids"],
                                              cfg.pad_token_id))
            logits = model({"input_ids": ids, "txt_mask": b["txt_mask"]},
                           deterministic=False, generator=gen)
            loss, _ = bce_logits_loss(logits, b["labels"], b["sample_mask"])
            return loss, {"logits": logits}
        return model, run
    return build


CALLERS = {
    "meme_uniter": _meme_uniter(),
    "meme_uniter_fused": _meme_uniter(use_pallas_attention=True),
    "meme_uniter_fused_blocked": _meme_uniter(use_pallas_attention=True,
                                              pallas_blocked=True),
    "meme_uniter_remat_full": _meme_uniter(remat=True, remat_policy="full"),
    "meme_uniter_remat_dots": _meme_uniter(remat=True, remat_policy="dots"),
    **{"pretrain_" + t: _pretrain(t)
       for t in ("mlm", "mrfr", "itm", "mrc", "mrc-kl")},
    "oscar": _oscar,
    **{"text_" + n: _text(n) for n in sorted(PT.MODEL_DICT)
       if not isinstance(PT.MODEL_DICT[n]["config"], MoeMlaConfig)},
}


def _run(build, monkeypatch, listed: bool):
    """(loss, outputs, gradients, counter's change, listed products) of one
    forward and backward of ``build``'s model, dropout drawn from seed 1;
    ``listed``: the encoder builds its row list and the products take it as
    on a card (``_listed``)."""
    with monkeypatch.context() as m:
        if listed:
            m.setattr(U, "linear_route", lambda *a: "kernel")
            m.setattr(U, "linear", _listed)
        _listed.calls = 0
        counts = L.listed_rows(torch.device("cpu")).clone()
        model, run = build()
        loss, outs = run(_batch(), torch.Generator().manual_seed(1))
        loss.backward()
        counts = L.listed_rows(torch.device("cpu")) - counts
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    return loss.detach(), outs, grads, counts.tolist(), _listed.calls


def _close(got, want, what):
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= TOL * scale, (what, err, scale)


@pytest.mark.parametrize("name", sorted(CALLERS))
def test_listed_products_leave_every_caller_unchanged(name, monkeypatch):
    """The loss, the outputs and every parameter's gradient with the
    products over the row list equal those over every row."""
    build = CALLERS[name]
    want_loss, want_outs, want_grads, unlisted, _ = _run(build, monkeypatch,
                                                         listed=False)
    loss, outs, grads, counts, calls = _run(build, monkeypatch, listed=True)
    assert unlisted == [0, 0] and calls > 0
    assert 0 < counts[0] < counts[1]
    _close(loss, want_loss, "loss")
    for k, v in want_outs.items():
        _close(outs[k].detach(), v.detach(), k)
    assert set(grads) == set(want_grads)
    for n, g in want_grads.items():
        _close(grads[n], g, n)


@pytest.mark.parametrize("name,forwards", [
    ("meme_uniter", 1), ("meme_uniter_remat_full", 1), ("oscar", 1),
    ("text_bert", 1), ("text_albert", 2)])
def test_the_counter_adds_once_an_encoder_forward(name, forwards,
                                                  monkeypatch):
    """``LISTED_ROWS`` adds the valid rows and the rows offered once an
    encoder forward: a remat recompute adds nothing, ALBERT's shared layer
    applied twice adds twice."""
    b = _batch()
    if name.startswith("text"):
        valid, offered = int(b["txt_mask"].sum()), B * T
    else:
        valid = int(b["txt_mask"].sum() + b["img_mask"].sum())
        offered = B * (T + R)
    *_, counts, _ = _run(CALLERS[name], monkeypatch, listed=True)
    assert counts == [forwards * valid, forwards * offered]
