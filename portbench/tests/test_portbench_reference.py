"""The plain reference against the port at a tiny UNITER on the CPU: with
dropout off, then with the masks drawn again from the step's generator,
for both of the kernel's seed modes and both dropout word widths."""
import json
import os

import numpy as np
import pytest
import torch

from portbench.reference import batches, train as ref_train, uniter
from portbench.traffic import memes

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = {"hidden_size": 32, "intermediate_size": 64, "num_attention_heads": 4,
        "num_hidden_layers": 2, "vocab_size": 300,
        "max_position_embeddings": 32}
MIX = {"memes": 24, "text_tokens": {"median": 8, "sigma": 0.5, "min": 4,
                                    "max": 16},
       "regions": {"min": 3, "max": 10}, "hateful_share": 0.35,
       "confounder_share": 0.2, "feature_dtype": "float16"}


def _cfg():
    with open(os.path.join(HERE, "configs", "uniter-base.json")) as f:
        cfg = json.load(f)
    cfg.update(TINY)
    return cfg


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return memes.generate(MIX, 11, str(tmp_path_factory.mktemp("c")),
                          vocab_size=TINY["vocab_size"])


def _port(cfg, flags, seed):
    from portbench.drivers.train import build_model

    w = uniter.make_weights(cfg, seed, "cpu")
    model, _ = build_model(cfg, flags, w, torch.device("cpu"))
    return model


def _batch(corpus, n):
    b = batches.build(corpus, corpus.ids[:n], 16, 10, "cpu")
    b["sample_mask"] = torch.ones(n, dtype=torch.int64)
    return b


@pytest.mark.parametrize("flags", [{}, {"use_pallas_attention": True}])
def test_logits_without_dropout(corpus, flags):
    cfg = _cfg()
    model = _port(cfg, flags, seed=5)
    b = _batch(corpus, 8)
    with torch.no_grad():
        got = model(b)
        want = uniter.logits(uniter.make_weights(cfg, 5, "cpu"), b, cfg)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("flags", [
    {"use_pallas_attention": True},
    {"use_pallas_attention": True, "pallas_blocked": True,
     "dropout_bits_dtype": "uint8"},
])
def test_step_with_dropout_masks_drawn_again(corpus, flags):
    """One forward and backward with dropout on: the reference draws the
    step's masks again and meets the port's loss and every gradient."""
    from meme_challenge_tpu_torch.core.seeding import dropout_generator

    cfg = _cfg()
    model = _port(cfg, flags, seed=6)
    b = _batch(corpus, 8)
    logit = model(b, deterministic=False,
                  generator=dropout_generator(123, 4, "cpu"))
    loss = uniter.bce_logits(logit, b["labels"], b["sample_mask"], 1.8)
    loss.backward()
    got = {n: p.grad for n, p in model.named_parameters()}

    w = uniter.make_weights(cfg, 6, "cpu")
    for t in w.values():
        t.requires_grad_(True)
    drop = ref_train._drop(cfg, flags, ref_train.step_generator(123, 4,
                                                                "cpu"))
    ref_loss = uniter.bce_logits(uniter.logits(w, b, cfg, drop),
                                 b["labels"], b["sample_mask"], 1.8)
    ref_loss.backward()
    torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=1e-6)
    want = {n: t.grad if t.grad is not None else torch.zeros_like(t)
            for n, t in w.items()}
    # a leaf whose gradient is nought to rounding (a key's bias under
    # softmax) is held to the median leaf's scale
    median = float(np.median([float(g.abs().max()) for g in want.values()]))
    for n, g_want in want.items():
        g = got[n] if got[n] is not None else torch.zeros_like(g_want)
        scale = max(float(g_want.abs().max()), median)
        assert float((g - g_want).abs().max()) <= 1e-4 * scale, n


def test_dropout_changes_the_step(corpus):
    """The masks matter: without them the reference's loss is another."""
    from meme_challenge_tpu_torch.core.seeding import dropout_generator

    cfg = _cfg()
    flags = {"use_pallas_attention": True}
    model = _port(cfg, flags, seed=6)
    b = _batch(corpus, 8)
    with torch.no_grad():
        loss = uniter.bce_logits(
            model(b, deterministic=False,
                  generator=dropout_generator(123, 4, "cpu")),
            b["labels"], b["sample_mask"], 1.8)
        plain = uniter.bce_logits(
            uniter.logits(uniter.make_weights(cfg, 6, "cpu"), b, cfg),
            b["labels"], b["sample_mask"], 1.8)
    assert abs(float(loss - plain)) > 1e-4


def test_step_generator_is_the_recipes():
    from meme_challenge_tpu_torch.core.seeding import dropout_generator

    for seed, step in ((0, 0), (2 ** 31 + 3, 7), (43, 1000)):
        a = torch.rand(5, generator=dropout_generator(seed, step, "cpu"))
        b = torch.rand(5, generator=ref_train.step_generator(seed, step,
                                                             "cpu"))
        assert torch.equal(a, b)


def test_weights_fill_the_port_and_repeat():
    from meme_challenge_tpu_torch.models.uniter import MemeUniter
    from meme_challenge_tpu_torch.core.config import UniterConfig

    cfg = _cfg()
    w = uniter.make_weights(cfg, 3, "cpu")
    names = {n for n, _ in MemeUniter(UniterConfig.from_dict(cfg))
             .named_parameters()}
    assert set(w) == names
    again = uniter.make_weights(cfg, 3, "cpu")
    assert all(torch.equal(w[n], again[n]) for n in w)
    other = uniter.make_weights(cfg, 4, "cpu")
    assert not torch.equal(w["linear.weight"], other["linear.weight"])
