"""The port's DeepSeek-V3 decoder (``models/moe_mla.py``, Moonlight-16B-A3B's
architecture) and its experts' products (``ops/expert_linear.py``) against
the benchmark's plain reference (``portbench/reference/moe_mla.py``), at a
tiny size on the CPU: hidden 64, one dense and two expert layers, 8
experts with 4 held, top 3, one shared expert.

- logits, the loss and every gradient of the port against the reference on
  the reference's seeded weights, loaded with ``strict=True``, the head's
  dropout drawn from one generator;
- the router (picks, weights, the sort into groups, pad tokens routing
  nowhere), the interleaved rotary and the MLA block;
- the share test: the held experts' parts of the two shares of the layer,
  with the shared expert counted once, add up to the uncut reference's
  layer;
- the grouped products' plain version against one product an expert, with
  an empty group and with every row in one group;
- the registry, the decay and freeze masks, and both text CLIs with
  ``--model moonlight``.

On a card (marker ``card``; ``python -m pytest --noconftest -m card
tests/test_torch_moe_mla.py`` there): the grouped kernel against float64
at the cell's shapes, the eager step against the replayed one bit for bit,
and the expert layer under ``torch.cuda.set_sync_debug_mode("error")``.
"""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from meme_challenge_tpu_torch.core.seeding import dropout_generator
from meme_challenge_tpu_torch.models import moe_mla as M
from meme_challenge_tpu_torch.models import text_models as PT
from meme_challenge_tpu_torch.ops import expert_linear
from meme_challenge_tpu_torch.train import losses as TL
from meme_challenge_tpu_torch.train.optim import (
    Optimizer,
    layer_freeze_scales,
    no_decay_mask,
)
from meme_challenge_tpu_torch.train.steps import (
    create_train_state,
    make_train_step,
)
from portbench.reference import moe_mla as R

TINY = dict(vocab_size=100, hidden_size=64, intermediate_size=96,
            moe_intermediate_size=32, num_hidden_layers=3,
            first_k_dense_replace=1, num_attention_heads=4, kv_lora_rank=32,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
            n_routed_experts=8, num_experts_per_tok=3, n_shared_experts=1,
            routed_scaling_factor=2.446, norm_topk_prob=True,
            rms_norm_eps=1e-5, rope_theta=50000.0, initializer_range=0.1,
            experts_held=4, expert_offset=0)


def port_config(**kw) -> M.MoeMlaConfig:
    return M.MoeMlaConfig(**{**TINY, **kw})


def ref_config(c: M.MoeMlaConfig) -> dict:
    """The reference's dict of a port config: ``n_routed_experts`` the
    experts held, the router's width published."""
    d = dataclasses.asdict(c)
    d.update(n_routed_experts=c.experts_held,
             n_routed_experts_published=c.n_routed_experts)
    return d


def port_model(c: M.MoeMlaConfig, weights: dict):
    with torch.device("meta"):
        model = PT.TransformerClassificationHead(M.MoeMlaBackbone(c),
                                                 dropout=R.HEAD_DROPOUT)
    model = model.to_empty(device="cpu")
    model.load_state_dict(weights, strict=True)
    model.backbone.expert_rows.zero_()
    return model


def _batch(seed, B=4, S=12, vocab=100):
    rng = np.random.RandomState(seed)
    lens = rng.randint(3, S + 1, B)
    lens[0] = S
    return {"input_ids": torch.from_numpy(
                rng.randint(5, vocab, (B, S)).astype(np.int32)),
            "txt_mask": torch.from_numpy(
                (np.arange(S) < lens[:, None]).astype(np.int32)),
            "labels": torch.from_numpy(rng.randint(0, 2, B)),
            "sample_mask": torch.from_numpy(
                np.array([1] * (B - 1) + [0], np.int32))}


@pytest.fixture(scope="module")
def tiny():
    torch.manual_seed(0)
    c = port_config()
    rc = ref_config(c)
    return c, rc, R.make_weights(rc, 3, "cpu")


# ------------------------------------------------------------ port vs ref

def test_logits_loss_and_every_gradient_match_the_reference(tiny):
    c, rc, w = tiny
    model = port_model(c, {k: v.clone() for k, v in w.items()})
    batch = _batch(1)
    gen = dropout_generator(5, 0, "cpu")
    logits = model(batch, deterministic=False, generator=gen)
    loss, _ = TL.make_loss_fn("bce_logits", 1.0)(
        logits, batch["labels"], batch["sample_mask"])
    loss.backward()

    rw = {k: v.clone().requires_grad_(not R.is_buffer(k))
          for k, v in w.items()}
    keep = R.dropout_masks(dropout_generator(5, 0, "cpu"), 4, 64, "cpu")
    _, pooled = R.hidden(rw, batch["input_ids"], batch["txt_mask"], rc)
    want = R.head(rw, pooled, keep)
    ref_loss = R.bce_logits(want, batch["labels"], batch["sample_mask"], 1.0)
    ref_loss.backward()
    torch.testing.assert_close(logits, want, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(loss, ref_loss, rtol=1e-5, atol=1e-7)
    params = dict(model.named_parameters())
    assert set(params) == {k for k in rw if not R.is_buffer(k)}
    for name, p in params.items():
        g = rw[name].grad
        assert p.grad is not None and g is not None, name
        scale = float(g.abs().max()) + 1e-12
        assert float((p.grad - g).abs().max()) <= 1e-4 * scale, name
    # every held expert got rows, and pads none: the counter saw them
    assert int(model.backbone.expert_rows.sum()) > 0


def test_router_picks_weights_and_groups(tiny):
    c, rc, w = tiny
    p = "backbone.layers.1."
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(40, 64, generator=gen)
    valid = torch.ones(40, dtype=torch.bool)
    valid[30:] = False
    r = M.route(c, x, w[p + "mlp.gate.weight"],
                w[p + "mlp.gate.e_score_correction_bias"], valid)
    picks, weights, _ = R.router(w, p, x, rc)
    assert torch.equal(r["picks"].sort(-1)[0], picks.sort(-1)[0])
    order = r["picks"].argsort(-1)
    torch.testing.assert_close(r["weights"].gather(1, order),
                               weights.gather(1, picks.argsort(-1)))
    torch.testing.assert_close(weights.sum(-1),
                               torch.full((40,), c.routed_scaling_factor))
    # groups: offsets from the counts, each group's rows its expert's
    off = r["offsets"].tolist()
    assert off[0] == 0 and len(off) == c.experts_held + 1
    key = torch.where(r["held"], r["picks"] - c.expert_offset,
                      c.experts_held).reshape(-1)
    for g in range(c.experts_held):
        rows = r["row_pair"][off[g]:off[g + 1]]
        assert bool((key[rows] == g).all())
        assert off[g + 1] - off[g] == int((key == g).sum())
    # pads route nowhere; every held pick's row points back at it
    assert not bool(r["held"][30:].any())
    t, s = r["held"].nonzero(as_tuple=True)
    assert torch.equal(r["row_pair"][r["pos"][t, s]], t * 3 + s)
    assert r["row_pair"].numel() == 40 * min(3, c.experts_held)


def test_reference_router_takes_forced_picks_at_near_ties_only(tiny):
    """``force`` decides the tokens whose k-th and (k+1)-th scores lie at
    most ``tie`` apart, and the reference's own scores decide the rest; the
    weights are the scores at the picks the layer takes."""
    _, rc, w = tiny
    p = "backbone.layers.1."
    x = torch.randn(40, 64, generator=torch.Generator().manual_seed(6))
    own, _, margins = R.router(w, p, x, rc)
    force = (own + 1) % rc["n_routed_experts_published"]
    tie = float(margins.median())
    picks, weights, got_margins = R.router(w, p, x, rc, force=force, tie=tie)
    near = margins <= tie
    assert 0 < int(near.sum()) < 40
    assert torch.equal(picks[near], force[near])
    assert torch.equal(picks[~near], own[~near])
    assert torch.equal(got_margins, margins)
    scores = torch.sigmoid(x @ w[p + "mlp.gate.weight"].t()).gather(1, picks)
    torch.testing.assert_close(
        weights, scores / scores.sum(-1, keepdim=True)
        * rc["routed_scaling_factor"])


def test_rotary_is_the_interleaved_layout():
    """Pair (2i, 2i+1) rotates by position·θ^(−2i/d) and lands at dims
    (i, i + d/2): the released code's de-interleave, then rotate_half."""
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 5, 3, 8, generator=gen)
    pos = torch.arange(5).expand(2, 5)
    cos, sin = M.rope_tables(pos, 8, 50000.0)
    got = M.apply_rope(x, cos, sin)
    ang = pos[..., None].float() * 50000.0 ** (-torch.arange(0, 8, 2) / 8.0)
    ang = ang[:, :, None]
    even, odd = x[..., 0::2], x[..., 1::2]
    want = torch.cat([even * ang.cos() - odd * ang.sin(),
                      odd * ang.cos() + even * ang.sin()], -1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    ref = R.rotary(x.transpose(1, 2), torch.arange(5), 50000.0)
    torch.testing.assert_close(got, ref.transpose(1, 2), rtol=1e-5,
                               atol=1e-6)


def test_mla_block_and_its_latent(tiny):
    """The MLA block on the reference's weights equals the reference's
    attention; its keys and values come from the latent alone: a change of
    the input that leaves the latent and the rope key as they are leaves
    the output as it is."""
    c, rc, w = tiny
    model = port_model(c, {k: v.clone() for k, v in w.items()})
    attn = model.backbone.layers[1].self_attn
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(2, 9, 64, generator=gen)
    valid = torch.ones(2, 9, dtype=torch.bool)
    valid[1, 6:] = False
    cos, sin = M.rope_tables(torch.arange(9).expand(2, 9), 8, 50000.0)
    with torch.no_grad():
        got = attn(x, cos, sin, M.causal_bias(valid))
        want = R.attention(w, "backbone.layers.1.self_attn.", x, valid, rc)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert attn.kv_a_proj_with_mqa.weight.shape == (32 + 8, 64)
    assert attn.kv_b_proj.weight.shape == (4 * (16 + 16), 32)


def test_held_shares_add_up_to_the_uncut_layer(tiny):
    """Two chips of an EP-2 layer (experts 0-3 and 4-7 of 8): each share's
    output less the shared expert, summed, plus the shared expert once,
    equals the uncut reference layer (all 8 held)."""
    c, rc, w = tiny
    gen = torch.Generator().manual_seed(8)
    x = torch.randn(30, 64, generator=gen)
    valid = torch.ones(30, dtype=torch.bool)
    valid[25:] = False
    p = "backbone.layers.2."
    full_cfg = dict(rc, n_routed_experts=8, expert_offset=0)
    full_w = dict(w)
    extra = torch.randn(4, 64, 64, generator=gen) * 0.1
    full_w[p + "mlp.experts.gate_up"] = torch.cat(
        [w[p + "mlp.experts.gate_up"], extra], 0)
    down = torch.randn(4, 64, 32, generator=gen) * 0.1
    full_w[p + "mlp.experts.down"] = torch.cat([w[p + "mlp.experts.down"],
                                                down], 0)
    with torch.no_grad():
        want = R.moe(full_w, p, x, valid, full_cfg)
        shared = R.swiglu(w, p + "mlp.shared_experts.", x)
        total = shared.clone()
        for offset in (0, 4):
            share = port_config(expert_offset=offset)
            layer = M.MoE(share)
            sw = {"gate.weight": w[p + "mlp.gate.weight"],
                  "gate.e_score_correction_bias":
                      w[p + "mlp.gate.e_score_correction_bias"],
                  "experts.gate_up": full_w[p + "mlp.experts.gate_up"][
                      offset:offset + 4],
                  "experts.down": full_w[p + "mlp.experts.down"][
                      offset:offset + 4]}
            for k in ("gate_proj", "up_proj", "down_proj"):
                sw["shared_experts.%s.weight" % k] = w[
                    p + "mlp.shared_experts.%s.weight" % k]
            layer.load_state_dict(sw, strict=True)
            total += layer(x, valid) - shared
    torch.testing.assert_close(total, want, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------- grouped products

@pytest.mark.parametrize("sizes", [[3, 0, 5, 2], [10, 0, 0, 0], [0, 0, 0, 7]],
                         ids=["ragged_with_empty", "all_first", "all_last"])
def test_grouped_products_plain_version(sizes):
    gen = torch.Generator().manual_seed(sum(sizes))
    G, N, K = len(sizes), 12, 8
    R_ = sum(sizes) + 3           # rows past the last group: never read
    x = torch.randn(R_, K, generator=gen)
    dy = torch.randn(R_, N, generator=gen)
    w = torch.randn(G, N, K, generator=gen)
    off = torch.tensor([0] + list(np.cumsum(sizes)), dtype=torch.int32)
    y = expert_linear.forward(x, w, off, R_)
    dx = expert_linear.dgrad(dy, w, off, R_)
    dw = expert_linear.wgrad(dy, x, off)
    for g in range(G):
        a, b = int(off[g]), int(off[g + 1])
        torch.testing.assert_close(y[a:b], x[a:b] @ w[g].t())
        torch.testing.assert_close(dx[a:b], dy[a:b] @ w[g])
        torch.testing.assert_close(dw[g], dy[a:b].t() @ x[a:b])
        if a == b:
            assert not bool(dw[g].any())
    assert expert_linear.LAUNCHES == {"forward": 0, "dgrad": 0, "wgrad": 0}


# ------------------------------------------------- registry and the trainers

def test_registry_builds_moonlight_at_its_published_widths():
    c = PT.MODEL_DICT["moonlight"]["config"]
    assert (c.hidden_size, c.num_hidden_layers, c.num_attention_heads,
            c.kv_lora_rank, c.qk_nope_head_dim, c.qk_rope_head_dim,
            c.v_head_dim, c.moe_intermediate_size, c.intermediate_size,
            c.n_routed_experts, c.num_experts_per_tok, c.n_shared_experts,
            c.vocab_size, c.experts_held) == (
        2048, 27, 16, 512, 128, 64, 128, 1408, 11264, 64, 6, 2, 163840, 8)
    with torch.device("meta"):
        model = PT.build_text_model("moonlight")
    n = sum(p.numel() for p in model.parameters())
    assert 3.0e9 < n < 3.1e9
    with pytest.raises(ValueError):
        PT.build_text_model("moonlight", compute_bf16=True)


def test_decay_and_freeze_reach_the_decoder_names(tiny):
    c, _, w = tiny
    names = [n for n in w if not R.is_buffer(n)]
    mask = no_decay_mask(names)
    assert mask == {n: R.decays(n) for n in names}
    freeze = layer_freeze_scales(names, 2)
    assert freeze["backbone.layers.1.mlp.gate.weight"] == 0.0
    assert freeze["backbone.layers.2.mlp.gate.weight"] == 1.0
    assert freeze["head_out.weight"] == 1.0


def test_train_step_runs_eagerly_on_the_cpu_and_counts_rows(tiny):
    """The port's train step (``make_train_step``, fused AdamW) on the CPU:
    the loss equals the reference's first micro-batch loss, the step moves
    every parameter and the correction buffers stay as they were."""
    c, rc, w = tiny
    model = port_model(c, {k: v.clone() for k, v in w.items()})
    opt = Optimizer("adamw", 1e-3, lambda count: 1.0, weight_decay=1e-3,
                    max_grad_norm=5.0, mu_dtype="bfloat16",
                    nu_dtype="bfloat16")
    state = create_train_state(model, opt)
    step = make_train_step(model, TL.make_loss_fn("bce_logits", 1.0), opt)
    b = _batch(2)
    batch = {k: v[None] for k, v in b.items()}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    state, out = step(state, batch, dropout_generator(1, 0, "cpu"))
    keep = R.dropout_masks(dropout_generator(1, 0, "cpu"), 4, 64, "cpu")
    with torch.no_grad():
        _, pooled = R.hidden(w, b["input_ids"], b["txt_mask"], rc)
        want = R.bce_logits(R.head(w, pooled, keep), b["labels"],
                            b["sample_mask"], 1.0)
    torch.testing.assert_close(out["loss"][0], want, rtol=1e-5, atol=1e-7)
    for n, p in model.named_parameters():
        assert not torch.equal(p.detach(), before[n]), n
    buffers = dict(model.named_buffers())
    for n in w:
        if R.is_buffer(n):
            assert torch.equal(buffers[n], w[n]), n
    valid = int(b["txt_mask"].sum())
    # 2 expert layers, each valid token at most min(3, 4) held picks
    assert 0 < int(model.backbone.expert_rows.sum()) <= 2 * 3 * valid


def _write_text_data(root: str, vocab: int = 100, n: int = 12) -> tuple:
    """A tiny meme split, object annotations and a WordPiece vocabulary
    whose every word is one token."""
    rng = np.random.RandomState(0)
    words = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "<", "/", "s",
             ">", ","] + ["w%03d" % i for i in range(vocab - 10)]
    with open(os.path.join(root, "vocab.txt"), "w") as f:
        f.write("\n".join(words) + "\n")
    recs = [{"id": 100 + i, "img": "img/%d.png" % i, "label": int(i % 2),
             "text": " ".join("w%03d" % j for j in rng.randint(0, 80, 5))}
            for i in range(n)]
    for split in ("train", "dev_seen", "test_seen"):
        with open(os.path.join(root, split + ".jsonl"), "w") as f:
            f.write("\n".join(json.dumps(r) for r in recs) + "\n")
    np.savez(os.path.join(root, "objects.npz"),
             ids=np.array([r["id"] for r in recs]),
             objects=rng.randint(0, 5, (n, 6)),
             probs=rng.rand(n, 6).astype(np.float32))
    with open(os.path.join(root, "classes.json"), "w") as f:
        json.dump({str(i): "w%03d" % (80 + i) for i in range(5)}, f)
    return os.path.join(root, "vocab.txt")


@pytest.mark.parametrize("cli", ["train_object_text", "train_pure_text"])
def test_text_clis_train_moonlight(tmp_path, monkeypatch, cli):
    """``--model moonlight`` through the registry, ``init_text_model``,
    ``Trainer`` and ``make_train_step``, at the tiny size."""
    import importlib

    monkeypatch.setitem(PT.MODEL_DICT["moonlight"], "config", port_config())
    vocab = _write_text_data(str(tmp_path))
    mod = importlib.import_module("meme_challenge_tpu_torch.train." + cli)
    argv = ["--data_path", str(tmp_path), "--vocab_file", vocab,
            "--model", "moonlight", "--device", "cpu", "--max_epoch", "1",
            "--batch_size", "4", "--num_folds", "0",
            "--model_path", str(tmp_path / "out"), "--max_txt_len", "24"]
    if cli == "train_object_text":
        argv += ["--object_file", str(tmp_path / "objects.npz"),
                 "--object_to_text_file", str(tmp_path / "classes.json"),
                 "--obj_threshold_min", "0.3", "--obj_threshold_max", "0.7"]
    mod.main(argv)
    assert os.listdir(str(tmp_path / "out"))


# ------------------------------------------------------- the benchmark cell

def test_route_gap_counts_each_memes_first_differing_layer():
    """A pick set that differs outside the margin counts in the meme's
    first layer that differs; within the margin it never counts; the
    meme's later layers are left out."""
    from portbench.check_moe import ROUTE_MARGIN, route_gap

    want = np.zeros((3, 4, 8), bool)
    want[..., :2] = True
    rows = np.array([0, 0, 1, 1])
    wide = np.full((3, 4), 10 * ROUTE_MARGIN)
    assert route_gap(want.copy(), want, wide, rows) == 0
    got = want.copy()
    got[1, 2, 1], got[1, 2, 5] = False, True      # meme 1, layer 1
    got[2, 0, 0], got[2, 0, 6] = False, True      # meme 0, layer 2
    assert route_gap(got, want, wide, rows) == 2
    narrow = wide.copy()
    narrow[1, 2] = ROUTE_MARGIN / 2
    assert route_gap(got, want, narrow, rows) == 1
    got[0, 3, 0], got[0, 3, 7] = False, True      # meme 1 now from layer 0
    narrow[0, 3] = ROUTE_MARGIN / 2
    assert route_gap(got, want, narrow, rows) == 1


def test_flop_count_of_the_expert_launches():
    """The seven grouped launches of a layer count 22·H·I operations a
    routed row (forward 6, the recomputed gate_up 4, two dgrads and two
    wgrads 12) and the model FLOPs three forwards."""
    from portbench import flops_moe

    cfg = json.load(open(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "portbench", "configs", "moonlight-16b-a3b.json")))
    ops = sum(o for o, _ in flops_moe.expert_launches(cfg, 1000.0))
    assert ops == 22 * 2048 * 1408 * 1000.0
    assert flops_moe.step_flops(cfg, [], 10.0) == 3 * 6 * 2048 * 1408 * 10.0
    one = flops_moe.dense_forward_flops(cfg, 1)
    two = flops_moe.dense_forward_flops(cfg, 2)
    attn = 2.0 * 16 * (128 + 64 + 128) * 27
    head = 2.0 * 2048 * 512 + 2.0 * 512
    assert two - 2 * one + head == pytest.approx(attn)


@pytest.mark.parametrize("traced", [False, True], ids=["plain", "traced"])
def test_the_cell_at_a_tiny_size_on_the_cpu(monkeypatch, traced):
    """The cell ``moonlight_objtext_ft_fp32`` end to end through the
    harness on the CPU, its configuration narrowed and its traffic cut:
    the program reads ``correct`` against the reference under the cell's
    limits, and each of the three faults does not. Traced, the driver
    reads the expert rows around the profiled slice: the model FLOPs count
    the window's rows."""
    from portbench import harness
    from portbench.drivers.objtext_train import registry_config

    cell = harness.resolve("moonlight_objtext_ft_fp32")
    cell.cfg.update(vocab_size=2000, hidden_size=64, intermediate_size=96,
                    moe_intermediate_size=32, num_hidden_layers=3,
                    num_attention_heads=4, kv_lora_rank=32,
                    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                    n_routed_experts=4, n_routed_experts_published=8,
                    num_experts_per_tok=3, n_shared_experts=1,
                    initializer_range=0.1)
    cell.mix.update(memes=40, object_classes=16)
    cell.mix["train"] = dict(cell.mix["train"], batch_size=8, max_txt_len=48)
    monkeypatch.setitem(PT.MODEL_DICT["moonlight"], "config",
                        M.MoeMlaConfig(**registry_config(cell.cfg)))

    def faults(drv):
        return {k: drv.control(k) for k in R.FAULTS}

    out = harness.run(cell, 3_900_000_001, 0.3, traced, "cpu", 0.0,
                      control=faults)
    assert out["correct"], out["checks"]
    assert ("mfu.train" in out["metrics"]) == traced
    assert out["attempted"] >= 1
    for kind, numbers in out["control"].items():
        assert any(numbers[k] > cell.limits[k] for k in cell.limits), kind


def test_the_cell_takes_the_programs_near_ties(monkeypatch):
    """A program whose router decides every near tie (here a margin under
    a wide stand-in for ``ROUTE_MARGIN``) the other way from the reference's
    scores still reads ``correct``: the reference takes the program's picks
    there, recorded before each checked step. The same reference deciding
    those ties by its own scores parts from the program beyond the limits,
    so the ties the program decided were many and the check sees them."""
    from portbench import check_moe, harness
    from portbench.drivers.objtext_train import registry_config

    tie = 0.02
    monkeypatch.setattr(check_moe, "ROUTE_MARGIN", tie)
    cell = harness.resolve("moonlight_objtext_ft_fp32")
    cell.cfg.update(vocab_size=2000, hidden_size=64, intermediate_size=96,
                    moe_intermediate_size=32, num_hidden_layers=3,
                    num_attention_heads=4, kv_lora_rank=32,
                    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
                    n_routed_experts=4, n_routed_experts_published=8,
                    num_experts_per_tok=3, n_shared_experts=1,
                    initializer_range=0.1)
    cell.mix.update(memes=40, object_classes=16)
    cell.mix["train"] = dict(cell.mix["train"], batch_size=8, max_txt_len=48)
    monkeypatch.setitem(PT.MODEL_DICT["moonlight"], "config",
                        M.MoeMlaConfig(**registry_config(cell.cfg)))
    k = cell.cfg["num_experts_per_tok"]
    topk = torch.topk
    flipped = []

    def other_way(x, n, dim=-1):
        # the program's top-k (the reference asks for k + 1): the k-th and
        # the (k+1)-th swapped where they lie under half the tie apart
        if n != k:
            return topk(x, n, dim)
        values, idx = topk(x, k + 1, dim)
        near = (values[:, k - 1] - values[:, k]) < tie / 2
        flipped.append(int(near.sum()))
        swap = torch.where(near[:, None], idx[:, [k, k - 1]],
                           idx[:, k - 1:])
        idx = torch.cat([idx[:, :k - 1], swap[:, :1]], 1)
        return values[:, :k], idx

    monkeypatch.setattr(M.torch, "topk", other_way)

    def own_ties(drv):
        from portbench.check_moe import compare

        return compare(drv.program, drv.reference(), drv.mask())

    out = harness.run(cell, 3_900_000_002, 0.3, False, "cpu", 0.0,
                      control=own_ties)
    assert sum(flipped) > 0
    assert out["correct"], out["checks"]
    assert any(out["control"][n] > cell.limits[n] for n in cell.limits), \
        out["control"]


# ------------------------------------------------------------------ the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run python -m pytest --noconftest "
                    "-m card tests/test_torch_moe_mla.py on one")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _offsets(sizes, device):
    return torch.tensor([0] + list(np.cumsum(sizes)), dtype=torch.int32,
                        device=device)


@pytest.mark.card
@pytest.mark.parametrize("n,k", [(2816, 2048), (2048, 1408)],
                         ids=["gate_up", "down"])
def test_grouped_kernel_against_float64(card, n, k):
    """The cell's shapes: 8 held experts of a step's 6 144 tokens, about
    234 rows each, one empty; forward, dgrad and wgrad against float64 at
    the 3×TF32 kernel's accuracy, and the rows past the groups untouched."""
    rng = np.random.RandomState(n)
    sizes = list(rng.randint(150, 320, 8))
    sizes[5] = 0
    rows = 6144 * 6
    g = torch.Generator(device=card).manual_seed(n + k)
    x = torch.randn(rows, k, generator=g, device=card)
    dy = torch.randn(rows, n, generator=g, device=card)
    w = torch.randn(8, n, k, generator=g, device=card) / k ** 0.5
    off = _offsets(sizes, card)
    y = expert_linear.forward(x, w, off, 6144)
    dx = expert_linear.dgrad(dy, w, off, 6144)
    dw = expert_linear.wgrad(dy, x, off)
    torch.cuda.synchronize()
    end = int(off[-1])
    for gi in range(8):
        a, b = int(off[gi]), int(off[gi + 1])
        if a == b:
            assert not bool(dw[gi].any())
            continue
        x64, dy64, w64 = x[a:b].double(), dy[a:b].double(), w[gi].double()
        for got, want in ((y[a:b], x64 @ w64.t()), (dx[a:b], dy64 @ w64),
                          (dw[gi], dy64.t() @ x64)):
            err = float((got.double() - want).abs().max())
            assert err <= 2e-5 * float(want.abs().max())
    assert end < rows


@pytest.mark.card
def test_moonlight_step_replays_bit_for_bit(card):
    """A narrow Moonlight (published head and expert shapes, 3 layers, 8
    held experts) stepped by ``make_train_step``: the replayed steps equal
    the eager steps bit for bit, losses, parameters and moments, and the
    grouped kernel's launches counted alike."""
    from meme_challenge_tpu_torch.train import steps

    c = M.MoeMlaConfig(num_hidden_layers=3, vocab_size=1000)
    rc = ref_config(c)
    w = R.make_weights(rc, 0, card)

    def pair():
        with torch.device("meta"):
            model = PT.TransformerClassificationHead(M.MoeMlaBackbone(c),
                                                     dropout=0.5)
        model = model.to_empty(device=card)
        model.load_state_dict(w, strict=True)
        model.backbone.expert_rows.zero_()
        opt = Optimizer("adamw", 1e-4, lambda count: 1.0, weight_decay=1e-3,
                        max_grad_norm=5.0, mu_dtype="bfloat16",
                        nu_dtype="bfloat16")
        return (model, create_train_state(model, opt),
                make_train_step(model, TL.make_loss_fn("bce_logits", 1.0),
                                opt))

    (gm, gs, graphed), (em, es, eager) = pair(), pair()
    batches = []
    for i in range(3):
        b = _batch(10 + i, B=8, S=64, vocab=1000)
        batches.append({k: v[None].to(card) for k, v in b.items()})
    caps = steps.GRAPH_CAPTURES, steps.GRAPH_REPLAYS
    launches = [dict(expert_linear.LAUNCHES)]
    got, want = [], []
    for i, b in enumerate(batches):
        gs, out = graphed(gs, b, dropout_generator(3, i, card))
        got.append(out["loss"])
    launches.append(dict(expert_linear.LAUNCHES))
    for i, b in enumerate(batches):
        es, out = eager.eager(es, b, dropout_generator(3, i, card))
        want.append(out["loss"])
    launches.append(dict(expert_linear.LAUNCHES))
    torch.cuda.synchronize()
    assert (steps.GRAPH_CAPTURES, steps.GRAPH_REPLAYS) == (caps[0] + 1,
                                                           caps[1] + 2)
    # the grouped kernel's launches count at each replay, as eagerly
    moe_layers = c.num_hidden_layers - c.first_k_dense_replace
    for a, z in zip(launches, launches[1:]):
        assert {k: n - a[k] for k, n in z.items()} == {
            "forward": 9 * moe_layers, "dgrad": 6 * moe_layers,
            "wgrad": 6 * moe_layers}
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for (n, p), q in zip(gm.named_parameters(), em.parameters()):
        assert torch.equal(p, q), n
    for slot in ("mu", "nu"):
        for n in gs.opt_state[slot]:
            assert torch.equal(gs.opt_state[slot][n], es.opt_state[slot][n])
    assert torch.equal(gm.backbone.expert_rows, em.backbone.expert_rows)


@pytest.mark.card
def test_expert_layer_never_syncs_the_host(card):
    """The expert layer forward and backward at the cell's widths under
    ``set_sync_debug_mode("error")``: no operation waits for the card."""
    c = M.MoeMlaConfig()
    layer = M.MoE(c).to(card)
    with torch.no_grad():
        for p in layer.parameters():
            p.normal_(0.0, 0.02)
    x = torch.randn(8 * 192, c.hidden_size, device=card, requires_grad=True)
    valid = torch.rand(8 * 192, device=card) < 0.6
    counter = torch.zeros(c.experts_held, dtype=torch.int64, device=card)
    layer(x, valid, counter)  # lazy set-up (the kernel's library) first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = layer(x, valid, counter)
        out.square().sum().backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
