"""Plain float32 Moonlight-16B-A3B (``deepseek_v3``) meme classifier: the
reference of the cell ``moonlight_objtext_ft_fp32``.

Plain ``torch`` operations, float32 products with TF32 off (``precision``),
no kernel, cache or batching of the program's; it imports nothing of the
program and no JAX. It follows the released ``modeling_deepseek.py`` of
https://huggingface.co/moonshotai/Moonlight-16B-A3B, except where noted:

- the trunk: token embeddings; per layer ``h = x + MLA(RMSNorm(x))``,
  ``out = h + FFN(RMSNorm(h))``; a final RMSNorm;
- MLA without q-LoRA: ``q_proj`` to 16 heads of 128 + 64, ``kv_a_proj_
  with_mqa`` to the 512-wide latent and one 64-wide rope key shared by the
  heads, the latent's RMSNorm, ``kv_b_proj`` to each head's 128 + 128 key
  and value; rotary (θ 50 000, no scaling) on the rope dims in the released
  code's interleaved layout; softmax over ``1/√192``, causal;
- layer 0 a SwiGLU of 11 264; layers 1-26 the router (``sigmoid`` scores,
  the top 6 of scores + ``e_score_correction_bias``, the picks' scores
  normalised over the 6 and scaled by 2.446) and the experts, each a SwiGLU
  of 1 408, plus the two shared experts as one SwiGLU of 2 816.

Departures, each as the configuration states them: only the chip's share
of the routed experts is computed (``n_routed_experts`` held from
``expert_offset``; the router's width is ``n_routed_experts_published``);
pad tokens (right padding) route nowhere and are masked as keys; the
classifier is the repository's head (dense 512, GELU, LayerNorm, one
logit, dropout 0.5 on its input and its hidden layer) over the last valid
token's state, not the language-model head; the weights are random from
the seed (:func:`make_weights`), which the benchmark also loads into the
program; the training step is AdamW with bfloat16 moments as the program's
optimizer stores them; a router's near tie (a margin that rounding may
decide either way) may be decided as the run's router decided it
(:func:`train_steps`), so that one rounding's pick does not part the two
trajectories.

``fault`` turns one part off, to show that the check refuses it:
``no_shared`` (shared experts dropped), ``no_renorm`` (top-k weights not
normalised) and ``bias_in_weights`` (the correction bias added to the
weights too).
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.train import leaf_norms, step_generator
from portbench.reference.uniter import bce_logits, precision, warmup_cosine

HEAD_HIDDEN = 512
HEAD_DROPOUT = 0.5
CORRECTION_STD = 1e-3   # the fixed router correction bias, assumed
ADAM_EPS = 1e-8
FAULTS = ("no_shared", "no_renorm", "bias_in_weights")


def held(cfg: dict) -> range:
    off = cfg.get("expert_offset", 0)
    return range(off, off + cfg["n_routed_experts"])


def param_spec(cfg: dict) -> List[tuple]:
    """(name, shape, kind) of every tensor the program's model holds, in
    the order :func:`make_weights` draws them; kind ``normal``, ``zeros``,
    ``ones`` or ``correction``."""
    H, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    lat, inner, I = (cfg["kv_lora_rank"], cfg["intermediate_size"],
                     cfg["moe_intermediate_size"])
    b = "backbone."
    spec = [(b + "embed_tokens.weight", (cfg["vocab_size"], H), "normal")]

    def swiglu(p, width):
        spec.extend([(p + "gate_proj.weight", (width, H), "normal"),
                     (p + "up_proj.weight", (width, H), "normal"),
                     (p + "down_proj.weight", (H, width), "normal")])

    for i in range(cfg["num_hidden_layers"]):
        p = b + "layers.%d." % i
        a = p + "self_attn."
        spec += [(p + "input_layernorm.weight", (H,), "ones"),
                 (a + "q_proj.weight", (heads * (nope + rope), H), "normal"),
                 (a + "kv_a_proj_with_mqa.weight", (lat + rope, H), "normal"),
                 (a + "kv_a_layernorm.weight", (lat,), "ones"),
                 (a + "kv_b_proj.weight", (heads * (nope + vd), lat),
                  "normal"),
                 (a + "o_proj.weight", (H, heads * vd), "normal"),
                 (p + "post_attention_layernorm.weight", (H,), "ones")]
        if i < cfg["first_k_dense_replace"]:
            swiglu(p + "mlp.", inner)
            continue
        n_held = cfg["n_routed_experts"]
        spec += [(p + "mlp.gate.weight",
                  (cfg["n_routed_experts_published"], H), "normal"),
                 (p + "mlp.gate.e_score_correction_bias",
                  (cfg["n_routed_experts_published"],), "correction"),
                 (p + "mlp.experts.gate_up", (n_held, 2 * I, H), "normal"),
                 (p + "mlp.experts.down", (n_held, H, I), "normal")]
        swiglu(p + "mlp.shared_experts.", I * cfg["n_shared_experts"])
    spec += [(b + "norm.weight", (H,), "ones"),
             ("head_dense_0.weight", (HEAD_HIDDEN, H), "normal"),
             ("head_dense_0.bias", (HEAD_HIDDEN,), "zeros"),
             ("head_ln_0.weight", (HEAD_HIDDEN,), "ones"),
             ("head_ln_0.bias", (HEAD_HIDDEN,), "zeros"),
             ("head_out.weight", (cfg.get("n_classes", 1), HEAD_HIDDEN),
              "normal"),
             ("head_out.bias", (cfg.get("n_classes", 1),), "zeros")]
    return spec


def is_buffer(name: str) -> bool:
    return name.endswith("e_score_correction_bias")


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of ``seed``: one standard normal draw for the matrices,
    tables and correction biases together, from a generator on ``device``,
    sliced in :func:`param_spec` order and scaled by ``initializer_range``
    (the correction biases by ``CORRECTION_STD``); zeros and ones for the
    rest. The same seed gives the same weights."""
    spec = param_spec(cfg)
    n = sum(math.prod(s) for _, s, k in spec if k in ("normal", "correction"))
    g = torch.Generator(device=torch.device(device)).manual_seed(int(seed))
    flat = torch.empty(n, device=device).normal_(0.0, 1.0, generator=g)
    out, off = {}, 0
    for name, shape, kind in spec:
        if kind in ("normal", "correction"):
            size = math.prod(shape)
            out[name] = flat[off:off + size].view(shape).mul_(
                cfg["initializer_range"] if kind == "normal"
                else CORRECTION_STD)
            off += size
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.ones(shape, device=device)
    return out


def decays(name: str) -> bool:
    """AdamW's decay: every matrix and table; not biases, norm scales or
    the correction buffer."""
    return not (name.endswith(("bias", "layernorm.weight", "head_ln_0.weight"))
                or name == "backbone.norm.weight")


# ------------------------------------------------------------------- the net

def rms_norm(x, w, eps):
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def swiglu(w, p, x):
    gate = x @ w[p + "gate_proj.weight"].t()
    up = x @ w[p + "up_proj.weight"].t()
    return (F.silu(gate) * up) @ w[p + "down_proj.weight"].t()


def rotary(x, pos, theta):
    """Rotary of ``x`` ``[..., S, d]`` whose dims are stored pairwise
    interleaved (the released code's ``view(d/2, 2).transpose``, then
    ``rotate_half``)."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, device=x.device,
                                       dtype=torch.float32) / d)
    ang = pos.float()[:, None] * inv[None]                     # [S, d/2]
    cos = torch.cat([ang.cos(), ang.cos()], -1)
    sin = torch.cat([ang.sin(), ang.sin()], -1)
    x = torch.cat([x[..., 0::2], x[..., 1::2]], -1)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * cos + rot * sin


def attention(w, p, x, valid, cfg):
    B, S, _ = x.shape
    nh, nope, rope, vd = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                          cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    lat = cfg["kv_lora_rank"]
    q = (x @ w[p + "q_proj.weight"].t()).view(B, S, nh, nope + rope)
    q = q.permute(0, 2, 1, 3)                                  # [B, h, S, .]
    ckv = x @ w[p + "kv_a_proj_with_mqa.weight"].t()
    c, k_rope = ckv[..., :lat], ckv[..., lat:]
    kv = rms_norm(c, w[p + "kv_a_layernorm.weight"], cfg["rms_norm_eps"]) \
        @ w[p + "kv_b_proj.weight"].t()
    kv = kv.view(B, S, nh, nope + vd).permute(0, 2, 1, 3)
    pos = torch.arange(S, device=x.device)
    q_rot = rotary(q[..., nope:], pos, cfg["rope_theta"])
    k_rot = rotary(k_rope[:, None], pos, cfg["rope_theta"])    # one head
    scores = (q[..., :nope] @ kv[..., :nope].transpose(-1, -2)
              + q_rot @ k_rot.transpose(-1, -2)) / math.sqrt(nope + rope)
    see = torch.tril(torch.ones(S, S, dtype=torch.bool, device=x.device))
    see = see[None, None] & valid[:, None, None, :]
    scores = scores.masked_fill(~see, float("-inf"))
    out = torch.softmax(scores, -1) @ kv[..., nope:]
    out = out.permute(0, 2, 1, 3).reshape(B, S, nh * vd)
    return out @ w[p + "o_proj.weight"].t()


def router(w, p, x, cfg, fault=None, force=None, tie=0.0):
    """(picks [T, k], weights [T, k], margins [T]) of the published router;
    the margin is the gap between the k-th and the (k+1)-th of the scores
    plus the correction bias. The picks are the first k of one top-(k+1),
    so that the picks the layer uses and the margin come from one
    selection (two top-k calls may break an exact tie apart). ``force``
    ``[T, k]``, where given, replaces the picks of the tokens whose margin
    is at most ``tie``: a near tie that rounding may decide either way is
    decided as ``force`` decided it."""
    k = cfg["num_experts_per_tok"]
    scores = torch.sigmoid(x @ w[p + "mlp.gate.weight"].t())
    corr = w[p + "mlp.gate.e_score_correction_bias"]
    top = torch.topk(scores + corr, k + 1, -1)
    picks = top.indices[:, :k]
    margins = top.values[:, k - 1] - top.values[:, k]
    if force is not None:
        picks = torch.where((margins <= tie)[:, None], force, picks)
    weights = scores.gather(1, picks)
    if fault == "bias_in_weights":
        weights = weights + corr[picks]
    if cfg["norm_topk_prob"] and fault != "no_renorm":
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    return picks, weights * cfg["routed_scaling_factor"], margins


def moe(w, p, x, valid, cfg, fault=None, record=None, force=None, tie=0.0):
    """The held experts' part plus the shared experts, of ``x`` [T, H];
    ``record``, where given, gets the layer's picks and margins; ``force``
    and ``tie`` as :func:`router`'s."""
    picks, weights, margins = router(w, p, x, cfg, fault, force, tie)
    if record is not None:
        record.append((picks, margins))
    I = cfg["moe_intermediate_size"]
    out = torch.zeros_like(x)
    for j, e in enumerate(held(cfg)):
        sel = (picks == e) & valid[:, None]                   # [T, k]
        tok = sel.any(-1).nonzero()[:, 0]
        if not tok.numel():
            continue
        wt = (weights * sel).sum(-1)[tok]
        gu = w[p + "mlp.experts.gate_up"][j]
        h = x[tok] @ gu.t()
        y = (F.silu(h[:, :I]) * h[:, I:]) @ w[p + "mlp.experts.down"][j].t()
        out = out.index_add(0, tok, y * wt[:, None])
    if fault != "no_shared":
        out = out + swiglu(w, p + "mlp.shared_experts.", x)
    return out


def hidden(w, input_ids, txt_mask, cfg, fault=None, record=None,
           force=None, tie=0.0):
    """The final-norm states ``[B, S, H]`` and the last valid token's;
    ``record`` as :func:`moe`'s, layer after layer; ``force``, where
    given, each expert layer's picks ``[B, S, k]`` for :func:`router`."""
    valid = txt_mask.bool()
    x = w["backbone.embed_tokens.weight"][input_ids.long()]
    eps = cfg["rms_norm_eps"]
    for i in range(cfg["num_hidden_layers"]):
        p = "backbone.layers.%d." % i
        x = x + attention(w, p + "self_attn.",
                          rms_norm(x, w[p + "input_layernorm.weight"], eps),
                          valid, cfg)
        y = rms_norm(x, w[p + "post_attention_layernorm.weight"], eps)
        if i < cfg["first_k_dense_replace"]:
            x = x + swiglu(w, p + "mlp.", y)
        else:
            B, S, H = y.shape
            f = None if force is None else \
                force[i - cfg["first_k_dense_replace"]].reshape(B * S, -1)
            x = x + moe(w, p, y.reshape(B * S, H), valid.reshape(-1), cfg,
                        fault, record, f, tie).view(B, S, H)
    x = rms_norm(x, w["backbone.norm.weight"], eps)
    last = valid.long().sum(1) - 1
    return x, x[torch.arange(x.shape[0], device=x.device), last]


def head(w, pooled, keep=None):
    """The repository's head; ``keep`` the two dropout masks (None: off)."""
    scale = 1.0 / (1.0 - HEAD_DROPOUT)
    x = pooled if keep is None else torch.where(keep[0], pooled * scale, 0.0)
    x = x @ w["head_dense_0.weight"].t() + w["head_dense_0.bias"]
    if keep is not None:
        x = torch.where(keep[1], x * scale, 0.0)
    x = 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + 1e-12) * w["head_ln_0.weight"] \
        + w["head_ln_0.bias"]
    return x @ w["head_out.weight"].t() + w["head_out.bias"]


def dropout_masks(gen, B: int, H: int, device) -> tuple:
    """The head's two masks of a forward of ``B`` rows, drawn from the
    step's generator in the program's order."""
    return (torch.rand((B, H), generator=gen, device=device)
            < 1.0 - HEAD_DROPOUT,
            torch.rand((B, HEAD_HIDDEN), generator=gen, device=device)
            < 1.0 - HEAD_DROPOUT)


# -------------------------------------------------------------- train steps

def adamw_step(w, grads, state: dict, tc: dict, total_steps: int) -> None:
    """One AdamW update in place, as the program's chain: clip to
    ``max_grad_norm``, Adam (moments stored in ``adam_mu_dtype`` /
    ``adam_nu_dtype``, math in float32), then ``+ weight_decay·w`` on the
    decayed leaves, times −lr·schedule(count before the update)."""
    b1, b2 = tc["beta1"], tc["beta2"]
    norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values()))
    scale = (tc["max_grad_norm"] / norm).float() \
        if norm >= tc["max_grad_norm"] else None
    count = state.setdefault("count", 0) + 1
    lr = tc["lr"] * warmup_cosine(count - 1, tc["warmup_steps"], total_steps)
    mu_t, nu_t = (getattr(torch, tc["adam_mu_dtype"]),
                  getattr(torch, tc["adam_nu_dtype"]))
    with torch.no_grad():
        for name, p in w.items():
            if is_buffer(name):
                continue
            g = grads[name] if scale is None else grads[name] * scale
            mu = (1.0 - b1) * g
            nu = (1.0 - b2) * g * g
            if name in state.get("mu", {}):
                mu = mu + b1 * state["mu"][name].float()
                nu = nu + b2 * state["nu"][name].float()
            u = (mu / (1.0 - b1 ** count)) / (
                torch.sqrt(nu / (1.0 - b2 ** count)) + ADAM_EPS)
            if decays(name):
                u = u + tc["weight_decay"] * p
            state.setdefault("mu", {})[name] = mu.to(mu_t)
            state.setdefault("nu", {})[name] = nu.to(nu_t)
            p.add_(u, alpha=-lr)
            del g, mu, nu, u
    state["count"] = count


def first_gradient(mu: Dict[str, torch.Tensor], beta1: float
                   ) -> Dict[str, float]:
    """Each leaf's norm of the gradient AdamW took at its first step (after
    the clip), from the first moment after it: ``mu / (1 − β1)`` (AdamW's
    decay is outside the moments)."""
    return {n: float(torch.linalg.vector_norm(m.float()) / (1.0 - beta1))
            for n, m in mu.items()}


def train_steps(cfg: dict, tc: dict, steps: List[dict], seed: int, device,
                total_steps: int, precision_kind: str = "float32",
                fault: Optional[str] = None, block: int = 8,
                tie: float = 0.0) -> dict:
    """The first optimizer steps from the weights of ``seed``: ``steps``,
    per step the host batch the run stepped (``input_ids``, ``txt_mask``,
    ``labels``, ``sample_mask``, each ``[accum, B, ...]``) and, where it
    holds ``picks`` (``[expert layers, accum, B, S, k]``, the experts the
    run's router picked), the picks that decide each near tie (a margin
    at most ``tie``; :func:`router`). A micro-batch
    runs ``block`` memes a forward and backward (the loss is a masked mean
    over the micro-batch, so the blocks' gradients add up to it). Returns
    what ``check_moe`` compares: each micro-batch's loss, the
    probabilities, the first gradient's and the change's norms by leaf, and
    the experts each valid token of the first micro-batch picked
    (:func:`first_picks`)."""
    with precision(precision_kind):
        w = make_weights(cfg, seed, device)
        for n, t in w.items():
            t.requires_grad_(not is_buffer(n))
        state: dict = {}
        losses, probs, grad = [], [], None
        for i, st in enumerate(steps):
            ids = torch.as_tensor(np.asarray(st["input_ids"]), device=device)
            tm = torch.as_tensor(np.asarray(st["txt_mask"]), device=device)
            labels = torch.as_tensor(np.asarray(st["labels"]), device=device)
            mask = torch.as_tensor(np.asarray(st["sample_mask"]),
                                   device=device)
            accum, B = ids.shape[:2]
            gen = step_generator(seed, i, device)
            step_loss, step_probs = [], []
            forced = st.get("picks")
            for a in range(accum):
                keep = dropout_masks(gen, B, cfg["hidden_size"], device)
                den = torch.clamp_min(mask[a].float().sum(), 1.0)
                total, pr = 0.0, []
                for r0 in range(0, B, block):
                    rows = slice(r0, min(r0 + block, B))
                    force = None if forced is None or tie < 0 else \
                        torch.as_tensor(np.asarray(forced)[:, a, rows],
                                        device=device).long()
                    _, pooled = hidden(w, ids[a, rows], tm[a, rows], cfg,
                                       fault, force=force, tie=tie)
                    logit = head(w, pooled, (keep[0][rows], keep[1][rows]))
                    part = bce_logits(logit, labels[a, rows], mask[a, rows],
                                      tc["pos_wt"]) \
                        * torch.clamp_min(mask[a, rows].float().sum(), 1.0) \
                        / den
                    part.backward()
                    total = total + part.detach()
                    pr.append(torch.sigmoid(logit.detach().reshape(-1)))
                step_loss.append(total)
                step_probs.append(torch.cat(pr))
            losses.append(torch.stack(step_loss))
            probs.append(torch.stack(step_probs))
            grads = {}
            for n, t in w.items():
                if not is_buffer(n):
                    grads[n] = (t.grad if t.grad is not None
                                else torch.zeros_like(t))
                    if accum > 1:
                        grads[n].div_(accum)
                t.grad = None
            adamw_step(w, grads, state, tc, total_steps)
            del grads
            if i == 0:
                grad = first_gradient(state["mu"], tc["beta1"])
        p0 = make_weights(cfg, seed, device)
        delta = leaf_norms({n: w[n].detach() - p0[n] for n in p0
                            if not is_buffer(n)})
        del p0
        with torch.no_grad():
            picks = first_picks(steps[0], cfg, seed, device, fault)
    return {"loss": torch.stack(losses).cpu().numpy().astype(np.float64),
            "probs": torch.stack(probs).cpu().numpy(),
            "grad": grad, "delta": delta, **picks}


def first_picks(st: dict, cfg: dict, seed: int, device,
                fault: Optional[str] = None) -> dict:
    """The first micro-batch of ``st`` under the weights of ``seed`` (made
    again: the trained ones are not used), with ``fault``: in every expert
    layer, the experts (of all the router's) each valid token picked and
    the gap between its k-th and (k+1)-th router scores (with the
    correction bias), as the layer used them; and each valid token's
    meme."""
    w0 = make_weights(cfg, seed, device)
    ids = torch.as_tensor(np.asarray(st["input_ids"])[0], device=device)
    tm = torch.as_tensor(np.asarray(st["txt_mask"])[0], device=device)
    record: list = []
    hidden(w0, ids, tm, cfg, fault, record)
    del w0
    valid = tm.bool().reshape(-1)
    n = cfg["n_routed_experts_published"]
    sets = [(picks[:, :, None] == torch.arange(n, device=device)).any(1)
            [valid].cpu().numpy() for picks, _ in record]
    margins = [m[valid].cpu().numpy() for _, m in record]
    rows = np.nonzero(np.asarray(st["txt_mask"])[0])[0]
    return {"pick_sets": np.stack(sets), "margins": np.stack(margins),
            "rows": rows}
