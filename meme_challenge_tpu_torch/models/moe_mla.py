"""A DeepSeek-V3-style decoder (Moonlight-16B-A3B) as a meme classifier.

The JAX package has no such model; this module is the port's own. The
trunk is the ``deepseek_v3`` architecture of Moonlight-16B-A3B
(https://huggingface.co/moonshotai/Moonlight-16B-A3B): token embeddings,
then per layer ``h = x + MLA(RMSNorm(x))`` and ``out = h + FFN(RMSNorm(h))``,
then a final RMSNorm. The classifier reads the hidden state of each row's
last valid token (right padding) through the text models'
``TransformerClassificationHead``.

- **MLA** (multi-head latent attention, no q-LoRA): ``q_proj`` to heads of
  ``qk_nope_head_dim + qk_rope_head_dim``; ``kv_a_proj_with_mqa`` to a
  latent of ``kv_lora_rank`` plus one rope key shared by every head; the
  latent through its RMSNorm and ``kv_b_proj`` to each head's nope key and
  value. Scores over ``√(nope + rope)``, causal over the valid keys, in
  plain torch (:class:`MLA`).
- **Rotary** on the rope dims only, in the released code's pairwise
  interleaved layout: the dims are de-interleaved, then rotated by
  ``rotate_half`` (:func:`apply_rope`).
- **FFN**: layers below ``first_k_dense_replace`` a SwiGLU of
  ``intermediate_size``; the rest a mixture of experts (:class:`MoE`):
  ``sigmoid`` router scores, the top ``num_experts_per_tok`` of the scores
  plus ``e_score_correction_bias`` (a fixed buffer, never trained), weights
  the scores without the bias normalised over the picks and scaled by
  ``routed_scaling_factor``, plus shared experts (one SwiGLU of
  ``n_shared_experts · moe_intermediate_size``).
- **Expert parallelism.** A layer holds ``experts_held`` of the router's
  ``n_routed_experts`` experts, from ``expert_offset``: it routes over all
  of them, normalises each token's weights over all its picks (as the
  replicated router of every chip does), and adds only its held experts'
  part and the shared experts. Nothing stands in for the experts held
  elsewhere or for the exchange. Pad tokens route nowhere.

Every dense product of the trunk goes through ``ops/linear.py`` (the
3×TF32 kernel on a card); the router's product and the top-k run in float32
torch. The experts' products go through ``ops/expert_linear.py``: the
routed rows sorted by held expert with torch operations a CUDA graph
captures (a stable sort and a cumulative count, nothing read on the host),
the group offsets read by the kernel on the device, the grid sized for
``tokens · min(top-k, held)`` rows (:class:`_RoutedExperts`). Its backward
recomputes the experts' first product rather than keeping ``[rows, 2·I]``
a layer.

Parameter names follow the released checkpoint's (``layers.{i}.self_attn.
q_proj.weight``, ``...mlp.gate.weight``, ``...mlp.shared_experts.*``)
except the held experts, stacked as ``mlp.experts.gate_up`` ``[held, 2·I,
H]`` (gate rows, then up rows) and ``mlp.experts.down`` ``[held, H, I]``.
A device counter, ``MoeMlaBackbone.expert_rows`` (not saved), adds the rows
each held expert got, summed over layers and forwards; a step graph adds to
it on each replay.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from meme_challenge_tpu_torch.models.uniter import embedding_lookup
from meme_challenge_tpu_torch.ops import expert_linear
from meme_challenge_tpu_torch.ops.linear import linear
from meme_challenge_tpu_torch.train.observability import span


@dataclasses.dataclass(frozen=True)
class MoeMlaConfig:
    """Moonlight-16B-A3B's ``config.json`` (the settings this module reads)
    and the chip's share of its experts."""

    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    first_k_dense_replace: int = 1
    num_attention_heads: int = 16
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    n_routed_experts: int = 64      # the router's width
    num_experts_per_tok: int = 6
    n_shared_experts: int = 2
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    rms_norm_eps: float = 1e-5
    rope_theta: float = 50000.0
    initializer_range: float = 0.02
    experts_held: int = 8           # this chip's share of an EP-8 layer
    expert_offset: int = 0
    has_pooler: bool = True          # the head reads the last valid token


class RMSNorm(nn.Module):
    def __init__(self, width: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(width))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.pow(2).mean(-1, keepdim=True)
        return self.weight * (x * torch.rsqrt(var + self.eps))


class _Linear(nn.Module):
    """A bias-free dense layer (``weight`` ``[out, in]``), through
    ``ops/linear.py``."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(d_out, d_in))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(x, self.weight, None)


class SwiGLU(nn.Module):
    """``down(silu(gate(x)) · up(x))``."""

    def __init__(self, hidden: int, inner: int):
        super().__init__()
        self.gate_proj = _Linear(hidden, inner)
        self.up_proj = _Linear(hidden, inner)
        self.down_proj = _Linear(inner, hidden)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


# ----------------------------------------------------------------- attention

def rope_tables(positions: torch.Tensor, dim: int, theta: float) -> tuple:
    """``cos``, ``sin`` ``[B, S, dim]`` of ``positions`` ``[B, S]``: the
    frequencies ``θ^(−2i/dim)`` repeated over the two halves."""
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, device=positions.device,
                                       dtype=torch.float32) / dim)
    freqs = positions.float()[..., None] * inv
    emb = torch.cat([freqs, freqs], -1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """Rotary on ``x`` ``[B, S, heads, dim]`` stored pairwise interleaved:
    de-interleave (even dims, then odd), then ``x·cos + rotate_half(x)·sin``
    (``cos``/``sin`` ``[B, S, dim]``)."""
    b, s, h, d = x.shape
    x = x.reshape(b, s, h, d // 2, 2).transpose(3, 4).reshape(b, s, h, d)
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * cos[:, :, None] + half * sin[:, :, None]


def causal_bias(valid: torch.Tensor) -> torch.Tensor:
    """``[B, 1, S, S]`` additive mask: query i sees the valid keys j ≤ i."""
    s = valid.shape[1]
    causal = torch.ones(s, s, dtype=torch.bool, device=valid.device).tril()
    see = causal[None] & valid.bool()[:, None, :]
    return torch.where(see, 0.0, float("-inf"))[:, None]


class MLA(nn.Module):
    def __init__(self, c: MoeMlaConfig):
        super().__init__()
        self.c = c
        h, heads = c.hidden_size, c.num_attention_heads
        self.q_proj = _Linear(h, heads * (c.qk_nope_head_dim
                                          + c.qk_rope_head_dim))
        self.kv_a_proj_with_mqa = _Linear(h, c.kv_lora_rank
                                          + c.qk_rope_head_dim)
        self.kv_a_layernorm = RMSNorm(c.kv_lora_rank, c.rms_norm_eps)
        self.kv_b_proj = _Linear(c.kv_lora_rank, heads * (c.qk_nope_head_dim
                                                          + c.v_head_dim))
        self.o_proj = _Linear(heads * c.v_head_dim, h)

    def forward(self, x, cos, sin, bias):
        c = self.c
        b, s, _ = x.shape
        heads, nope, rope = (c.num_attention_heads, c.qk_nope_head_dim,
                             c.qk_rope_head_dim)
        with span("meme.mla"):
            q = self.q_proj(x).view(b, s, heads, nope + rope)
            latent, k_pe = self.kv_a_proj_with_mqa(x).split(
                [c.kv_lora_rank, rope], -1)
            kv = self.kv_b_proj(self.kv_a_layernorm(latent)).view(
                b, s, heads, nope + c.v_head_dim)
            k_nope, v = kv.split([nope, c.v_head_dim], -1)
            q_pe = apply_rope(q[..., nope:], cos, sin)
            k_pe = apply_rope(k_pe.view(b, s, 1, rope), cos, sin)
            q = torch.cat([q[..., :nope], q_pe], -1).transpose(1, 2)
            k = torch.cat([k_nope, k_pe.expand(b, s, heads, rope)],
                          -1).transpose(1, 2)
            scores = q @ k.transpose(-1, -2) / math.sqrt(nope + rope) + bias
            out = torch.softmax(scores, -1) @ v.transpose(1, 2)
            return self.o_proj(out.transpose(1, 2).reshape(
                b, s, heads * c.v_head_dim))


# ------------------------------------------------------------------- experts

class _RoutedExperts(torch.autograd.Function):
    """The held experts' part of an MoE layer, ``Σ_s w[t,s]·E_s(x[t])``
    over each token's picks ``s`` that this chip holds.

    ``route``: ``row_token`` ``[R]`` (the token of each sorted row),
    ``row_weight`` ``[R]``, ``offsets`` ``[held + 1]`` int32, ``pos``
    ``[T, k]`` (each pick's sorted row) and ``held`` ``[T, k]``. ``R``, the
    rows' bound, is ``T · min(k, held)``; rows past ``offsets[-1]`` belong
    to no expert and are never read. The backward recomputes the first
    product from ``x``; the combine's weights get their gradient as
    ``⟨dout·W_down, a⟩``, so no expert output is kept."""

    @staticmethod
    def forward(ctx, x, w_gu, w_down, weights, row_token, row_pair, offsets,
                pos, held):
        bound = x.shape[0]
        a, _ = _expert_act(x, w_gu, row_token, offsets, bound)
        y = expert_linear.forward(a, w_down, offsets, bound)
        ctx.save_for_backward(x, w_gu, w_down, weights, row_token, row_pair,
                              offsets, pos, held)
        return _combine(y, weights, pos, held)

    @staticmethod
    def backward(ctx, dout):
        (x, w_gu, w_down, weights, row_token, row_pair, offsets, pos,
         held) = ctx.saved_tensors
        bound = x.shape[0]
        a, h = _expert_act(x, w_gu, row_token, offsets, bound)
        dy = dout.index_select(0, row_token)
        g = expert_linear.dgrad(dy, w_down, offsets, bound)      # [R, I]
        dweights = torch.where(held, (g * a).sum(-1)[pos], 0.0)
        w_row = weights.reshape(-1).index_select(0, row_pair)[:, None]
        dw_down = expert_linear.wgrad(dy * w_row, a, offsets)
        gate, up = h.chunk(2, -1)
        sg = torch.sigmoid(gate)
        da = g * w_row
        dh = torch.cat([da * up * sg * (1.0 + gate * (1.0 - sg)),
                        da * F.silu(gate)], -1)
        dx_rows = expert_linear.dgrad(dh, w_gu, offsets, bound)
        dw_gu = expert_linear.wgrad(dh, x.index_select(0, row_token), offsets)
        dx = _combine(dx_rows, None, pos, held)
        return dx, dw_gu, dw_down, dweights, None, None, None, None, None


def _expert_act(x, w_gu, row_token, offsets, bound):
    """``silu(gate)·up`` of the sorted rows, and their ``[gate | up]``."""
    h = expert_linear.forward(x.index_select(0, row_token), w_gu, offsets,
                              bound)
    gate, up = h.chunk(2, -1)
    return F.silu(gate) * up, h


def _combine(rows, weights, pos, held):
    """``Σ_s w[t,s]·rows[pos[t,s]]`` over the held picks (every weight 1
    where ``weights`` is None); rows of no held pick are never added."""
    picked = rows[pos]                                   # [T, k, H]
    if weights is not None:
        picked = picked * weights[..., None]
    return torch.where(held[..., None], picked, 0.0).sum(1)


def route(c: MoeMlaConfig, x: torch.Tensor, gate_w: torch.Tensor,
          correction: torch.Tensor, valid: torch.Tensor) -> dict:
    """The router of ``x`` ``[T, H]`` over all ``n_routed_experts``, in
    float32: each token's picks and weights, and the sort of the picks
    this chip holds (valid tokens only) into groups by held expert. Only
    torch operations that a CUDA graph captures; nothing is read on the
    host."""
    k, held_n = c.num_experts_per_tok, c.experts_held
    scores = torch.sigmoid(F.linear(x.float(), gate_w.float()))
    _, picks = torch.topk(scores + correction, k, dim=-1)
    weights = scores.gather(1, picks)
    if c.norm_topk_prob:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    weights = weights * c.routed_scaling_factor
    local = picks - c.expert_offset
    held = (local >= 0) & (local < held_n) & valid.bool()[:, None]
    key = torch.where(held, local, held_n).reshape(-1)
    order = torch.sort(key, stable=True)[1]
    bound = x.shape[0] * min(k, held_n)
    row_pair = order[:bound]
    counts = (key[:, None] == torch.arange(held_n, device=x.device)).sum(0)
    offsets = torch.cat([counts.new_zeros(1), counts.cumsum(0)]).int()
    inverse = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=x.device))
    pos = torch.where(held, inverse.view(held.shape), 0)
    return {"weights": weights, "picks": picks, "held": held,
            "row_pair": row_pair, "row_token": row_pair // k,
            "offsets": offsets, "pos": pos, "counts": counts}


class HeldExperts(nn.Module):
    def __init__(self, c: MoeMlaConfig):
        super().__init__()
        i, h = c.moe_intermediate_size, c.hidden_size
        self.gate_up = nn.Parameter(torch.empty(c.experts_held, 2 * i, h))
        self.down = nn.Parameter(torch.empty(c.experts_held, h, i))


class Router(nn.Module):
    def __init__(self, c: MoeMlaConfig):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(c.n_routed_experts,
                                               c.hidden_size))
        self.register_buffer("e_score_correction_bias",
                             torch.zeros(c.n_routed_experts))


class MoE(nn.Module):
    """The held experts' part of the routed experts, plus the shared
    experts."""

    def __init__(self, c: MoeMlaConfig):
        super().__init__()
        self.c = c
        self.gate = Router(c)
        self.experts = HeldExperts(c)
        self.shared_experts = SwiGLU(c.hidden_size, c.moe_intermediate_size
                                     * c.n_shared_experts)

    def forward(self, x: torch.Tensor, valid: torch.Tensor,
                counter: Optional[torch.Tensor] = None) -> torch.Tensor:
        shape = x.shape
        x2 = x.reshape(-1, shape[-1])
        with span("meme.moe.route"):
            r = route(self.c, x2, self.gate.weight,
                      self.gate.e_score_correction_bias, valid.reshape(-1))
            if counter is not None:
                counter.add_(r["counts"])
        with span("meme.moe.experts"):
            routed = _RoutedExperts.apply(
                x2, self.experts.gate_up, self.experts.down, r["weights"],
                r["row_token"], r["row_pair"], r["offsets"], r["pos"],
                r["held"])
        with span("meme.moe.combine"):
            return (routed + self.shared_experts(x2)).view(shape)


class DecoderLayer(nn.Module):
    def __init__(self, c: MoeMlaConfig, index: int):
        super().__init__()
        self.input_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps)
        self.self_attn = MLA(c)
        self.post_attention_layernorm = RMSNorm(c.hidden_size, c.rms_norm_eps)
        self.mlp = (SwiGLU(c.hidden_size, c.intermediate_size)
                    if index < c.first_k_dense_replace else MoE(c))

    def forward(self, x, cos, sin, bias, valid, counter):
        h = x + self.self_attn(self.input_layernorm(x), cos, sin, bias)
        y = self.post_attention_layernorm(h)
        if isinstance(self.mlp, MoE):
            return h + self.mlp(y, valid, counter)
        return h + self.mlp(y)


class MoeMlaBackbone(nn.Module):
    """Embeddings, decoder layers and the final norm → (sequence, the last
    valid token's state)."""

    def __init__(self, config: MoeMlaConfig):
        super().__init__()
        self.config = config
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size)
        self.layers = nn.ModuleList(DecoderLayer(config, i)
                                    for i in range(config.num_hidden_layers))
        self.norm = RMSNorm(config.hidden_size, config.rms_norm_eps)
        self.register_buffer("expert_rows", torch.zeros(
            config.experts_held, dtype=torch.int64), persistent=False)

    def forward(self, input_ids: torch.Tensor, txt_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        c = self.config
        valid = txt_mask.bool()
        x = embedding_lookup(self.embed_tokens.weight, input_ids)
        positions = torch.arange(input_ids.shape[1], device=x.device).expand(
            input_ids.shape)
        cos, sin = rope_tables(positions, c.qk_rope_head_dim, c.rope_theta)
        bias = causal_bias(valid)
        for layer in self.layers:
            x = layer(x, cos, sin, bias, valid, self.expert_rows)
        x = self.norm(x)
        last = (valid.long().sum(1) - 1).clamp_min(0)
        pooled = x[torch.arange(x.shape[0], device=x.device), last]
        return x, pooled


CORRECTION_STD = 1e-3  # the routers' fixed correction biases, assumed


def init_moe_mla_weights(model: nn.Module, generator: torch.Generator
                         ) -> None:
    """normal(initializer_range) for every matrix and table, ones for the
    RMSNorm scales; the routers' correction biases
    normal(``CORRECTION_STD``), fixed from then on."""
    backbone = model.backbone if hasattr(model, "backbone") else model
    std = backbone.config.initializer_range
    norms = {id(m.weight) for m in backbone.modules()
             if isinstance(m, RMSNorm)}
    with torch.no_grad():
        for p in backbone.parameters():
            if id(p) in norms:
                p.fill_(1.0)
            else:
                p.normal_(0.0, std, generator=generator)
        for m in backbone.modules():
            if isinstance(m, Router):
                m.e_score_correction_bias.normal_(0.0, CORRECTION_STD,
                                                  generator=generator)
        backbone.expert_rows.zero_()
