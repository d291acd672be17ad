"""UNITER single-stream vision+language encoder, inference parts, in PyTorch.

Counterpart of ``meme_challenge_tpu/models/uniter.py`` (:45-524). The math
follows the JAX modules step for step (dtype casts included), so logits agree
with them; the parameters follow the reference's torch key layout, which is
what ``meme_uniter_params_to_torch`` writes (the ``uniter_model.`` trunk, the
``linear.`` head, per-layer ``query``/``key``/``value`` and
``LayerNorm.weight``/``bias``). A reference checkpoint therefore loads with
``load_state_dict(strict=True)``.

- erf-GELU, post-LN BERT layers, fp32 LayerNorm with eps 1e-12, additive
  −10000 key mask (reference model/layer.py, model/model.py:342-345).
- The static ``[text | image]`` layout of the JAX package (no gather
  compaction); three input branches: text-only, image-only and joint.
- Attention has the three branches of the JAX encoder (:317-356): the fused
  kernel (``ops/attention.py``) when ``use_pallas_attention``, bf16 score
  storage with fp32 softmax math when ``attention_score_dtype`` is
  ``"bfloat16"``, and the plain fp32 path. The QKV, output and FFN products
  stay plain torch, as the JAX package left them to XLA.

This slice is inference only: ``deterministic=False`` (dropout) raises.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from meme_challenge_tpu_torch.core.config import UniterConfig
from meme_challenge_tpu_torch.ops.attention import (
    fused_attention,
    fused_attention_blocked,
)

NEG_INF = -10000.0  # additive mask value, reference model/model.py:345

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def erf_gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU (reference model/layer.py:31-37), not tanh approx."""
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def gelu_new(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximate GELU (HF 'gelu_new'; ALBERT-v2 checkpoints)."""
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * torch.pow(x, 3.0))))


ACT2FN = {
    "gelu": erf_gelu,
    "gelu_new": gelu_new,
    "relu": F.relu,
    "swish": F.silu,
}


def compute_dtype(config: UniterConfig) -> torch.dtype:
    return _DTYPES[config.dtype]


def softmax_lowp(scores: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis with fp32 math and storage in the input's
    (bf16) dtype — the forward of the JAX package's ``softmax_lowp``."""
    return torch.softmax(scores.float(), dim=-1).to(scores.dtype)


def _layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                eps: float, out_dtype: torch.dtype) -> torch.Tensor:
    """fp32 LayerNorm, eps 1e-12 (apex FusedLayerNorm parity)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * weight + bias).to(out_dtype)


class LayerNorm(nn.Module):
    """``weight``/``bias`` parameters applied by the fp32 :func:`_layer_norm`."""

    def __init__(self, hidden: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(hidden))
        self.bias = nn.Parameter(torch.zeros(hidden))

    def forward(self, x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
        return _layer_norm(x, self.weight, self.bias, self.eps, out_dtype)


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype
            ) -> torch.Tensor:
    """``x @ W.astype(dtype) + b.astype(dtype)``: product, then bias, each
    rounded to ``dtype`` as in the JAX encoder."""
    return F.linear(x, layer.weight.to(dtype)) + layer.bias.to(dtype)


class TextEmbeddings(nn.Module):
    """word + position + token-type embeddings → LN.

    Parity: reference UniterTextEmbeddings (model/model.py:217-245)."""

    def __init__(self, config: UniterConfig):
        super().__init__()
        self.config = config
        H = config.hidden_size
        self.word_embeddings = nn.Embedding(config.vocab_size, H)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, H)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size, H)
        self.LayerNorm = LayerNorm(H, config.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor, position_ids: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids.long())
             + self.position_embeddings(position_ids.long())
             + self.token_type_embeddings(token_type_ids.long()))
        return self.LayerNorm(x, compute_dtype(self.config))

    def type_embed(self, type_ids: torch.Tensor) -> torch.Tensor:
        return self.token_type_embeddings(type_ids.long())


class ImageEmbeddings(nn.Module):
    """img_linear(img_dim→H)+LN ⊕ pos_linear(7→H)+LN ⊕ type → LN.

    Parity: reference UniterImageEmbeddings (model/model.py:248-272), incl.
    the MRFR mask embedding added to raw features (row 0 pinned to zeros).
    """

    def __init__(self, config: UniterConfig):
        super().__init__()
        self.config = config
        H = config.hidden_size
        eps = config.layer_norm_eps
        self.img_linear = nn.Linear(config.img_dim, H)
        self.img_layer_norm = LayerNorm(H, eps)
        self.pos_linear = nn.Linear(config.pos_dim, H)
        self.pos_layer_norm = LayerNorm(H, eps)
        self.mask_embedding = nn.Embedding(2, config.img_dim)
        self.LayerNorm = LayerNorm(H, eps)

    def forward(self, img_feat: torch.Tensor, img_pos_feat: torch.Tensor,
                type_embeddings: torch.Tensor,
                img_masks: Optional[torch.Tensor] = None) -> torch.Tensor:
        if img_masks is not None:
            # Row 0 = "not masked" must contribute nothing; the reference
            # zeroes it in place each forward (model/model.py:261).
            w = self.mask_embedding.weight
            w = torch.cat([torch.zeros_like(w[:1]), w[1:]])
            img_feat = img_feat + F.embedding(img_masks.long(), w)
        im = self.img_layer_norm(self.img_linear(img_feat.float()),
                                 torch.float32)
        pos = self.pos_layer_norm(self.pos_linear(img_pos_feat.float()),
                                  torch.float32)
        return self.LayerNorm(im + pos + type_embeddings,
                              compute_dtype(self.config))


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, h = x.shape
    return x.reshape(b, s, n_heads, h // n_heads).permute(0, 2, 1, 3)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, n, s, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, s, n * d)


class _SelfAttention(nn.Module):
    def __init__(self, H: int):
        super().__init__()
        self.query = nn.Linear(H, H)
        self.key = nn.Linear(H, H)
        self.value = nn.Linear(H, H)


class _DenseLN(nn.Module):
    def __init__(self, d_in: int, H: int, eps: float):
        super().__init__()
        self.dense = nn.Linear(d_in, H)
        self.LayerNorm = LayerNorm(H, eps)


class _Attention(nn.Module):
    def __init__(self, H: int, eps: float):
        super().__init__()
        self.self = _SelfAttention(H)
        self.output = _DenseLN(H, H, eps)


class _Intermediate(nn.Module):
    def __init__(self, H: int, inner: int):
        super().__init__()
        self.dense = nn.Linear(H, inner)


class BertLayer(nn.Module):
    """One post-LN layer's parameters, under the reference's key names
    (model/layer.py:53-170)."""

    def __init__(self, config: UniterConfig):
        super().__init__()
        H, eps = config.hidden_size, config.layer_norm_eps
        self.attention = _Attention(H, eps)
        self.intermediate = _Intermediate(H, config.intermediate_size)
        self.output = _DenseLN(config.intermediate_size, H, eps)


class StackedEncoder(nn.Module):
    """L post-LN BERT layers (reference UniterEncoder, model/layer.py)."""

    def __init__(self, config: UniterConfig):
        super().__init__()
        self.config = config
        self.layer = nn.ModuleList(
            [BertLayer(config) for _ in range(config.num_hidden_layers)])

    def _attention(self, q, k, v, bias32, scale, dtype):
        cfg = self.config
        if cfg.use_pallas_attention:
            kernel = (fused_attention_blocked if cfg.pallas_blocked
                      else fused_attention)
            return kernel(q.contiguous(), k.contiguous(), v.contiguous(),
                          bias32, scale).to(dtype)
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
        if cfg.attention_score_dtype == "bfloat16":
            # bf16 S^2 storage, softmax math in fp32 (softmax_lowp)
            probs = softmax_lowp((scores + bias32).to(torch.bfloat16))
        else:
            probs = torch.softmax(scores + bias32, dim=-1)
        return torch.matmul(probs.to(dtype).float(), v.float()).to(dtype)

    def forward(self, hidden: torch.Tensor, attn_bias: torch.Tensor,
                deterministic: bool = True) -> torch.Tensor:
        if not deterministic:
            raise NotImplementedError(
                "dropout (training) comes with the training slice in "
                "ROADMAP.md; this encoder runs inference only")
        cfg = self.config
        dtype = compute_dtype(cfg)
        n_heads = cfg.num_attention_heads
        scale = 1.0 / math.sqrt(cfg.head_dim)
        act = ACT2FN[cfg.hidden_act]
        bias32 = attn_bias.float()
        x = hidden.to(dtype)
        for lp in self.layer:
            sa = lp.attention.self
            q, k, v = (_split_heads(_linear(x, lin, dtype), n_heads)
                       for lin in (sa.query, sa.key, sa.value))
            ctx = _merge_heads(self._attention(q, k, v, bias32, scale, dtype))
            ao = lp.attention.output
            x = ao.LayerNorm(_linear(ctx, ao.dense, dtype) + x, dtype)
            inter = act(_linear(x, lp.intermediate.dense, dtype))
            fo = lp.output
            x = fo.LayerNorm(_linear(inter, fo.dense, dtype) + x, dtype)
        return x


class Pooler(nn.Module):
    """tanh(W·h[CLS] + b) — reference BertPooler (model/layer.py:173-185)."""

    def __init__(self, config: UniterConfig):
        super().__init__()
        self.dense = nn.Linear(config.hidden_size, config.hidden_size)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense(hidden[:, 0].float()))


class UniterModel(nn.Module):
    """Joint vision-language encoder with the three input branches of
    reference UniterModel.forward (model/model.py:336-367): text-only,
    image-only and joint (text block then image block, static offsets).

    Inputs: input_ids/position_ids/txt_mask [B, T], img_feat [B, R, img_dim],
    img_pos_feat [B, R, 7], img_mask [B, R], img_masks [B, R] (MRFR,
    optional). Returns (sequence_output [B, S, H], joint_mask [B, S]).
    """

    def __init__(self, config: UniterConfig):
        super().__init__()
        self.config = config
        self.embeddings = TextEmbeddings(config)
        self.img_embeddings = ImageEmbeddings(config)
        self.encoder = StackedEncoder(config)
        self.pooler = Pooler(config)

    @staticmethod
    def _attn_bias(joint_mask: torch.Tensor) -> torch.Tensor:
        # [B, S] -> [B, 1, 1, S], additive −10000 on padding keys
        bias = (1.0 - joint_mask.float()) * NEG_INF
        return bias[:, None, None, :]

    def forward(self, input_ids, position_ids, img_feat, img_pos_feat,
                txt_mask=None, img_mask=None, img_masks=None,
                txt_type_ids=None, img_type_ids=None,
                deterministic: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        if input_ids is None:
            # image-only branch (model/model.py:348-351)
            if img_type_ids is None:
                img_type_ids = torch.ones(img_feat.shape[:2], dtype=torch.long,
                                          device=img_feat.device)
            emb = self.img_embeddings(img_feat, img_pos_feat,
                                      self.embeddings.type_embed(img_type_ids),
                                      img_masks)
            joint_mask = img_mask
        elif img_feat is None:
            # text-only branch (model/model.py:352-355)
            emb = self.embeddings(input_ids, position_ids, txt_type_ids)
            joint_mask = txt_mask
        else:
            txt_emb = self.embeddings(input_ids, position_ids, txt_type_ids)
            if img_type_ids is None:
                img_type_ids = torch.ones(img_feat.shape[:2], dtype=torch.long,
                                          device=img_feat.device)
            img_emb = self.img_embeddings(
                img_feat, img_pos_feat,
                self.embeddings.type_embed(img_type_ids), img_masks)
            emb = torch.cat([txt_emb.to(img_emb.dtype), img_emb], dim=1)
            joint_mask = torch.cat([txt_mask, img_mask], dim=1)
        seq = self.encoder(emb, self._attn_bias(joint_mask),
                           deterministic=deterministic)
        return seq, joint_mask

    def pool(self, sequence_output: torch.Tensor) -> torch.Tensor:
        return self.pooler(sequence_output)


class MemeUniter(nn.Module):
    """UNITER → pooler(CLS) → Linear(H, n_classes).

    Parity: reference model/meme_uniter.py:17-21 (``uniter_model`` trunk,
    ``linear`` head)."""

    def __init__(self, config: UniterConfig, n_classes: int = 1):
        super().__init__()
        self.config = config
        self.n_classes = n_classes
        self.uniter_model = UniterModel(config)
        self.linear = nn.Linear(config.hidden_size, n_classes)

    def forward(self, batch: Dict[str, torch.Tensor],
                deterministic: bool = True) -> torch.Tensor:
        seq, _ = self.uniter_model(
            input_ids=batch.get("input_ids"),
            position_ids=batch.get("position_ids"),
            img_feat=batch.get("img_feat"),
            img_pos_feat=batch.get("img_pos_feat"),
            txt_mask=batch.get("txt_mask"),
            img_mask=batch.get("img_mask"),
            deterministic=deterministic,
        )
        return self.linear(self.uniter_model.pool(seq))


def init_weights(module: nn.Module, generator: torch.Generator,
                 initializer_range: float) -> None:
    """The JAX package's initializers: normal(initializer_range) for every
    matrix and embedding table, zeros for biases, ones for LayerNorm scales.
    Draws from ``generator``, on the parameters' device."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif "LayerNorm" in name or "layer_norm" in name:
                p.fill_(1.0)
            else:
                p.normal_(0.0, initializer_range, generator=generator)


def init_meme_uniter(config: UniterConfig, n_classes: int, device,
                     generator: torch.Generator) -> MemeUniter:
    """A MemeUniter on ``device`` with random weights from ``generator``
    (built on the meta device first, so no weights are made twice)."""
    with torch.device("meta"):
        model = MemeUniter(config, n_classes=n_classes)
    model = model.to_empty(device=torch.device(device))
    init_weights(model, generator, config.initializer_range)
    return model.eval()
