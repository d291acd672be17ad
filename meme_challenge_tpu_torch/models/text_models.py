"""Text-only transformer baselines in PyTorch.

Counterpart of ``meme_challenge_tpu/models/text_models.py``: the
``MODEL_DICT`` registry of BERT / BERT-large / RoBERTa(-large/-mnli) /
ALBERT / ELECTRA backbones (reference text_based/model.py:8-17) and
``TransformerClassificationHead`` (text_based/model.py:19-48), built on the
port's UNITER trunk pieces (``StackedEncoder``, ``Pooler``,
``_layer_norm``). The math follows the JAX modules step for step:

- **bert**: word + position + token-type embeddings → LayerNorm → dropout.
- **roberta**: position ids counted over non-pad tokens, offset by
  ``pad_token_id`` (:func:`roberta_position_ids`); type vocabulary 1;
  LayerNorm eps 1e-5.
- **albert**: factorized embeddings (LayerNorm and dropout at
  ``embedding_size``, then ``emb_proj`` up to the hidden width) and ONE
  shared layer (a ``StackedEncoder`` of one layer) applied L times, so its
  gradient is the sum over the applications and dropout draws in
  application order.
- **electra**: factorized embeddings, no pooler (the head reads
  ``seq[:, 0]``).

The attention is the encoder's plain torch branch: the JAX text models
never set ``use_pallas_attention``, so no fused kernel runs on this path.

Parameter names follow HuggingFace's backbone layout (``embeddings.*``,
``encoder.layer.{i}.*``, ``pooler.dense.*``) plus ``emb_proj`` under
``backbone.``, and the JAX head names (``head_dense_{i}``, ``head_ln_{i}``,
``head_out``), so ``train.optim``'s ``head_lr_scales`` (a name part
starting with ``head_``), ``layer_freeze_scales`` (``encoder.layer.{i}.``;
ALBERT's shared layer is layer 0) and the weight-decay mask give every
parameter the scale JAX gives its counterpart. :func:`init_text_model`
draws from JAX's initializers: normal(0.02) for the embeddings, encoder,
pooler and ``emb_proj``, flax's lecun-normal for the head's Dense layers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from meme_challenge_tpu_torch.core.config import UniterConfig
from meme_challenge_tpu_torch.models.uniter import (
    NEG_INF,
    LayerNorm,
    Pooler,
    StackedEncoder,
    _layer_norm,
    bernoulli_dropout,
    compute_dtype,
    embedding_lookup,
    erf_gelu,
    init_weights,
)


@dataclasses.dataclass(frozen=True)
class TextModelConfig:
    """Architecture spec for one registry entry (the JAX package's fields
    and defaults)."""

    family: str = "bert"            # bert | roberta | albert | electra
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    embedding_size: Optional[int] = None   # albert/electra factorization
    pad_token_id: int = 0
    layer_norm_eps: float = 1e-12
    hidden_act: str = "gelu"               # albert-v2: "gelu_new" (tanh)
    hidden_dropout_prob: float = 0.1       # albert-v2 checkpoints: 0.0
    attention_probs_dropout_prob: float = 0.1
    shared_layers: bool = False            # albert
    has_pooler: bool = True                # electra: False
    dtype: str = "float32"
    attention_score_dtype: str = "float32"  # bf16 S^2 storage
    dropout_bits_dtype: str = "uint32"      # uint8 dropout words

    def encoder_config(self) -> UniterConfig:
        L = 1 if self.shared_layers else self.num_hidden_layers
        return UniterConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            num_hidden_layers=L,
            num_attention_heads=self.num_attention_heads,
            intermediate_size=self.intermediate_size,
            max_position_embeddings=self.max_position_embeddings,
            type_vocab_size=max(self.type_vocab_size, 1),
            hidden_act=self.hidden_act,
            hidden_dropout_prob=self.hidden_dropout_prob,
            attention_probs_dropout_prob=self.attention_probs_dropout_prob,
            layer_norm_eps=self.layer_norm_eps, dtype=self.dtype,
            attention_score_dtype=self.attention_score_dtype,
            dropout_bits_dtype=self.dropout_bits_dtype)


# reference MODEL_DICT (text_based/model.py:8-17); the HF checkpoint names
# say which torch dump each entry's architecture is
MODEL_DICT: Dict[str, Dict[str, Any]] = {
    "bert": {"config": TextModelConfig(), "pretrain": "bert-base-uncased"},
    "bert_large": {
        "config": TextModelConfig(hidden_size=1024, num_hidden_layers=24,
                                  num_attention_heads=16,
                                  intermediate_size=4096),
        "pretrain": "bert-large-uncased"},
    "roberta": {
        "config": TextModelConfig(family="roberta", vocab_size=50265,
                                  max_position_embeddings=514,
                                  type_vocab_size=1, pad_token_id=1,
                                  layer_norm_eps=1e-5),
        "pretrain": "roberta-base"},
    "roberta_large": {
        "config": TextModelConfig(family="roberta", vocab_size=50265,
                                  hidden_size=1024, num_hidden_layers=24,
                                  num_attention_heads=16,
                                  intermediate_size=4096,
                                  max_position_embeddings=514,
                                  type_vocab_size=1, pad_token_id=1,
                                  layer_norm_eps=1e-5),
        "pretrain": "roberta-large"},
    "roberta_mnli": {
        "config": TextModelConfig(family="roberta", vocab_size=50265,
                                  hidden_size=1024, num_hidden_layers=24,
                                  num_attention_heads=16,
                                  intermediate_size=4096,
                                  max_position_embeddings=514,
                                  type_vocab_size=1, pad_token_id=1,
                                  layer_norm_eps=1e-5),
        "pretrain": "roberta-large-mnli"},
    "albert": {
        "config": TextModelConfig(family="albert", hidden_size=2048,
                                  num_hidden_layers=24,
                                  num_attention_heads=16,
                                  intermediate_size=8192,
                                  embedding_size=128, shared_layers=True,
                                  hidden_act="gelu_new",
                                  hidden_dropout_prob=0.0,
                                  attention_probs_dropout_prob=0.0),
        "pretrain": "albert-xlarge-v2"},
    "albert_large": {
        "config": TextModelConfig(family="albert", hidden_size=4096,
                                  num_hidden_layers=12,
                                  num_attention_heads=64,
                                  intermediate_size=16384,
                                  embedding_size=128, shared_layers=True,
                                  hidden_act="gelu_new",
                                  hidden_dropout_prob=0.0,
                                  attention_probs_dropout_prob=0.0),
        "pretrain": "albert-xxlarge-v2"},
    "electra": {
        "config": TextModelConfig(family="electra", hidden_size=256,
                                  num_hidden_layers=12,
                                  num_attention_heads=4,
                                  intermediate_size=1024,
                                  embedding_size=128, has_pooler=False),
        "pretrain": "google/electra-small-discriminator"},
}

TEXT_INIT_RANGE = 0.02  # the JAX backbone's _init(0.02)


def roberta_position_ids(input_ids: torch.Tensor, pad_id: int
                         ) -> torch.Tensor:
    """HF create_position_ids_from_input_ids: cumulative count of non-pad
    tokens, offset by pad_id; pad positions get pad_id."""
    mask = (input_ids != pad_id).long()
    return torch.cumsum(mask, dim=1) * mask + pad_id


class _Embeddings(nn.Module):
    """word + position + token-type tables and their LayerNorm, at the
    embedding width (HF ``embeddings.*`` keys)."""

    def __init__(self, cfg: TextModelConfig):
        super().__init__()
        emb = cfg.embedding_size or cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, emb)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings,
                                                emb)
        self.token_type_embeddings = nn.Embedding(
            max(cfg.type_vocab_size, 1), emb)
        self.LayerNorm = LayerNorm(emb, cfg.layer_norm_eps)


class TextBackbone(nn.Module):
    """Family-parametrized text encoder → (sequence_output, pooled)."""

    def __init__(self, config: TextModelConfig):
        super().__init__()
        self.config = config
        self.encoder_config = config.encoder_config()
        emb = config.embedding_size or config.hidden_size
        self.embeddings = _Embeddings(config)
        self.emb_proj = (nn.Linear(emb, config.hidden_size)
                         if emb != config.hidden_size else None)
        self.encoder = StackedEncoder(self.encoder_config)
        self.pooler = (Pooler(self.encoder_config) if config.has_pooler
                       else None)

    def forward(self, input_ids: torch.Tensor, txt_mask: torch.Tensor,
                token_type_ids: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        cfg = self.config
        gen = None if deterministic else generator
        input_ids = input_ids.long()
        if cfg.family == "roberta":
            position_ids = roberta_position_ids(input_ids, cfg.pad_token_id)
        else:
            position_ids = torch.arange(
                input_ids.shape[1], device=input_ids.device).expand_as(
                    input_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        e = self.embeddings
        x = (embedding_lookup(e.word_embeddings.weight, input_ids)
             + embedding_lookup(e.position_embeddings.weight, position_ids)
             + embedding_lookup(e.token_type_embeddings.weight,
                                token_type_ids))
        x = _layer_norm(x, e.LayerNorm.weight, e.LayerNorm.bias,
                        cfg.layer_norm_eps, compute_dtype(self.encoder_config))
        x = bernoulli_dropout(x, cfg.hidden_dropout_prob, gen)
        if self.emb_proj is not None:
            # flax Dense promotes a bf16 input to its fp32 kernel
            x = self.emb_proj(x.float())
        bias = ((1.0 - txt_mask.float()) * NEG_INF)[:, None, None, :]
        # ALBERT: one parameter set applied L times; otherwise L layers once
        for _ in range(cfg.num_hidden_layers if cfg.shared_layers else 1):
            x = self.encoder(x, bias, deterministic=deterministic,
                             generator=gen)
        pooled = self.pooler(x) if self.pooler is not None else x[:, 0]
        return x, pooled


class TransformerClassificationHead(nn.Module):
    """MLP head over the pooled output (or CLS state).

    Parity: reference TransformerClassificationHead (text_based/model.py:
    19-48): Dropout → [Dense(hidden_dim) → Dropout → act → LayerNorm] ×
    num_layers → Dense(num_classes), in fp32. ``use_pool_output`` picks the
    backbone's pooler output where the backbone has a pooler."""

    def __init__(self, backbone: TextBackbone, num_classes: int = 1,
                 num_layers: int = 1, hidden_dim: int = 512,
                 dropout: float = 0.0, act: str = "gelu",
                 use_pool_output: bool = True):
        super().__init__()
        self.backbone = backbone
        self.num_layers = num_layers
        self.dropout = dropout
        self.act = erf_gelu if act == "gelu" else F.relu
        self.use_pool_output = use_pool_output
        d_in = backbone.config.hidden_size
        for i in range(num_layers):
            self.add_module("head_dense_%d" % i, nn.Linear(d_in, hidden_dim))
            # flax nn.LayerNorm of the JAX head: eps 1e-12
            self.add_module("head_ln_%d" % i, LayerNorm(hidden_dim, 1e-12))
            d_in = hidden_dim
        self.head_out = nn.Linear(d_in, num_classes)

    def forward(self, batch: Dict[str, torch.Tensor],
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not deterministic and generator is None:
            raise ValueError("dropout (deterministic=False) draws from a "
                             "torch.Generator; pass generator=")
        gen = None if deterministic else generator
        seq, pooled = self.backbone(
            batch["input_ids"], batch["txt_mask"], batch.get("token_type_ids"),
            deterministic=deterministic, generator=gen)
        x = (pooled if self.use_pool_output and self.backbone.config.has_pooler
             else seq[:, 0]).float()
        x = bernoulli_dropout(x, self.dropout, gen)
        for i in range(self.num_layers):
            x = getattr(self, "head_dense_%d" % i)(x)
            x = self.act(bernoulli_dropout(x, self.dropout, gen))
            x = getattr(self, "head_ln_%d" % i)(x, torch.float32)
        return self.head_out(x)


def build_text_model(name: str, num_classes: int = 1, dropout: float = 0.5,
                     num_layers: int = 1, hidden_dim: int = 512,
                     compute_bf16: bool = False
                     ) -> TransformerClassificationHead:
    """Registry lookup + head assembly (reference train_pure_text.py:25-41),
    with torch's default initial weights (:func:`init_text_model` draws
    JAX's). ``compute_bf16`` adds bf16 compute, bf16 score storage and uint8
    dropout words."""
    if name not in MODEL_DICT:
        raise ValueError("Given model is not known. Please choose between: "
                         "%s" % list(MODEL_DICT.keys()))
    cfg = MODEL_DICT[name]["config"]
    if compute_bf16:
        cfg = dataclasses.replace(cfg, dtype="bfloat16",
                                  attention_score_dtype="bfloat16",
                                  dropout_bits_dtype="uint8")
    return TransformerClassificationHead(
        TextBackbone(cfg), num_classes=num_classes, num_layers=num_layers,
        hidden_dim=hidden_dim, dropout=dropout, act="gelu",
        use_pool_output=True)


def init_text_weights(model: TransformerClassificationHead,
                      generator: torch.Generator) -> None:
    """JAX's initializers: normal(0.02) for every backbone matrix and table,
    zeros for biases, ones for LayerNorm scales; the head's Dense kernels
    flax's lecun-normal (a normal truncated at two deviations, scaled to
    variance 1 / fan_in)."""
    init_weights(model, generator, TEXT_INIT_RANGE)
    heads = [m for n, m in model.named_children()
             if n.startswith("head_") and isinstance(m, nn.Linear)]
    with torch.no_grad():
        for lin in heads:
            # flax truncated_normal stddev: sqrt(scale / fan_in) / .8796...
            std = math.sqrt(1.0 / lin.in_features) / .87962566103423978
            nn.init.trunc_normal_(lin.weight, 0.0, std, -2.0 * std,
                                  2.0 * std, generator=generator)


def init_text_model(name: str, num_classes: int, device,
                    generator: torch.Generator, compute_bf16: bool = False
                    ) -> TransformerClassificationHead:
    """``build_text_model(name, num_classes)`` on ``device`` with random
    weights from ``generator`` (built on the meta device first, so no
    weights are made twice)."""
    with torch.device("meta"):
        model = build_text_model(name, num_classes=num_classes,
                                 compute_bf16=compute_bf16)
    model = model.to_empty(device=torch.device(device))
    init_text_weights(model, generator)
    return model.eval()
