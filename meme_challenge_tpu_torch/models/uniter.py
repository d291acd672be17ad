"""UNITER single-stream vision+language encoder in PyTorch.

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
  go through ``ops/linear.py``: float32 on a card takes its 3×TF32 kernel,
  everything else ``F.linear`` and the bias add.
- Training (``deterministic=False``) applies dropout where the JAX package
  does: flax-style Bernoulli dropout after the text and image embeddings,
  and the encoder's integer-threshold dropout (``keep iff bits >= rate·2³²``,
  or ``bits >= round(rate·256)`` with ``dropout_bits_dtype="uint8"``) on
  the attention probabilities and before each residual. With the fused
  kernel the attention dropout runs inside it, from int32 seeds drawn per
  layer. Every random draw comes from the ``torch.Generator`` the caller
  passes; the JAX PRNG streams are not reproduced, only their
  distributions.
- ``remat`` checkpoints each encoder layer in training (``_remat_layer``),
  replaying its dropout draws in the recompute.
- :class:`FoldStack` runs F MemeUniters of one configuration as one model
  (the JAX fold-parallel trainer's ``vmap`` over a fold axis, written out):
  every parameter carries a leading ``[F, ...]`` axis, the products are
  batched over F (``bmm``), LayerNorm takes ``[F, 1, 1, H]`` weights, the
  embedding lookups index each fold's table, and attention runs once for
  all folds with F in the kernel's batch axis. Fold f's dropout draws from
  its own generator, in the order and shapes a single MemeUniter draws, so
  fold f of the stack equals the single model given that generator.
- A FoldStack can be one rank's part of a run over a mesh
  (``parallel/fold_parallel.py``): its folds, the rows of each fold's
  micro-batch that :class:`ShardedGenerators` name (a ``data`` axis), and
  with a :class:`ModelSplit` the Megatron column/row split of the encoder's
  products, the vocabulary rows of the word embeddings and the output
  features of ``img_linear`` (a ``model`` axis): an all-reduce after each
  row-split product and after the masked embedding lookup, an all-gather
  after ``img_linear``. Every dropout draw is made at the whole run's
  shape and sliced, and the attention kernels hash the global pair
  (``ops.attention.SeedShard``), so the rank's masks are the slices of the
  one-process run's.
- :class:`UniterForPretraining` (JAX models/uniter.py:527-716) puts the
  MLM, MRFR, ITM and MRC heads on the trunk under the reference's
  pretraining keys; the MLM and MRFR decoders are the word embedding table
  and ``img_linear``'s weight (tied).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from meme_challenge_tpu_torch.core.config import UniterConfig
from meme_challenge_tpu_torch.ops.attention import (
    SeedShard,
    blocked_seed_count,
    fused_attention,
    fused_attention_blocked,
)
from meme_challenge_tpu_torch.ops.linear import LINEAR_OP, linear

NEG_INF = -10000.0  # additive mask value, reference model/model.py:345

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the matrix products whose outputs remat_policy "dots" keeps (LINEAR_OP:
# the encoder's fp32 products on a card, ops/linear.py)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default,
         torch.ops.aten.matmul.default, LINEAR_OP)

# one torch.Generator, or one per fold of a FoldStack (a fold-stacked
# tensor's leading axis is the fold axis)
Generators = Union[torch.Generator, Sequence[torch.Generator], None]


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """Selective-checkpoint policy of remat_policy "dots" (JAX
    ``checkpoint_policies.checkpoint_dots``): keep the products, recompute
    the rest. The fused attention kernel is no aten operation and is
    recomputed, as the Pallas call is under ``checkpoint_dots``."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


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


class _SoftmaxLowp(torch.autograd.Function):
    """The JAX package's ``softmax_lowp`` custom VJP: the saved residual is
    the low-precision p itself (not torch's fp32 softmax output), so ds is
    computed from, and rounded to, the same values as in JAX."""

    @staticmethod
    def forward(ctx, scores):
        p = torch.softmax(scores.float(), dim=-1).to(scores.dtype)
        ctx.save_for_backward(p)
        return p

    @staticmethod
    def backward(ctx, g):
        p, = ctx.saved_tensors
        p32, g32 = p.float(), g.float()
        ds = p32 * (g32 - (g32 * p32).sum(dim=-1, keepdim=True))
        return ds.to(p.dtype)


def softmax_lowp(scores: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis with fp32 math and storage in the input's
    (bf16) dtype, differentiable as the JAX package's ``softmax_lowp``."""
    return _SoftmaxLowp.apply(scores)


class ShardedGenerators(list):
    """One generator a fold, for a rank that holds rows ``[row0, row0 + n)``
    of each fold's micro-batch of ``rows`` (a ``data`` mesh axis): every
    draw is made at the whole micro-batch's shape and the rank keeps its
    rows, so its masks are the one-process run's."""

    def __init__(self, generators, row0: int, rows: int):
        super().__init__(generators)
        self.row0, self.rows = row0, rows


def _draw(fn, shape, generator: Generators,
          heads: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """``fn(shape, generator)``; with one generator per fold, each fold's
    slice (``shape[1:]``) from its own generator, stacked on the fold axis.
    A fold's draw has the whole micro-batch's rows (:class:`ShardedGenerators`)
    and, with ``heads = (head0, total)``, all ``total`` heads in dim 2; the
    rank's rows and heads are sliced from it."""
    if isinstance(generator, torch.Generator):
        return fn(tuple(shape), generator)
    if len(generator) != shape[0]:
        raise ValueError("%d generators for %d folds"
                         % (len(generator), shape[0]))
    full, index = list(shape[1:]), [slice(None)] * (len(shape) - 1)
    row0 = getattr(generator, "row0", 0)
    full[0] = getattr(generator, "rows", shape[1])
    index[0] = slice(row0, row0 + shape[1])
    if heads is not None:
        full[1], index[1] = heads[1], slice(heads[0], heads[0] + shape[2])
    return torch.stack([fn(tuple(full), g)[tuple(index)] for g in generator])


def bernoulli_dropout(x: torch.Tensor, rate: float,
                      generator: Generators) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 − rate, kept values
    divided by 1 − rate; identity without a generator or at rate 0."""
    if generator is None or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = _draw(lambda shape, g: torch.rand(shape, generator=g,
                                             device=x.device),
                 x.shape, generator) < keep_prob
    return torch.where(keep, x / keep_prob, x.new_zeros(()))


def threshold_dropout(x: torch.Tensor, rate: float, generator: Generators,
                      bits8: bool = False,
                      heads: Optional[Tuple[int, int]] = None
                      ) -> torch.Tensor:
    """The JAX encoder's integer-threshold dropout (models/uniter.py:284-302
    there): uint32 words kept iff ``bits >= rate·2³²``, scaled by
    1/(1 − rate); with ``bits8`` uint8 words kept iff ``bits >= k``,
    ``k = round(rate·256)``, scaled by the exact effective rate,
    1/(1 − k/256). Identity without a generator or at rate 0."""
    if generator is None or rate == 0.0:
        return x
    if bits8:
        k = min(int(round(rate * 256)), 255)
        high, dtype, eff = 256, torch.uint8, k / 256.0
    else:
        k = min(int(rate * (1 << 32)), (1 << 32) - 1)
        high, dtype, eff = 1 << 32, torch.int64, rate
    bits = _draw(lambda shape, g: torch.randint(
        0, high, shape, generator=g, device=x.device, dtype=dtype),
        x.shape, generator, heads)
    return torch.where(bits >= k, x / (1.0 - eff), x.new_zeros(())).to(x.dtype)


def _layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                eps: float, out_dtype: torch.dtype) -> torch.Tensor:
    """fp32 LayerNorm, eps 1e-12 (apex FusedLayerNorm parity)."""
    x32 = x.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * weight + bias).to(out_dtype)


def embedding_lookup(weight: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids`` of the table ``weight`` by a lookup whose backward
    repeats bit for bit, and not ``F.embedding``: on a card, its backward
    of more than 3 072 ids accumulates with atomics, in an order that
    changes from run to run. On a card the lookup is an index
    (``weight[ids]``), whose backward sorts the ids and sums each row in a
    fixed order; on the CPU, where the index's backward adds with atomics
    across threads, it is ``index_select``, whose backward adds the rows
    one id after another. The forward is the same."""
    ids = ids.long()
    if weight.device.type == "cuda":
        return weight[ids]
    return weight.index_select(0, ids.reshape(-1)).reshape(
        ids.shape + weight.shape[1:])


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
    rounded to ``dtype`` as in the JAX encoder (``ops/linear.py: linear``:
    float32 on a card in one 3×TF32 kernel, the bias in its epilogue)."""
    return linear(x, layer.weight.to(dtype), layer.bias.to(dtype))


class TextEmbeddings(nn.Module):
    """word + position + token-type embeddings → LN → dropout.

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
                token_type_ids: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (embedding_lookup(self.word_embeddings.weight, input_ids)
             + embedding_lookup(self.position_embeddings.weight, position_ids)
             + embedding_lookup(self.token_type_embeddings.weight,
                                token_type_ids))
        x = self.LayerNorm(x, compute_dtype(self.config))
        return bernoulli_dropout(x, self.config.hidden_dropout_prob, generator)

    def type_embed(self, type_ids: torch.Tensor) -> torch.Tensor:
        return embedding_lookup(self.token_type_embeddings.weight, type_ids)


class ImageEmbeddings(nn.Module):
    """img_linear(img_dim→H)+LN ⊕ pos_linear(7→H)+LN ⊕ type → LN → dropout.

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
                img_masks: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if img_masks is not None:
            # Row 0 = "not masked" must contribute nothing; the reference
            # zeroes it in place each forward (model/model.py:261).
            w = self.mask_embedding.weight
            w = torch.cat([torch.zeros_like(w[:1]), w[1:]])
            img_feat = img_feat + embedding_lookup(w, img_masks)
        im = self.img_layer_norm(self.img_linear(img_feat.float()),
                                 torch.float32)
        pos = self.pos_layer_norm(self.pos_linear(img_pos_feat.float()),
                                  torch.float32)
        x = self.LayerNorm(im + pos + type_embeddings,
                           compute_dtype(self.config))
        return bernoulli_dropout(x, self.config.hidden_dropout_prob, generator)


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


def _attention(cfg: UniterConfig, q, k, v, bias32, scale, dtype, attn_rate,
               generator: Generators, folds: int = 1,
               heads: Optional[Tuple[int, int]] = None):
    """The encoder's attention core on ``[folds·B, H, S, D]`` heads (the
    JAX encoder's three branches, models/uniter.py:317-356 there). With one
    generator per fold, each fold's dropout (the kernel's seeds, or the
    plain branch's threshold masks) comes from its own generator; a rank's
    rows (:class:`ShardedGenerators`) and heads ``heads = (head0, total)``
    draw the whole run's dropout and take their slice."""
    bits8 = cfg.dropout_bits_dtype == "uint8"
    if cfg.use_pallas_attention:
        b = q.shape[0] // folds
        row0, rows = (getattr(generator, "row0", 0),
                      getattr(generator, "rows", b))
        head0, n_heads = heads or (0, q.shape[1])
        shard = (SeedShard(row0, rows, head0, n_heads)
                 if (rows, n_heads) != (b, q.shape[1]) else None)
        if cfg.pallas_blocked:
            kernel = fused_attention_blocked
            n_seed = blocked_seed_count(rows, n_heads)
        else:
            kernel, n_seed = fused_attention, rows
        seeds = None
        if attn_rate > 0.0:
            def draw(shape, g):
                return torch.randint(0, 2 ** 31 - 1, shape, generator=g,
                                      device=q.device, dtype=torch.int32)

            seeds = (draw((folds * n_seed,), generator)
                     if isinstance(generator, torch.Generator)
                     else torch.stack([draw((n_seed,), g)
                                       for g in generator]).reshape(-1))
        return kernel(q.contiguous(), k.contiguous(), v.contiguous(),
                      bias32, scale, attn_rate, seeds, folds=folds,
                      shard=shard).to(dtype)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if cfg.attention_score_dtype == "bfloat16":
        # bf16 S^2 storage, softmax math in fp32 (softmax_lowp)
        probs = softmax_lowp((scores + bias32).to(torch.bfloat16))
    else:
        probs = torch.softmax(scores + bias32, dim=-1)
    probs = probs.to(dtype)
    if not isinstance(generator, torch.Generator) and generator is not None:
        # per-fold masks: the fold axis leads
        probs = threshold_dropout(
            probs.reshape((folds, -1) + probs.shape[1:]), attn_rate,
            generator, bits8, heads).reshape(probs.shape)
    else:
        probs = threshold_dropout(probs, attn_rate, generator, bits8)
    return torch.matmul(probs.float(), v.float()).to(dtype)


def _generator_list(generator: Generators) -> List[torch.Generator]:
    if generator is None:
        return []
    if isinstance(generator, torch.Generator):
        return [generator]
    return list(generator)


def _remat(config: UniterConfig, layer_fn, x: torch.Tensor,
           generator: Generators) -> torch.Tensor:
    """``layer_fn(x)`` under ``torch.utils.checkpoint``: its activations
    are recomputed in the backward (``remat_policy`` "full"), or all but the
    matrix products' outputs ("dots", the JAX ``checkpoint_dots``).

    The recompute replays the layer's dropout: each generator's state
    before the layer (every fold's, for a FoldStack) is kept and set again
    for the recompute, so the threshold masks and the fused kernel's seeds
    come out the same; the states the recompute found are put back after
    it, for whatever draws from the generators next."""
    gens = _generator_list(generator)
    states = [g.get_state() for g in gens]
    calls = [0]

    def run(x):
        calls[0] += 1
        if calls[0] == 1 or not gens:
            return layer_fn(x)
        after = [g.get_state() for g in gens]
        for g, st in zip(gens, states):
            g.set_state(st)
        try:
            return layer_fn(x)
        finally:
            for g, st in zip(gens, after):
                g.set_state(st)

    kw = {}
    if config.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False,
                      **kw)


class StackedEncoder(nn.Module):
    """L post-LN BERT layers (reference UniterEncoder, model/layer.py)."""

    def __init__(self, config: UniterConfig):
        super().__init__()
        self.config = config
        self.layer = nn.ModuleList(
            [BertLayer(config) for _ in range(config.num_hidden_layers)])

    def _layer(self, lp: BertLayer, x: torch.Tensor, bias32: torch.Tensor,
               attn_rate: float, gen: Optional[torch.Generator]
               ) -> torch.Tensor:
        cfg = self.config
        p_hid = cfg.hidden_dropout_prob
        bits8 = cfg.dropout_bits_dtype == "uint8"
        dtype = compute_dtype(cfg)
        scale = 1.0 / math.sqrt(cfg.head_dim)
        act = ACT2FN[cfg.hidden_act]
        sa = lp.attention.self
        q, k, v = (_split_heads(_linear(x, lin, dtype),
                                cfg.num_attention_heads)
                   for lin in (sa.query, sa.key, sa.value))
        ctx = _merge_heads(_attention(cfg, q, k, v, bias32, scale, dtype,
                                      attn_rate, gen))
        ao = lp.attention.output
        attn_out = threshold_dropout(_linear(ctx, ao.dense, dtype), p_hid,
                                     gen, bits8)
        x = ao.LayerNorm(attn_out + x, dtype)
        inter = act(_linear(x, lp.intermediate.dense, dtype))
        fo = lp.output
        ffn_out = threshold_dropout(_linear(inter, fo.dense, dtype), p_hid,
                                    gen, bits8)
        return fo.LayerNorm(ffn_out + x, dtype)

    def _remat_layer(self, lp: BertLayer, x: torch.Tensor,
                     bias32: torch.Tensor, attn_rate: float,
                     gen: Optional[torch.Generator]) -> torch.Tensor:
        """The layer under ``torch.utils.checkpoint`` (:func:`_remat`)."""
        return _remat(self.config, lambda x: self._layer(
            lp, x, bias32, attn_rate, gen), x, gen)

    def forward(self, hidden: torch.Tensor, attn_bias: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.config
        p_attn = cfg.attention_probs_dropout_prob
        p_hid = cfg.hidden_dropout_prob
        use_dropout = (not deterministic) and (p_attn > 0 or p_hid > 0)
        if use_dropout and generator is None:
            raise ValueError("dropout (deterministic=False) draws from a "
                             "torch.Generator; pass generator=")
        gen = generator if use_dropout else None
        attn_rate = p_attn if use_dropout else 0.0
        # remat only matters where autograd records the forward
        layer = (self._remat_layer if cfg.remat and torch.is_grad_enabled()
                 else self._layer)
        bias32 = attn_bias.float()
        x = hidden.to(compute_dtype(cfg))
        for lp in self.layer:
            x = layer(lp, x, bias32, attn_rate, gen)
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
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        gen = None if deterministic else generator
        if input_ids is None:
            # image-only branch (model/model.py:348-351)
            if img_type_ids is None:
                img_type_ids = torch.ones(img_feat.shape[:2], dtype=torch.long,
                                          device=img_feat.device)
            emb = self.img_embeddings(img_feat, img_pos_feat,
                                      self.embeddings.type_embed(img_type_ids),
                                      img_masks, gen)
            joint_mask = img_mask
        elif img_feat is None:
            # text-only branch (model/model.py:352-355)
            emb = self.embeddings(input_ids, position_ids, txt_type_ids, gen)
            joint_mask = txt_mask
        else:
            txt_emb = self.embeddings(input_ids, position_ids, txt_type_ids,
                                      gen)
            if img_type_ids is None:
                img_type_ids = torch.ones(img_feat.shape[:2], dtype=torch.long,
                                          device=img_feat.device)
            img_emb = self.img_embeddings(
                img_feat, img_pos_feat,
                self.embeddings.type_embed(img_type_ids), img_masks, gen)
            emb = torch.cat([txt_emb.to(img_emb.dtype), img_emb], dim=1)
            joint_mask = torch.cat([txt_mask, img_mask], dim=1)
        seq = self.encoder(emb, self._attn_bias(joint_mask),
                           deterministic=deterministic, generator=gen)
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
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits ``[B, n_classes]``; ``deterministic=False`` trains with
        dropout drawn from ``generator``."""
        seq, _ = self.uniter_model(
            input_ids=batch.get("input_ids"),
            position_ids=batch.get("position_ids"),
            img_feat=batch.get("img_feat"),
            img_pos_feat=batch.get("img_pos_feat"),
            txt_mask=batch.get("txt_mask"),
            img_mask=batch.get("img_mask"),
            deterministic=deterministic,
            generator=generator,
        )
        return self.linear(self.uniter_model.pool(seq))


def _head_mlp(net: nn.ModuleDict, hidden: torch.Tensor) -> torch.Tensor:
    """``net["0"]`` → erf-GELU → ``net["2"]`` (fp32 LayerNorm), on the
    hidden states in fp32: the shared front of the MRFR and MRC heads
    (reference ``nn.Sequential(Linear, GELU, LayerNorm)``)."""
    h = erf_gelu(net["0"](hidden.float()))
    return net["2"](h, torch.float32)


class RegionFeatureRegression(nn.Module):
    """MRFR head: Linear→GELU→LN, decoded with the *shared* ``img_linear``
    weight of the image embeddings (reference model/pretrain.py:19-33;
    JAX models/uniter.py:527-548). Keys ``net.0``, ``net.2``, ``bias``."""

    def __init__(self, config: UniterConfig):
        super().__init__()
        H = config.hidden_size
        self.net = nn.ModuleDict({"0": nn.Linear(H, H),
                                  "2": LayerNorm(H, config.layer_norm_eps)})
        self.bias = nn.Parameter(torch.zeros(config.img_dim))

    def forward(self, hidden: torch.Tensor,
                img_linear_weight: torch.Tensor) -> torch.Tensor:
        # img_linear.weight is [H, img_dim]: H → img_dim is h @ W (the
        # reference's F.linear(h, W.t(), bias)); its gradient reaches the
        # image embeddings' parameter
        return torch.matmul(_head_mlp(self.net, hidden),
                            img_linear_weight) + self.bias


class RegionClassification(nn.Module):
    """MRC head: Linear→GELU→LN→Linear(label_dim) (reference
    model/pretrain.py:36-47). Keys ``net.0``, ``net.2``, ``net.3``."""

    def __init__(self, config: UniterConfig, label_dim: int):
        super().__init__()
        H = config.hidden_size
        self.net = nn.ModuleDict({"0": nn.Linear(H, H),
                                  "2": LayerNorm(H, config.layer_norm_eps),
                                  "3": nn.Linear(H, label_dim)})

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.net["3"](_head_mlp(self.net, hidden))


class _MLMPredictions(nn.Module):
    def __init__(self, config: UniterConfig):
        super().__init__()
        self.transform = _DenseLN(config.hidden_size, config.hidden_size,
                                  config.layer_norm_eps)
        self.bias = nn.Parameter(torch.zeros(config.vocab_size))


class MLMHead(nn.Module):
    """Linear→act→LN → decode with the *word embedding table* + bias
    (reference BertOnlyMLMHead, model/layer.py:205-222). Keys
    ``predictions.transform.{dense,LayerNorm}``, ``predictions.bias``."""

    def __init__(self, config: UniterConfig):
        super().__init__()
        self.act = ACT2FN[config.hidden_act]
        self.predictions = _MLMPredictions(config)

    def forward(self, hidden: torch.Tensor,
                word_embedding: torch.Tensor) -> torch.Tensor:
        p = self.predictions
        h = self.act(p.transform.dense(hidden.float()))
        h = p.transform.LayerNorm(h, torch.float32)
        return F.linear(h, word_embedding) + p.bias


class UniterForPretraining(nn.Module):
    """The four pretraining heads over a shared UNITER trunk.

    Counterpart of JAX ``UniterForPretraining`` (models/uniter.py:594-716;
    reference model/pretrain.py:50-233) with the MLM, MRFR, ITM and MRC(-kl)
    tasks, under the reference's torch keys: the trunk under ``uniter.``,
    ``cls.predictions.*``, ``feat_regress.*``, ``region_classifier.*`` and
    ``itm_output``. The MLM decoder is the word embedding table and the MRFR
    decoder the image embeddings' ``img_linear`` weight (tied: no key of
    their own). Each task returns per-position (loss, mask) pairs computed
    densely over the static sequence; the driver reduces them. The heads
    compute in fp32 whatever the compute dtype."""

    def __init__(self, config: UniterConfig, img_label_dim: int = 1601):
        super().__init__()
        self.config = config
        self.img_label_dim = img_label_dim
        self.uniter = UniterModel(config)
        self.cls = MLMHead(config)
        self.feat_regress = RegionFeatureRegression(config)
        self.region_classifier = RegionClassification(config, img_label_dim)
        self.itm_output = nn.Linear(config.hidden_size, 2)

    def _encode(self, batch: Dict[str, torch.Tensor], img_masks=None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        seq, _ = self.uniter(
            input_ids=batch["input_ids"],
            position_ids=batch["position_ids"],
            img_feat=batch["img_feat"],
            img_pos_feat=batch["img_pos_feat"],
            txt_mask=batch["txt_mask"],
            img_mask=batch["img_mask"],
            img_masks=img_masks,
            deterministic=deterministic,
            generator=generator,
        )
        return seq

    def forward(self, batch: Dict[str, torch.Tensor], task: str,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """Dispatch on ``task`` (reference pretrain.py:65-105)."""
        if task == "mlm":
            return self.forward_mlm(batch, deterministic, generator)
        if task == "mrfr":
            return self.forward_mrfr(batch, deterministic, generator)
        if task == "itm":
            return self.forward_itm(batch, deterministic, generator)
        if task.startswith("mrc"):
            return self.forward_mrc(batch, task, deterministic, generator)
        raise ValueError("invalid task %r" % task)

    def forward_mlm(self, batch, deterministic=True, generator=None):
        """Per-token CE over masked text positions (``txt_labels`` −1 is
        unmasked) and the mask (reference pretrain.py:107-127)."""
        seq = self._encode(batch, deterministic=deterministic,
                           generator=generator)
        T = batch["input_ids"].shape[1]
        logits = self.cls(seq[:, :T],
                          self.uniter.embeddings.word_embeddings.weight)
        labels = batch["txt_labels"].long()
        mask = labels != -1
        safe = torch.where(mask, labels, 0)
        logp = torch.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
        return nll * mask, mask

    def forward_mrfr(self, batch, deterministic=True, generator=None):
        """Per-region masked squared error (reference pretrain.py:135-154)."""
        seq = self._encode(batch, img_masks=batch["img_masks"],
                           deterministic=deterministic, generator=generator)
        T = batch["input_ids"].shape[1]
        pred = self.feat_regress(
            seq[:, T:], self.uniter.img_embeddings.img_linear.weight)
        mask = batch["img_masks"].float()
        err = torch.square(pred - batch["feat_targets"].float())
        return err * mask[..., None], batch["img_masks"]

    def forward_itm(self, batch, deterministic=True, generator=None):
        """ITM scores [B, 2] (reference pretrain.py:156-203)."""
        return self.forward_itm_with_seq(batch, deterministic, generator)[0]

    def forward_itm_with_seq(self, batch, deterministic=True,
                             generator=None):
        """ITM scores and the sequence output of the same encoder pass, for
        the IPOT alignment term."""
        seq = self._encode(batch, deterministic=deterministic,
                           generator=generator)
        return self.itm_output(self.uniter.pool(seq)), seq

    def forward_mrc(self, batch, task, deterministic=True, generator=None):
        """Per-region CE (``mrc``) or KL (``mrc-kl``) to the ``label_dim``
        label targets (reference pretrain.py:205-233)."""
        seq = self._encode(batch, img_masks=batch["img_masks"],
                           deterministic=deterministic, generator=generator)
        T = batch["input_ids"].shape[1]
        logits = self.region_classifier(seq[:, T:]).float()
        mask = batch["img_masks"].float()
        label_targets = batch["label_targets"].float()
        logp = torch.log_softmax(logits, dim=-1)
        if "kl" in task:
            kl = torch.where(
                label_targets > 0,
                label_targets * (torch.log(torch.clamp_min(label_targets,
                                                           1e-12)) - logp),
                0.0)
            return kl * mask[..., None], batch["img_masks"]
        # the background class is never the target (reference
        # pretrain.py:228-230); argmax takes the first of equal maxima, as
        # jnp.argmax does, so an all-zero padding row picks class 1 (masked)
        hard = torch.argmax(label_targets[..., 1:], dim=-1) + 1
        nll = -torch.gather(logp, -1, hard[..., None])[..., 0]
        return nll * mask, batch["img_masks"]


def init_weights(module: nn.Module, generator: torch.Generator,
                 initializer_range: float) -> None:
    """The JAX package's initializers: normal(initializer_range) for every
    matrix and embedding table, zeros for biases, ones for LayerNorm scales.
    Draws from ``generator``, on the parameters' device."""
    ln_scales = {id(m.weight) for m in module.modules()
                 if isinstance(m, LayerNorm)}
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif id(p) in ln_scales:
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


@dataclass(frozen=True)
class ModelSplit:
    """A rank's part of a ``model`` mesh axis of ``size`` ranks: its
    ``rank`` on the axis, the axis's process ``group``, and the dim each
    split parameter of the fold-stacked state is cut along (``dims``: 1 the
    output features of an ``[F, out, in]`` weight, its bias, or the vocab
    rows of ``word_embeddings``; 2 the input features of a row-split
    weight). Parameters it does not name are whole on every rank."""
    group: object
    rank: int
    size: int
    dims: Dict[str, int]


class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over the group
    (the input of a column-split product, Megatron's f)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromGroup(torch.autograd.Function):
    """The sum over the group forward (a row-split product's partial
    outputs, Megatron's g); identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    """The ranks' slices of the last dim, concatenated in rank order;
    the backward keeps this rank's slice of the gradient."""

    @staticmethod
    def forward(ctx, x, group, rank):
        ctx.rank, ctx.width = rank, x.shape[-1]
        parts = [torch.empty_like(x)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        w = ctx.width
        return g[..., ctx.rank * w:(ctx.rank + 1) * w], None, None


def _fold_view(t: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-fold ``[F, H]`` vector as ``[F, 1, ..., H]``, broadcasting
    against a fold-stacked tensor of ``ndim`` dimensions."""
    return t.reshape(t.shape[:1] + (1,) * (ndim - 2) + t.shape[1:])


class FoldStack:
    """F MemeUniters of one configuration, run as one model.

    ``params`` maps every name of ``MemeUniter.state_dict()`` to a leaf
    tensor ``[F, ...]`` (fold f's weight at index f), with ``requires_grad``
    set; :meth:`forward` takes fold-stacked batches ``[F, B, ...]`` and
    returns logits ``[F, B, n_classes]``. Each layer runs once for all F
    folds: the products are ``bmm`` over F (bias added after the product,
    each rounded to the compute dtype, as the encoder's ``_linear``; the
    ``nn.Linear`` layers as ``baddbmm``), attention takes the F·B samples in
    one kernel launch (``folds=F``), so a forward's launches do not grow
    with F except for the per-fold dropout draws.

    ``split``: the rank's part of a ``model`` mesh axis (:class:`ModelSplit`;
    ``params`` then hold its slices of the split leaves).
    """

    def __init__(self, config: UniterConfig, n_classes: int,
                 params: Dict[str, torch.Tensor],
                 split: Optional[ModelSplit] = None):
        self.config, self.n_classes = config, n_classes
        self.params = params
        self.split = split
        self.folds = int(next(iter(params.values())).shape[0])
        for p in params.values():
            if p.shape[0] != self.folds:
                raise ValueError("parameters of %d and %d folds"
                                 % (self.folds, p.shape[0]))
            p.requires_grad_(True)

    @classmethod
    def from_models(cls, models: Iterable[nn.Module], folds: int
                    ) -> "FoldStack":
        """Stack ``folds`` MemeUniters, taken one at a time from ``models``
        (each copied into the stack as it comes, so a generator of models
        never holds more than one besides the stack)."""
        params, config, n_classes, n = None, None, None, 0
        for f, model in enumerate(models):
            sd = model.state_dict()
            if params is None:
                config, n_classes = model.config, model.n_classes
                params = {k: torch.empty((folds,) + tuple(v.shape),
                                         dtype=v.dtype, device=v.device)
                          for k, v in sd.items()}
            with torch.no_grad():
                for k, v in sd.items():
                    params[k][f].copy_(v)
            n = f + 1
            del model, sd
        if n != folds:
            raise ValueError("%d models for %d folds" % (n, folds))
        return cls(config, n_classes, params)

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    def fold_state_dict(self, fold: int, params=None
                        ) -> Dict[str, torch.Tensor]:
        """Fold ``fold``'s MemeUniter ``state_dict`` (views into
        ``params``, default the live parameters)."""
        params = self.params if params is None else params
        return {k: v[fold].detach() for k, v in params.items()}

    # ------------------------------------------------------------ the layers

    def _split_dim(self, name: str) -> Optional[int]:
        return None if self.split is None else self.split.dims.get(name)

    def _lin(self, x: torch.Tensor, name: str,
             dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """``x [F, ..., in]`` through fold f's linear layer ``name``: with
        ``dtype`` the encoder's ``_linear`` (product, then bias, each
        rounded to ``dtype``), else ``nn.Linear`` (bias in the product).
        A column-split layer gives this rank's output features; a row-split
        one takes its input features and sums the partial products over the
        model group before the bias."""
        w, b = self.params[name + ".weight"], self.params[name + ".bias"]
        split = self._split_dim(name + ".weight")
        if split == 1:
            x = _CopyToGroup.apply(x, self.split.group)
        x2 = x.reshape(x.shape[0], -1, x.shape[-1])
        if split == 2:
            y = torch.bmm(x2, (w if dtype is None else w.to(dtype))
                          .transpose(1, 2))
            y = _ReduceFromGroup.apply(y, self.split.group)
            y = y + (b if dtype is None else b.to(dtype)).unsqueeze(1)
        elif dtype is None:
            y = torch.baddbmm(b.unsqueeze(1), x2, w.transpose(1, 2))
        else:
            y = (torch.bmm(x2, w.to(dtype).transpose(1, 2))
                 + b.to(dtype).unsqueeze(1))
        return y.reshape(x.shape[:-1] + (w.shape[1],))

    def _ln(self, x: torch.Tensor, name: str,
            out_dtype: torch.dtype) -> torch.Tensor:
        return _layer_norm(x, _fold_view(self.params[name + ".weight"],
                                         x.dim()),
                           _fold_view(self.params[name + ".bias"], x.dim()),
                           self.config.layer_norm_eps, out_dtype)

    def _embed(self, name: str, ids: torch.Tensor) -> torch.Tensor:
        """Fold f's rows of table ``name`` ``[F, V, H]`` for ``ids``
        ``[F, ...]``: one lookup in the flattened ``[F·V, H]`` table. A
        vocab-split table holds rows ``[rank·V, (rank + 1)·V)``: ids
        outside them look up zeros, and the sum over the model group gives
        every row.

        The lookup is an index (``table[ids]``), not ``F.embedding``: on a
        card, the embedding backward of more than 3 072 ids (F·B·S of a
        fold-stacked batch) accumulates with atomics, in an order that
        changes from run to run; the index's backward sorts the ids and
        sums each row in a fixed order."""
        table = self.params[name + ".weight"]
        F_, V = table.shape[:2]
        ids = ids.long()
        split = self._split_dim(name + ".weight")
        if split == 1:
            ids = ids - self.split.rank * V
            inside = (ids >= 0) & (ids < V)
            ids = torch.where(inside, ids, 0)
        offset = (torch.arange(F_, device=ids.device) * V).reshape(
            (F_,) + (1,) * (ids.dim() - 1))
        out = table.reshape(F_ * V, -1)[ids + offset]
        if split == 1:
            out = torch.where(inside[..., None], out, out.new_zeros(()))
            out = _ReduceFromGroup.apply(out, self.split.group)
        return out

    def _text(self, input_ids, position_ids, gen) -> torch.Tensor:
        p = "uniter_model.embeddings."
        x = (self._embed(p + "word_embeddings", input_ids)
             + self._embed(p + "position_embeddings", position_ids)
             + self._embed(p + "token_type_embeddings",
                           torch.zeros_like(input_ids)))
        x = self._ln(x, p + "LayerNorm", compute_dtype(self.config))
        return bernoulli_dropout(x, self.config.hidden_dropout_prob, gen)

    def _image(self, img_feat, img_pos_feat, gen) -> torch.Tensor:
        p = "uniter_model.img_embeddings."
        type_emb = self._embed(
            "uniter_model.embeddings.token_type_embeddings",
            torch.ones(img_feat.shape[:3], dtype=torch.long,
                       device=img_feat.device))
        name = p + "img_linear"
        if self._split_dim(name + ".weight") == 1:
            # the weight's output features split, its bias whole (JAX
            # splits img_linear_kernel alone): the rank's features of the
            # product, gathered, then the bias
            w, b = self.params[name + ".weight"], self.params[name + ".bias"]
            x = img_feat.float()
            im = torch.bmm(x.reshape(x.shape[0], -1, x.shape[-1]),
                           w.transpose(1, 2))
            im = (_GatherFromGroup.apply(im, self.split.group,
                                         self.split.rank)
                  + b.unsqueeze(1)).reshape(x.shape[:-1] + (b.shape[1],))
        else:
            im = self._lin(img_feat.float(), name)
        im = self._ln(im, p + "img_layer_norm", torch.float32)
        pos = self._ln(self._lin(img_pos_feat.float(), p + "pos_linear"),
                       p + "pos_layer_norm", torch.float32)
        x = self._ln(im + pos + type_emb, p + "LayerNorm",
                     compute_dtype(self.config))
        return bernoulli_dropout(x, self.config.hidden_dropout_prob, gen)

    def _layer(self, i: int, x: torch.Tensor, bias32: torch.Tensor,
               attn_rate: float, gen: Generators) -> torch.Tensor:
        cfg = self.config
        p = "uniter_model.encoder.layer.%d." % i
        p_hid = cfg.hidden_dropout_prob
        bits8 = cfg.dropout_bits_dtype == "uint8"
        dtype = compute_dtype(cfg)
        F_, B, S, _ = x.shape
        # a model split holds heads [head0, head0 + n_heads) of the layer's
        q, k, v = (self._lin(x, p + "attention.self." + n, dtype)
                   for n in ("query", "key", "value"))
        width = q.shape[-1]
        n_heads = width // cfg.head_dim
        heads = None
        if n_heads != cfg.num_attention_heads:
            heads = (self.split.rank * n_heads, cfg.num_attention_heads)
        q, k, v = (_split_heads(t.reshape(F_ * B, S, width), n_heads)
                   for t in (q, k, v))
        ctx = _merge_heads(_attention(
            cfg, q, k, v, bias32, 1.0 / math.sqrt(cfg.head_dim), dtype,
            attn_rate, gen, folds=F_, heads=heads)).reshape(F_, B, S, width)
        attn_out = threshold_dropout(
            self._lin(ctx, p + "attention.output.dense", dtype), p_hid, gen,
            bits8)
        x = self._ln(attn_out + x, p + "attention.output.LayerNorm", dtype)
        inter = ACT2FN[cfg.hidden_act](
            self._lin(x, p + "intermediate.dense", dtype))
        ffn_out = threshold_dropout(self._lin(inter, p + "output.dense",
                                              dtype), p_hid, gen, bits8)
        return self._ln(ffn_out + x, p + "output.LayerNorm", dtype)

    # -------------------------------------------------------------- forward

    def forward(self, batch: Dict[str, torch.Tensor],
                deterministic: bool = True,
                generators: Optional[Sequence[torch.Generator]] = None
                ) -> torch.Tensor:
        """Logits ``[F, B, n_classes]`` of fold-stacked inputs ``[F, B,
        ...]`` (MemeUniter's keys); ``deterministic=False`` trains with
        dropout, fold f drawing from ``generators[f]``."""
        cfg = self.config
        use_dropout = (not deterministic) and (
            cfg.attention_probs_dropout_prob > 0
            or cfg.hidden_dropout_prob > 0)
        if use_dropout and generators is None:
            raise ValueError("dropout (deterministic=False) draws from one "
                             "torch.Generator a fold; pass generators=")
        gen = None
        if use_dropout:  # a ShardedGenerators keeps its rows
            gen = (generators if isinstance(generators, list)
                   else list(generators))
        attn_rate = cfg.attention_probs_dropout_prob if use_dropout else 0.0
        input_ids, img_feat = batch.get("input_ids"), batch.get("img_feat")
        if input_ids is None:
            emb = self._image(img_feat, batch["img_pos_feat"], gen)
            mask = batch["img_mask"]
        elif img_feat is None:
            emb = self._text(input_ids, batch["position_ids"], gen)
            mask = batch["txt_mask"]
        else:
            txt = self._text(input_ids, batch["position_ids"], gen)
            img = self._image(img_feat, batch["img_pos_feat"], gen)
            emb = torch.cat([txt.to(img.dtype), img], dim=2)
            mask = torch.cat([batch["txt_mask"], batch["img_mask"]], dim=2)
        F_, B, S = mask.shape
        bias32 = ((1.0 - mask.float()) * NEG_INF).reshape(F_ * B, 1, 1, S)
        x = emb.to(compute_dtype(cfg))
        remat = cfg.remat and torch.is_grad_enabled()
        for i in range(cfg.num_hidden_layers):
            if remat:
                x = _remat(cfg, functools.partial(
                    self._layer, i, bias32=bias32, attn_rate=attn_rate,
                    gen=gen), x, gen)
            else:
                x = self._layer(i, x, bias32, attn_rate, gen)
        pooled = torch.tanh(self._lin(x[:, :, 0].float(),
                                      "uniter_model.pooler.dense"))
        return self._lin(pooled, "linear")

    __call__ = forward
