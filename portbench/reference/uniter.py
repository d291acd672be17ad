"""Plain UNITER for hateful memes in float32, the benchmark's reference.

Written from the UNITER paper (arXiv:1909.11740) and the reference
repository's ``model/`` (``UniterTextEmbeddings``, ``UniterImageEmbeddings``,
post-LN BERT layers with erf-GELU, ``BertPooler``, the meme head
``Linear(hidden, 1)``), as functions of a dict of parameters under the
reference's torch key names. It imports nothing of the program and has no
kernels, cache or batching tricks. Departures from the paper's code, each
one the recipe's:

- The sequence is the static ``[max_txt_len text | max_bb regions]``
  layout with padding masked by an additive −10000 on the keys, not the
  compacted one; the masked keys' weights underflow to 0, so the
  attention is the same.
- Dropout, where :class:`DropoutDraws` is given, uses the masks of the
  recipe's step: drawn from the step's ``torch.Generator`` in the order
  and at the shapes the recipe draws them, and the attention masks from the
  counter hash of the per-sample or per-block seeds (``hash_bits``).
- The optimizer (:func:`adam_step`) is the recipe's: global-norm clip, L2
  decay into the gradient except biases and LayerNorm scales, Adam with its
  moments stored in the configuration's dtype, warmup-cosine learning rate
  evaluated at the count before the update.

``precision("tf32")`` runs every product with TF32 allowed, and
``precision("fp8")`` rounds both operands of every product to float8 e4m3
(a scale a tensor, the gradient passed straight through): the controls
that must read as not correct below float32 and bfloat16
(``portbench/calibrate.py``).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

NEG = -10000.0
_MASK32 = 0xFFFFFFFF
_NO_DECAY = ("bias", "LayerNorm.weight", "img_layer_norm.weight",
             "pos_layer_norm.weight")
_FP8_MAX = 448.0
_fp8 = [False]  # set by precision("fp8")


# ---------------------------------------------------------------- parameters

def param_spec(cfg: dict) -> List[tuple]:
    """(name, shape, init) of every parameter of the meme model, init one
    of ``normal`` (std ``initializer_range``), ``zeros``, ``ones``."""
    H, inner = cfg["hidden_size"], cfg["intermediate_size"]
    spec = []

    def lin(name, d_out, d_in):
        spec.extend([(name + ".weight", (d_out, d_in), "normal"),
                     (name + ".bias", (d_out,), "zeros")])

    def ln(name):
        spec.extend([(name + ".weight", (H,), "ones"),
                     (name + ".bias", (H,), "zeros")])

    e, i = "uniter_model.embeddings.", "uniter_model.img_embeddings."
    spec += [(e + "word_embeddings.weight", (cfg["vocab_size"], H), "normal"),
             (e + "position_embeddings.weight",
              (cfg["max_position_embeddings"], H), "normal"),
             (e + "token_type_embeddings.weight", (cfg["type_vocab_size"], H),
              "normal")]
    ln(e + "LayerNorm")
    lin(i + "img_linear", H, cfg["img_dim"])
    ln(i + "img_layer_norm")
    lin(i + "pos_linear", H, cfg["pos_dim"])
    ln(i + "pos_layer_norm")
    spec.append((i + "mask_embedding.weight", (2, cfg["img_dim"]), "normal"))
    ln(i + "LayerNorm")
    for layer in range(cfg["num_hidden_layers"]):
        p = "uniter_model.encoder.layer.%d." % layer
        for k in ("query", "key", "value"):
            lin(p + "attention.self." + k, H, H)
        lin(p + "attention.output.dense", H, H)
        ln(p + "attention.output.LayerNorm")
        lin(p + "intermediate.dense", inner, H)
        lin(p + "output.dense", H, inner)
        ln(p + "output.LayerNorm")
    lin("uniter_model.pooler.dense", H, H)
    lin("linear", cfg.get("n_classes", 1), H)
    return spec


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of ``seed``: one normal draw for every matrix and table
    together from a generator on ``device``, sliced in ``param_spec``
    order; zeros and ones for the rest. The same seed gives the same
    weights."""
    spec = param_spec(cfg)
    n = sum(math.prod(s) for _, s, k in spec if k == "normal")
    g = torch.Generator(device=torch.device(device)).manual_seed(int(seed))
    flat = torch.empty(n, device=device).normal_(
        0.0, cfg["initializer_range"], generator=g)
    out, off = {}, 0
    for name, shape, kind in spec:
        if kind == "normal":
            size = math.prod(shape)
            out[name] = flat[off:off + size].view(shape)
            off += size
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.ones(shape, device=device)
    return out


def decays(name: str) -> bool:
    return not name.endswith(_NO_DECAY)


# ------------------------------------------------------ the recipe's dropout

def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    a_lo, a_hi = a & 0xFFFF, a >> 16
    b_lo, b_hi = b & 0xFFFF, b >> 16
    mid = (a_hi * b_lo + a_lo * b_hi) & 0xFFFF
    return (a_lo * b_lo + (mid << 16)) & _MASK32


def hash_bits(index: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """The attention dropout's counter hash: the murmur3 finalizer of
    ``index xor seed·2654435761`` in uint32 arithmetic (held in int64)."""
    x = (index & _MASK32) ^ _mul32(seed.to(torch.int64) & _MASK32,
                                   2654435761)
    x = _mul32(x ^ (x >> 16), 0x85EBCA6B)
    x = _mul32(x ^ (x >> 13), 0xC2B2AE35)
    return x ^ (x >> 16)


def largest_block(g: int, cap: int = 24) -> int:
    for b in range(min(cap, g), 0, -1):
        if g % b == 0:
            return b
    return 1


class DropoutDraws:
    """The masks of one optimizer step of the recipe, drawn from its
    generator in the recipe's order: per forward the text embeddings'
    and the image embeddings' uniform draws, then per layer the attention's
    int32 seeds (one a sample, or one a block of ``largest_block(B·H)``
    (sample, head) pairs with ``blocked``), the attention output's and the
    feed-forward output's integer words (uint32, or uint8 with ``bits8``)."""

    def __init__(self, generator: torch.Generator, hidden_rate: float,
                 attn_rate: float, bits8: bool, blocked: bool):
        self.g, self.hidden_rate, self.attn_rate = (generator, hidden_rate,
                                                    attn_rate)
        self.bits8, self.blocked = bits8, blocked

    def embedding(self, x: torch.Tensor) -> torch.Tensor:
        keep = torch.rand(tuple(x.shape), generator=self.g,
                          device=x.device) < 1.0 - self.hidden_rate
        return torch.where(keep, x / (1.0 - self.hidden_rate),
                           x.new_zeros(()))

    def hidden(self, x: torch.Tensor) -> torch.Tensor:
        rate = self.hidden_rate
        if self.bits8:
            k = min(int(round(rate * 256)), 255)
            bits = torch.randint(0, 256, tuple(x.shape), generator=self.g,
                                 device=x.device, dtype=torch.uint8)
            eff = k / 256.0
        else:
            k = min(int(rate * (1 << 32)), (1 << 32) - 1)
            bits = torch.randint(0, 1 << 32, tuple(x.shape), generator=self.g,
                                 device=x.device, dtype=torch.int64)
            eff = rate
        return torch.where(bits >= k, x / (1.0 - eff), x.new_zeros(()))

    def attention(self, p: torch.Tensor) -> torch.Tensor:
        """Dropout on the probabilities ``[B, H, S, S]``."""
        B, H, S, _ = p.shape
        group = largest_block(B * H) if self.blocked else H
        seeds = torch.randint(0, 2 ** 31 - 1, (B * H // group,),
                              generator=self.g, device=p.device,
                              dtype=torch.int32)
        pair = torch.arange(B * H, dtype=torch.int64, device=p.device)
        ij = torch.arange(S * S, dtype=torch.int64, device=p.device)
        index = ((pair % group) * (S * S))[:, None] + ij[None, :]
        bits = hash_bits(index, seeds.to(torch.int64)[pair // group][:, None])
        keep = (bits >= min(int(self.attn_rate * (1 << 32)), _MASK32)
                ).reshape(B, H, S, S)
        scale = float(np.float32(1.0 / (1.0 - self.attn_rate)))
        return torch.where(keep, p * scale, p.new_zeros(()))


# ------------------------------------------------------------------- forward

def _ln(x, w, name, eps):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * w[name + ".weight"] \
        + w[name + ".bias"]


def _fp8_round(x):
    scale = x.detach().abs().amax().clamp_min(1e-30) / _FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


def _mm(a, b):
    if _fp8[0]:
        a, b = _fp8_round(a), _fp8_round(b)
    return a @ b


def _lin(x, w, name):
    return _mm(x, w[name + ".weight"].t()) + w[name + ".bias"]


def _gelu(x):
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def logits(w: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
           cfg: dict, drop: Optional[DropoutDraws] = None) -> torch.Tensor:
    """The meme logits ``[B, n_classes]`` of ``batch`` (``input_ids``,
    ``position_ids``, ``txt_mask`` ``[B, T]``, ``img_feat`` ``[B, R, 2048]``,
    ``img_pos_feat`` ``[B, R, 7]``, ``img_mask`` ``[B, R]``)."""
    eps = cfg["layer_norm_eps"]
    nh, H = cfg["num_attention_heads"], cfg["hidden_size"]
    d = H // nh
    e, im = "uniter_model.embeddings.", "uniter_model.img_embeddings."
    types = w[e + "token_type_embeddings.weight"]
    txt = (w[e + "word_embeddings.weight"][batch["input_ids"].long()]
           + w[e + "position_embeddings.weight"][batch["position_ids"].long()]
           + types[0])
    txt = _ln(txt, w, e + "LayerNorm", eps)
    if drop is not None:
        txt = drop.embedding(txt)
    img = (_ln(_lin(batch["img_feat"].float(), w, im + "img_linear"), w,
               im + "img_layer_norm", eps)
           + _ln(_lin(batch["img_pos_feat"].float(), w, im + "pos_linear"), w,
                 im + "pos_layer_norm", eps)
           + types[1])
    img = _ln(img, w, im + "LayerNorm", eps)
    if drop is not None:
        img = drop.embedding(img)
    x = torch.cat([txt, img], 1)
    mask = torch.cat([batch["txt_mask"], batch["img_mask"]], 1).float()
    bias = ((1.0 - mask) * NEG)[:, None, None, :]
    B, S = mask.shape

    def heads(t):
        return t.reshape(B, S, nh, d).permute(0, 2, 1, 3)

    for layer in range(cfg["num_hidden_layers"]):
        p = "uniter_model.encoder.layer.%d." % layer
        q, k, v = (heads(_lin(x, w, p + "attention.self." + n))
                   for n in ("query", "key", "value"))
        probs = torch.softmax(_mm(q, k.transpose(-1, -2)) / math.sqrt(d)
                              + bias, -1)
        if drop is not None:
            probs = drop.attention(probs)
        ctx = _mm(probs, v).permute(0, 2, 1, 3).reshape(B, S, H)
        a = _lin(ctx, w, p + "attention.output.dense")
        if drop is not None:
            a = drop.hidden(a)
        x = _ln(a + x, w, p + "attention.output.LayerNorm", eps)
        f = _lin(_gelu(_lin(x, w, p + "intermediate.dense")), w,
                 p + "output.dense")
        if drop is not None:
            f = drop.hidden(f)
        x = _ln(f + x, w, p + "output.LayerNorm", eps)
    pooled = torch.tanh(_lin(x[:, 0], w, "uniter_model.pooler.dense"))
    return _lin(pooled, w, "linear")


def bce_logits(logit: torch.Tensor, labels: torch.Tensor,
               sample_mask: torch.Tensor, pos_wt: float) -> torch.Tensor:
    """``BCEWithLogitsLoss(pos_weight)`` over the valid samples: the masked
    mean, over ``max(Σmask, 1)``."""
    x, y, m = logit.reshape(-1), labels.float(), sample_mask.float()
    per = -(pos_wt * y * F.logsigmoid(x) + (1.0 - y) * F.logsigmoid(-x))
    return (per * m).sum() / torch.clamp_min(m.sum(), 1.0)


# ----------------------------------------------------------------- optimizer

def warmup_cosine(step: int, warmup: int, total: int) -> float:
    """transformers' ``get_cosine_schedule_with_warmup`` factor."""
    if step < warmup:
        return step / max(1, warmup)
    progress = (step - warmup) / max(1, total - warmup)
    return max(0.0, 0.5 * (1.0 + math.cos(math.pi * progress)))


def adam_step(w: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
              state: dict, tc: dict, total_steps: int) -> None:
    """One update of ``w`` in place: clip to ``max_grad_norm``, add
    ``weight_decay``·w to the decayed leaves, Adam (moments stored in
    ``adam_mu_dtype`` / ``adam_nu_dtype``, math in float32), then
    −lr·schedule(count) with the count before the update."""
    b1, b2, eps = tc["beta1"], tc["beta2"], 1e-8
    norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values()))
    scale = (tc["max_grad_norm"] / norm).float() \
        if norm >= tc["max_grad_norm"] else None
    count = state.setdefault("count", 0) + 1
    lr = tc["lr"] * warmup_cosine(count - 1, tc["warmup_steps"], total_steps)
    mu_t = getattr(torch, tc["adam_mu_dtype"])
    nu_t = getattr(torch, tc["adam_nu_dtype"])
    with torch.no_grad():
        for name, p in w.items():
            g = grads[name] if scale is None else grads[name] * scale
            if decays(name):
                g = g + tc["weight_decay"] * p
            mu = b1 * state["mu"][name].float() + (1.0 - b1) * g \
                if name in state.get("mu", {}) else (1.0 - b1) * g
            nu = b2 * state["nu"][name].float() + (1.0 - b2) * g * g \
                if name in state.get("nu", {}) else (1.0 - b2) * g * g
            u = (mu / (1.0 - b1 ** count)) / (
                torch.sqrt(nu / (1.0 - b2 ** count)) + eps)
            state.setdefault("mu", {})[name] = mu.to(mu_t)
            state.setdefault("nu", {})[name] = nu.to(nu_t)
            p.add_(u, alpha=-lr)
    state["count"] = count


@contextlib.contextmanager
def precision(kind: str = "float32"):
    """Products in float32 (TF32 off), with TF32 on (``"tf32"``), or of
    operands rounded to float8 e4m3 (``"fp8"``)."""
    if kind not in ("float32", "tf32", "fp8"):
        raise ValueError("no precision %r" % kind)
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32, _fp8[0])
    tf32 = kind == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    _fp8[0] = kind == "fp8"
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32, _fp8[0]) = old
