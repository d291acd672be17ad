"""Checkpoint conversion for the port's UNITER modules.

The port's ``MemeUniter`` keeps the reference's torch key layout, so most
checkpoints need only the reference's renames (model/model.py:148-214,
README.md:25-33):

- ``{'model_state_dict': ...}`` wrappers (utils/save.py:53-64),
- ``gamma``→``weight`` / ``beta``→``bias`` (TF-era LayerNorm names),
- a ``bert.`` prefix on raw UNITER pretraining dumps, and an optional
  ``uniter.`` trunk prefix inside them (``UniterForPretraining``).

:func:`meme_uniter_state_from_jax` carries weights across from a flax
MemeUniter parameter tree given as numpy arrays: it splits the stacked
``qkv_kernel [L, H, 3H]`` into three matrices and transposes flax ``[in, out]``
kernels into torch ``[out, in]`` weights; :func:`fold_stack_state_from_jax`
does so for F folds at once, into a ``FoldStack``'s ``[F, ...]`` state, and
:func:`pretrain_state_from_jax` for a ``UniterForPretraining`` (trunk under
``uniter.``, the heads under the reference's names).
:func:`pretrain_state_from_checkpoint` reads reference-layout torch
pretraining dumps, and :func:`load_pretrain_weights` warm-starts
pretraining from either format.
:func:`text_model_state_from_jax` and :func:`oscar_state_from_jax` do the
same for the text-only head models and Oscar;
:func:`hf_text_backbone_state` reads HuggingFace BERT / RoBERTa / ALBERT /
ELECTRA dumps into the port's text backbone, and
:func:`oscar_state_from_torch` reference Oscar checkpoints.
This module is written anew rather than copied: the JAX package's converter
imports its flax-side config.

:func:`read_flax_msgpack` decodes the JAX package's flax-msgpack files (its
``ModelSaver`` dumps: ``flax.serialization.to_bytes`` of ``{"params": ...}``)
in plain python: the msgpack subset flax writes (maps, arrays, str, bin,
int, float, bool, nil) and flax's extension types (ndarray 1, native
complex 2, numpy scalar 3; ``flax.serialization._MsgpackExtType``), with its
chunked-array leaves. It imports neither ``msgpack`` nor ``flax``.
"""
from __future__ import annotations

import struct
import zipfile
from typing import Dict, List, Mapping, Sequence, Union

import numpy as np
import torch

TRUNK_PREFIX = "uniter_model."
HEAD_PREFIX = "linear."
# UniterForPretraining: the trunk's prefix and the heads' keys (reference
# model/pretrain.py; the names JAX pretrain_params_from_torch reads)
PRETRAIN_TRUNK_PREFIX = "uniter."
PRETRAIN_HEAD_KEYS = tuple(
    ["cls.predictions.transform.%s.%s" % (m, w)
     for m in ("dense", "LayerNorm") for w in ("weight", "bias")]
    + ["cls.predictions.bias", "feat_regress.bias", "itm_output.weight",
       "itm_output.bias"]
    + ["feat_regress.net.%d.%s" % (i, w) for i in (0, 2)
       for w in ("weight", "bias")]
    + ["region_classifier.net.%d.%s" % (i, w) for i in (0, 2, 3)
       for w in ("weight", "bias")])


def is_torch_checkpoint(path: str) -> bool:
    """True for ``torch.save`` files: a zip archive, or a legacy pickle
    (protocol byte 0x80 followed by the protocol number 2-5)."""
    if zipfile.is_zipfile(path):
        return True
    with open(path, "rb") as f:
        head = f.read(2)
    return len(head) == 2 and head[0] == 0x80 and 2 <= head[1] <= 5


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Load a torch checkpoint onto the CPU; unwraps
    ``{'model_state_dict': ...}`` (reference utils/save.py:53-64).

    A file that is not a torch checkpoint raises ``ValueError``
    (:func:`load_pretrained` reads the JAX package's flax-msgpack dumps)."""
    if not is_torch_checkpoint(path):
        raise ValueError("%s is not a torch checkpoint" % path)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
        ckpt = ckpt["model_state_dict"]
    return {k: torch.as_tensor(v) for k, v in ckpt.items()}


def rename_reference_keys(sd: Mapping, strip_prefixes: tuple = ("bert.",)
                          ) -> dict:
    """gamma/beta renames + prefix stripping (reference model/model.py:164-200)."""
    out = {}
    for key, val in sd.items():
        new_key = key
        if "gamma" in new_key:
            new_key = new_key.replace("gamma", "weight")
        if "beta" in new_key:
            new_key = new_key.replace("beta", "bias")
        for p in strip_prefixes:
            if new_key.startswith(p):
                new_key = new_key[len(p):]
        out[new_key] = val
    return out


def meme_uniter_state_from_checkpoint(sd: Mapping) -> Dict[str, torch.Tensor]:
    """A fine-tuned MemeUniter dump (``uniter_model.`` trunk + ``linear.``
    head, model/meme_uniter.py) → the port's ``state_dict``."""
    return dict(rename_reference_keys(sd, strip_prefixes=()))


def pretrain_trunk_state(sd: Mapping) -> Dict[str, torch.Tensor]:
    """A raw UNITER pretraining dump → the trunk's keys under
    ``uniter_model.``, as reference TrainerUniter.init_model
    (train_uniter.py:22-34) reads it: ``bert.`` stripped, an optional
    ``uniter.`` trunk prefix, pretraining heads dropped."""
    sd = rename_reference_keys(sd, strip_prefixes=("bert.",))
    trunk = "uniter." if any(k.startswith("uniter.") for k in sd) else ""
    parts = ("embeddings.", "img_embeddings.", "encoder.", "pooler.")
    out = {}
    for k, v in sd.items():
        if k.startswith(trunk) and k[len(trunk):].startswith(parts):
            out[TRUNK_PREFIX + k[len(trunk):]] = v
    return out


def load_pretrained(model: torch.nn.Module, path: str) -> str:
    """Load ``path`` into a MemeUniter: a fine-tuned dump restores every
    weight (strict); a pretraining dump restores the trunk, and the head
    keeps its initial weights (every trunk key must be present). Returns
    ``"finetuned"`` or ``"pretrain"``.

    ``path`` is a reference torch dump, or a flax-msgpack ``ModelSaver``
    dump of the JAX package, read as JAX ``_try_load_flax_params`` reads it
    (train/train_uniter.py:83-100 there): the tree under ``"params"`` (or
    the whole tree); with a ``"classifier"`` it is a fine-tuned MemeUniter,
    else its ``"uniter"`` trunk is loaded."""
    if not is_torch_checkpoint(path):
        tree = read_flax_msgpack(path)
        if not isinstance(tree, dict):
            raise ValueError("%s is not a torch checkpoint nor a flax "
                             "parameter tree" % path)
        params = tree.get("params", tree)
        if "classifier" in params:
            model.load_state_dict(meme_uniter_state_from_jax(params),
                                  strict=True)
            return "finetuned"
        state = {k: torch.from_numpy(v) for k, v in
                 uniter_trunk_state_from_jax(params["uniter"]).items()}
        state.update({k: v for k, v in model.state_dict().items()
                      if k.startswith(HEAD_PREFIX)})
        model.load_state_dict(state, strict=True)
        return "pretrain"
    sd = load_torch_state_dict(path)
    if any(k.startswith(TRUNK_PREFIX) for k in sd):
        state = meme_uniter_state_from_checkpoint(sd)
        if not any(k.startswith(HEAD_PREFIX) for k in state):
            # trunk-only fine-tune dump: keep the current head
            state.update({k: v for k, v in model.state_dict().items()
                          if k.startswith(HEAD_PREFIX)})
        model.load_state_dict(state, strict=True)
        return "finetuned"
    state = pretrain_trunk_state(sd)
    if "%simg_embeddings.mask_embedding.weight" % TRUNK_PREFIX not in state:
        # older dumps carry no MRFR mask embedding (JAX converter: zeros)
        key = "%simg_embeddings.mask_embedding.weight" % TRUNK_PREFIX
        state[key] = torch.zeros_like(model.state_dict()[key])
    missing, unexpected = model.load_state_dict(state, strict=False)
    missing = [k for k in missing if not k.startswith(HEAD_PREFIX)]
    if missing or unexpected:
        raise KeyError("pretraining dump %s does not fit the trunk: missing "
                       "%s, unexpected %s" % (path, missing, unexpected))
    return "pretrain"


def load_pretrain_weights(model: torch.nn.Module, path: str) -> str:
    """Warm-start a ``UniterForPretraining`` from ``path`` (JAX
    pretrain_uniter.py:191-211): a flax-msgpack pretraining dump restores
    the trunk and every head it holds, a fine-tuned MemeUniter dump (flax
    or torch) the trunk only, and a torch pretraining dump (the port's own,
    or the reference's) the trunk and the heads it carries
    (:func:`pretrain_state_from_checkpoint`; the JAX package reads only the
    trunk of a torch file). Heads the file lacks keep their weights; every
    trunk key must be present. Returns ``"pretrain"`` or ``"finetuned"``."""
    if is_torch_checkpoint(path):
        sd = load_torch_state_dict(path)
        kind = ("finetuned" if any(k.startswith(TRUNK_PREFIX) for k in sd)
                else "pretrain")
        state = pretrain_state_from_checkpoint(sd)
    else:
        tree = read_flax_msgpack(path)
        if not isinstance(tree, dict):
            raise ValueError("%s is not a torch checkpoint nor a flax "
                             "parameter tree" % path)
        params = tree.get("params", tree)
        kind = "finetuned" if "classifier" in params else "pretrain"
        state = pretrain_state_from_jax(
            {"uniter": params["uniter"]} if kind == "finetuned" else params)
    current = model.state_dict()
    trunk = [k for k in current if k.startswith(PRETRAIN_TRUNK_PREFIX)]
    missing = [k for k in trunk if k not in state]
    unexpected = [k for k in state if k not in current]
    if missing or unexpected:
        raise KeyError("%s does not fit UniterForPretraining: missing %s, "
                       "unexpected %s" % (path, missing, unexpected))
    current.update(state)
    model.load_state_dict(current, strict=True)
    return kind


def _t(w) -> np.ndarray:
    """flax kernel [in, out] → torch Linear weight [out, in]."""
    return np.array(np.asarray(w, dtype=np.float32).T, order="C")


def _a(x) -> np.ndarray:
    return np.array(x, dtype=np.float32, order="C")


def _embeddings_state_from_jax(emb: Mapping, prefix: str
                               ) -> Dict[str, np.ndarray]:
    """A flax ``TextEmbeddings`` tree → ``{prefix}*`` arrays (BERT's
    ``word/position/token_type_embeddings`` and ``LayerNorm``)."""
    return {prefix + torch_name: _a(emb[flax_name])
            for torch_name, flax_name in (
                ("word_embeddings.weight", "word_embeddings"),
                ("position_embeddings.weight", "position_embeddings"),
                ("token_type_embeddings.weight", "token_type_embeddings"),
                ("LayerNorm.weight", "ln_scale"),
                ("LayerNorm.bias", "ln_bias"))}


def _encoder_state_from_jax(enc: Mapping, prefix: str
                            ) -> Dict[str, np.ndarray]:
    """A flax ``StackedEncoder`` tree (``[L, ...]`` stacked leaves) →
    ``{prefix}layer.{i}.*`` arrays: the ``[L, H, 3H]`` QKV kernel split
    into query, key and value, kernels transposed."""
    out: Dict[str, np.ndarray] = {}
    qkv_k = np.asarray(enc["qkv_kernel"], dtype=np.float32)   # [L, H, 3H]
    qkv_b = np.asarray(enc["qkv_bias"], dtype=np.float32)     # [L, 3H]
    L, H = qkv_k.shape[0], qkv_k.shape[1]
    per_layer = {
        "attention.output.dense.weight": ("attn_out_kernel", True),
        "attention.output.dense.bias": ("attn_out_bias", False),
        "attention.output.LayerNorm.weight": ("attn_ln_scale", False),
        "attention.output.LayerNorm.bias": ("attn_ln_bias", False),
        "intermediate.dense.weight": ("ffn_in_kernel", True),
        "intermediate.dense.bias": ("ffn_in_bias", False),
        "output.dense.weight": ("ffn_out_kernel", True),
        "output.dense.bias": ("ffn_out_bias", False),
        "output.LayerNorm.weight": ("ffn_ln_scale", False),
        "output.LayerNorm.bias": ("ffn_ln_bias", False),
    }
    for i in range(L):
        lp = prefix + "layer.%d." % i
        for j, name in enumerate(("query", "key", "value")):
            out[lp + "attention.self.%s.weight" % name] = _t(
                qkv_k[i, :, j * H:(j + 1) * H])
            out[lp + "attention.self.%s.bias" % name] = _a(
                qkv_b[i, j * H:(j + 1) * H])
        for torch_name, (flax_name, transpose) in per_layer.items():
            mat = np.asarray(enc[flax_name][i])
            out[lp + torch_name] = _t(mat) if transpose else _a(mat)
    return out


def uniter_trunk_state_from_jax(params: Mapping, prefix: str = TRUNK_PREFIX
                                ) -> Dict[str, np.ndarray]:
    """flax UniterModel tree (numpy leaves) → reference-layout arrays."""
    out = _embeddings_state_from_jax(params["embeddings"],
                                     prefix + "embeddings.")
    img = params["img_embeddings"]
    p = prefix + "img_embeddings."
    out[p + "img_linear.weight"] = _t(img["img_linear_kernel"])
    out[p + "img_linear.bias"] = _a(img["img_linear_bias"])
    out[p + "pos_linear.weight"] = _t(img["pos_linear_kernel"])
    out[p + "pos_linear.bias"] = _a(img["pos_linear_bias"])
    for torch_name, flax_name in (
            ("img_layer_norm.weight", "img_ln_scale"),
            ("img_layer_norm.bias", "img_ln_bias"),
            ("pos_layer_norm.weight", "pos_ln_scale"),
            ("pos_layer_norm.bias", "pos_ln_bias"),
            ("LayerNorm.weight", "ln_scale"), ("LayerNorm.bias", "ln_bias"),
            ("mask_embedding.weight", "mask_embedding")):
        out[p + torch_name] = _a(img[flax_name])

    out.update(_encoder_state_from_jax(params["encoder"],
                                       prefix + "encoder."))
    dense = params["pooler"]["dense"]
    out[prefix + "pooler.dense.weight"] = _t(dense["kernel"])
    out[prefix + "pooler.dense.bias"] = _a(dense["bias"])
    return out


def meme_uniter_state_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax MemeUniter tree (``{"uniter": ..., "classifier": ...}``, numpy
    leaves) → the port's MemeUniter ``state_dict`` (CPU tensors)."""
    out = uniter_trunk_state_from_jax(params["uniter"])
    if "classifier" in params:
        out[HEAD_PREFIX + "weight"] = _t(params["classifier"]["kernel"])
        out[HEAD_PREFIX + "bias"] = _a(params["classifier"]["bias"])
    return {k: torch.from_numpy(v) for k, v in out.items()}


def pretrain_state_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``UniterForPretraining`` tree (numpy leaves; the full head tree
    or the trunk alone) → the port's ``UniterForPretraining`` keys (CPU
    tensors): the trunk under ``uniter.`` and each head the tree holds."""
    out = uniter_trunk_state_from_jax(params["uniter"],
                                      prefix=PRETRAIN_TRUNK_PREFIX)
    if "mlm_head" in params:
        h, p = params["mlm_head"], "cls.predictions."
        out[p + "transform.dense.weight"] = _t(h["transform_dense"]["kernel"])
        out[p + "transform.dense.bias"] = _a(h["transform_dense"]["bias"])
        out[p + "transform.LayerNorm.weight"] = _a(h["transform_ln_scale"])
        out[p + "transform.LayerNorm.bias"] = _a(h["transform_ln_bias"])
        out[p + "bias"] = _a(h["bias"])
    for name in ("feat_regress", "region_classifier"):
        if name not in params:
            continue
        h = params[name]
        out[name + ".net.0.weight"] = _t(h["net_dense"]["kernel"])
        out[name + ".net.0.bias"] = _a(h["net_dense"]["bias"])
        out[name + ".net.2.weight"] = _a(h["net_ln_scale"])
        out[name + ".net.2.bias"] = _a(h["net_ln_bias"])
        if "net_out" in h:
            out[name + ".net.3.weight"] = _t(h["net_out"]["kernel"])
            out[name + ".net.3.bias"] = _a(h["net_out"]["bias"])
        if "bias" in h:
            out[name + ".bias"] = _a(h["bias"])
    if "itm_output" in params:
        out["itm_output.weight"] = _t(params["itm_output"]["kernel"])
        out["itm_output.bias"] = _a(params["itm_output"]["bias"])
    return {k: torch.from_numpy(v) for k, v in out.items()}


def pretrain_state_from_checkpoint(sd: Mapping) -> Dict[str, torch.Tensor]:
    """A torch checkpoint → the ``UniterForPretraining`` keys it holds:

    - a reference pretraining dump (``bert.`` stripped, an optional
      ``uniter.`` trunk prefix; JAX ``pretrain_params_from_torch``): the
      trunk and the heads it carries (the tied decoder copies,
      ``cls.predictions.decoder.*`` and ``feat_regress.weight``, dropped);
      without ``img_embeddings.mask_embedding`` that table is zeros, as the
      JAX converter makes it;
    - a fine-tuned MemeUniter dump (``uniter_model.``): the trunk only."""
    sd = rename_reference_keys(sd, strip_prefixes=("bert.",))
    if any(k.startswith(TRUNK_PREFIX) for k in sd):
        trunk = {k: v for k, v in sd.items() if k.startswith(TRUNK_PREFIX)}
        heads = {}
    else:
        trunk = pretrain_trunk_state(sd)
        heads = {k: torch.as_tensor(v) for k, v in sd.items()
                 if k in PRETRAIN_HEAD_KEYS}
    out = {PRETRAIN_TRUNK_PREFIX + k[len(TRUNK_PREFIX):]: torch.as_tensor(v)
           for k, v in trunk.items()}
    mask_key = PRETRAIN_TRUNK_PREFIX + "img_embeddings.mask_embedding.weight"
    if mask_key not in out:
        img = out[PRETRAIN_TRUNK_PREFIX + "img_embeddings.img_linear.weight"]
        out[mask_key] = torch.zeros((2, img.shape[1]), dtype=img.dtype)
    out.update(heads)
    return out


def _linear_from_jax(dense: Mapping, prefix: str) -> Dict[str, np.ndarray]:
    return {prefix + "weight": _t(dense["kernel"]),
            prefix + "bias": _a(dense["bias"])}


def text_model_state_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``TransformerClassificationHead`` tree (``{"backbone": ...,
    "head_dense_{i}", "head_ln_{i}", "head_out"}``, numpy leaves) → the
    port's ``models.text_models.TransformerClassificationHead``
    ``state_dict`` (CPU tensors)."""
    bb = params["backbone"]
    out = {"backbone.embeddings." + torch_name: _a(bb[flax_name])
           for torch_name, flax_name in (
               ("word_embeddings.weight", "word_embeddings"),
               ("position_embeddings.weight", "position_embeddings"),
               ("token_type_embeddings.weight", "token_type_embeddings"),
               ("LayerNorm.weight", "emb_ln_scale"),
               ("LayerNorm.bias", "emb_ln_bias"))}
    if "emb_proj" in bb:
        out.update(_linear_from_jax(bb["emb_proj"], "backbone.emb_proj."))
    out.update(_encoder_state_from_jax(bb["encoder"], "backbone.encoder."))
    if "pooler" in bb:
        out.update(_linear_from_jax(bb["pooler"]["dense"],
                                    "backbone.pooler.dense."))
    for name, leaf in params.items():
        if name.startswith("head_ln_"):
            out[name + ".weight"] = _a(leaf["scale"])
            out[name + ".bias"] = _a(leaf["bias"])
        elif name.startswith("head_"):
            out.update(_linear_from_jax(leaf, name + "."))
    return {k: torch.from_numpy(v) for k, v in out.items()}


def oscar_state_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """flax ``ImageBertForSequenceClassification`` tree (numpy leaves) → the
    port's ``models.oscar.ImageBertForSequenceClassification``
    ``state_dict`` (CPU tensors): the linear head (``cls_out``) or the MLP
    (``cls_hidden`` + ``cls_out``), the image LayerNorm if present."""
    bert = params["bert"]
    out = _embeddings_state_from_jax(bert["embeddings"], "bert.embeddings.")
    out["bert.img_embedding.weight"] = _t(bert["img_embedding_kernel"])
    out["bert.img_embedding.bias"] = _a(bert["img_embedding_bias"])
    if "img_ln_scale" in bert:
        out["bert.LayerNorm.weight"] = _a(bert["img_ln_scale"])
        out["bert.LayerNorm.bias"] = _a(bert["img_ln_bias"])
    out.update(_encoder_state_from_jax(bert["encoder"], "bert.encoder."))
    out.update(_linear_from_jax(bert["pooler"]["dense"], "bert.pooler.dense."))
    if "cls_hidden" in params:
        out.update(_linear_from_jax(params["cls_hidden"], "classifier.0."))
        out.update(_linear_from_jax(params["cls_out"], "classifier.2."))
    else:
        out.update(_linear_from_jax(params["cls_out"], "classifier."))
    return {k: torch.from_numpy(v) for k, v in out.items()}


# one BERT layer's keys (reference / HF layout), as the port's BertLayer
_BERT_LAYER_KEYS = tuple(
    "%s.%s" % (m, w) for m in (
        "attention.self.query", "attention.self.key", "attention.self.value",
        "attention.output.dense", "attention.output.LayerNorm",
        "intermediate.dense", "output.dense", "output.LayerNorm")
    for w in ("weight", "bias"))
# ALBERT's shared layer (HF albert_layer_groups.0.albert_layers.0) → BertLayer
_ALBERT_LAYER = {
    "attention.query": "attention.self.query",
    "attention.key": "attention.self.key",
    "attention.value": "attention.self.value",
    "attention.dense": "attention.output.dense",
    "attention.LayerNorm": "attention.output.LayerNorm",
    "ffn": "intermediate.dense",
    "ffn_output": "output.dense",
    "full_layer_layer_norm": "output.LayerNorm",
}


def _bert_layers(sd: Mapping, src: str, dst: str, num_layers: int
                 ) -> Dict[str, torch.Tensor]:
    """``{src}layer.{i}.*`` of a BERT-layout state dict for every i below
    ``num_layers`` → ``{dst}layer.{i}.*``; a missing key raises KeyError."""
    return {"%slayer.%d.%s" % (dst, i, k):
            torch.as_tensor(sd["%slayer.%d.%s" % (src, i, k)])
            for i in range(num_layers) for k in _BERT_LAYER_KEYS}


def hf_text_backbone_state(sd: Mapping, config) -> Dict[str, torch.Tensor]:
    """A HuggingFace BERT / RoBERTa / ALBERT / ELECTRA model state dict →
    the port's ``models.text_models.TextBackbone`` ``state_dict`` (the JAX
    package's ``hf_text_backbone_params`` in the port's layout).

    - bert / roberta: ``embeddings.*``, ``encoder.layer.{i}.*``,
      ``pooler.dense.*`` carry over by name (a RoBERTa dump without
      ``token_type_embeddings`` gets one zero row);
    - electra: ``embeddings_project`` → ``emb_proj``; no pooler;
    - albert: ``encoder.embedding_hidden_mapping_in`` → ``emb_proj``, the one
      shared layer ``encoder.albert_layer_groups.0.albert_layers.0`` →
      ``encoder.layer.0``, ``pooler`` → ``pooler.dense``.
    A ``bert.`` / ``roberta.`` / ``electra.`` / ``albert.`` prefix is
    stripped; keys the backbone has no place for (``position_ids``
    buffers, task heads) are dropped; a key it needs and the dump lacks
    raises KeyError."""
    sd = rename_reference_keys(
        sd, strip_prefixes=("bert.", "roberta.", "electra.", "albert."))

    def g(k):
        return torch.as_tensor(sd[k])

    out = {"embeddings.%s.weight" % n: g("embeddings.%s.weight" % n)
           for n in ("word_embeddings", "position_embeddings")}
    type_key = "embeddings.token_type_embeddings.weight"
    out[type_key] = (g(type_key) if type_key in sd else torch.zeros(
        (1, out["embeddings.word_embeddings.weight"].shape[1])))
    for w in ("weight", "bias"):
        out["embeddings.LayerNorm." + w] = g("embeddings.LayerNorm." + w)
        if config.family == "electra" and "embeddings_project.weight" in sd:
            out["emb_proj." + w] = g("embeddings_project." + w)
        if config.family == "albert":
            out["emb_proj." + w] = g(
                "encoder.embedding_hidden_mapping_in." + w)
            p = "encoder.albert_layer_groups.0.albert_layers.0."
            for hf, ours in _ALBERT_LAYER.items():
                out["encoder.layer.0.%s.%s" % (ours, w)] = g(
                    "%s%s.%s" % (p, hf, w))
        if config.has_pooler:
            out["pooler.dense." + w] = g(
                ("pooler." if config.family == "albert" else "pooler.dense.")
                + w)
    if config.family != "albert":
        out.update(_bert_layers(sd, "encoder.", "encoder.",
                                config.num_hidden_layers))
    return out


def oscar_state_from_torch(sd: Mapping, config) -> Dict[str, torch.Tensor]:
    """A reference Oscar checkpoint (``ImageBertForSequenceClassification``,
    model/oscar.py:284-328 around ``BertImgModel`` :145-273) → the port's
    ``models.oscar.ImageBertForSequenceClassification`` ``state_dict``.

    The port keeps the reference's keys, so this reads the ones the model
    has, as JAX ``oscar_params_from_torch`` does: the HF-BERT embeddings,
    ``config.num_hidden_layers`` encoder layers and pooler under ``bert.``,
    the 2054 → H ``bert.img_embedding``, the image LayerNorm
    ``bert.LayerNorm`` where the dump has one (``use_img_layernorm``), and
    the linear head ``classifier.*`` or the MLP ``classifier.{0,2}.*``.
    TF-era ``gamma``/``beta`` names are renamed; other keys (the
    ``dis_code`` branches, buffers) are dropped; a missing key raises
    KeyError. Build the model with the head and image LayerNorm the keys
    show."""
    sd = rename_reference_keys(sd, strip_prefixes=())
    names = ["bert.embeddings.%s.weight" % n for n in (
        "word_embeddings", "position_embeddings", "token_type_embeddings")]
    for w in ("weight", "bias"):
        names += ["bert.embeddings.LayerNorm." + w, "bert.img_embedding." + w,
                  "bert.pooler.dense." + w]
        if "bert.LayerNorm.weight" in sd:
            names.append("bert.LayerNorm." + w)
        if "classifier.weight" in sd:
            names.append("classifier." + w)
        else:
            names += ["classifier.0." + w, "classifier.2." + w]
    out = {k: torch.as_tensor(sd[k]) for k in names}
    out.update(_bert_layers(sd, "bert.encoder.", "bert.encoder.",
                            config.num_hidden_layers))
    return out


def fold_stack_state_from_jax(params: Union[Mapping, Sequence[Mapping]]
                              ) -> Dict[str, torch.Tensor]:
    """F flax MemeUniter trees (a list), or one tree whose leaves carry a
    leading fold axis (JAX ``FoldParallelTrainer.state.params``), → the
    port's fold-stacked state: every MemeUniter ``state_dict`` name with a
    leading ``[F, ...]`` axis (CPU tensors), as ``FoldStack`` holds it."""
    if isinstance(params, Mapping):
        n = len(_leaves(params)[0])
        params = [_index_tree(params, f) for f in range(n)]
    states = [meme_uniter_state_from_jax(p) for p in params]
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


def _leaves(tree) -> List[np.ndarray]:
    if isinstance(tree, Mapping):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [np.asarray(tree)]


def _index_tree(tree, i: int):
    if isinstance(tree, Mapping):
        return {k: _index_tree(v, i) for k, v in tree.items()}
    return np.asarray(tree)[i]


# --------------------------------------------------------------------------
# flax msgpack, decoded in plain python
# --------------------------------------------------------------------------

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


def _dtype(name) -> np.dtype:
    name = name.decode() if isinstance(name, bytes) else name
    # numpy has no bfloat16: its 16 bits are read as the top of a float32
    return np.dtype(np.uint16) if name == "bfloat16" else np.dtype(name)


def _ndarray(payload: bytes) -> np.ndarray:
    shape, dtype_name, buffer = _Msgpack(payload).read_all()
    arr = np.frombuffer(buffer, dtype=_dtype(dtype_name)).reshape(shape)
    if (dtype_name.decode() if isinstance(dtype_name, bytes)
            else dtype_name) == "bfloat16":
        arr = (arr.astype(np.uint32) << 16).view(np.float32)
    return arr


class _Msgpack:
    """A msgpack decoder for what ``flax.serialization.msgpack_serialize``
    writes."""

    _FIXED = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q", 0xd0: ">b",
              0xd1: ">h", 0xd2: ">i", 0xd3: ">q", 0xca: ">f", 0xcb: ">d"}

    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def _take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def _unpack(self, fmt: str):
        return struct.unpack(fmt, self._take(struct.calcsize(fmt)))[0]

    def read_all(self):
        value = self.read()
        if self.pos != len(self.data):
            raise ValueError("trailing bytes after the msgpack value")
        return value

    def read(self):
        b = self._unpack(">B")
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self._map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self._array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return bytes(self._take(b & 0x1f)).decode()
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in (0xc4, 0xc5, 0xc6):  # bin 8/16/32
            return bytes(self._take(self._unpack(
                {0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}[b])))
        if b in (0xc7, 0xc8, 0xc9):  # ext 8/16/32
            n = self._unpack({0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}[b])
            return self._ext(self._unpack(">b"), bytes(self._take(n)))
        if 0xd4 <= b <= 0xd8:  # fixext 1/2/4/8/16
            code = self._unpack(">b")
            return self._ext(code, bytes(self._take(1 << (b - 0xd4))))
        if b in self._FIXED:
            return self._unpack(self._FIXED[b])
        if b in (0xd9, 0xda, 0xdb):  # str 8/16/32
            n = self._unpack({0xd9: ">B", 0xda: ">H", 0xdb: ">I"}[b])
            return bytes(self._take(n)).decode()
        if b in (0xdc, 0xdd):
            return self._array(self._unpack(">H" if b == 0xdc else ">I"))
        if b in (0xde, 0xdf):
            return self._map(self._unpack(">H" if b == 0xde else ">I"))
        raise ValueError("byte 0x%02x is not msgpack" % b)

    def _array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    @staticmethod
    def _ext(code: int, payload: bytes):
        if code == _EXT_NDARRAY:
            return _ndarray(payload)
        if code == _EXT_NPSCALAR:
            return _ndarray(payload)[()]
        if code == _EXT_COMPLEX:
            real, imag = _Msgpack(payload).read_all()
            return complex(real, imag)
        raise ValueError("unknown msgpack extension type %d" % code)


def _unchunk(tree):
    """flax's chunked leaves (arrays above its chunk size, split into
    ``{"__msgpack_chunked_array__", "shape", "chunks"}``) back into arrays."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_flax_msgpack(path: str):
    """The tree of a flax-msgpack file (``flax.serialization.to_bytes``):
    dicts, lists and numpy leaves. A file that is not msgpack raises
    ``ValueError``."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return _unchunk(_Msgpack(data).read_all())
    except (ValueError, UnicodeDecodeError, struct.error) as e:
        raise ValueError("%s is not a torch checkpoint nor flax msgpack: %s"
                         % (path, e)) from None
