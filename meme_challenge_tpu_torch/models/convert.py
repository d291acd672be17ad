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
kernels into torch ``[out, in]`` weights. This module is written anew rather
than copied: the JAX package's converter imports its flax-side config.
"""
from __future__ import annotations

import zipfile
from typing import Dict, Mapping

import numpy as np
import torch

TRUNK_PREFIX = "uniter_model."
HEAD_PREFIX = "linear."


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

    A file that is not a torch checkpoint (e.g. the JAX package's flax
    msgpack ``ModelSaver`` dumps) raises ``ValueError``: reading flax msgpack
    is queued in ROADMAP.md."""
    if not is_torch_checkpoint(path):
        raise ValueError(
            "%s is not a torch checkpoint; flax msgpack checkpoints of the "
            "JAX package are not read by the port yet (convert with "
            "meme_challenge_tpu.models.convert.save_reference_checkpoint)"
            % path)
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
    ``"finetuned"`` or ``"pretrain"``."""
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


def _t(w) -> np.ndarray:
    """flax kernel [in, out] → torch Linear weight [out, in]."""
    return np.array(np.asarray(w, dtype=np.float32).T, order="C")


def _a(x) -> np.ndarray:
    return np.array(x, dtype=np.float32, order="C")


def uniter_trunk_state_from_jax(params: Mapping, prefix: str = TRUNK_PREFIX
                                ) -> Dict[str, np.ndarray]:
    """flax UniterModel tree (numpy leaves) → reference-layout arrays."""
    out: Dict[str, np.ndarray] = {}
    emb = params["embeddings"]
    for torch_name, flax_name in (
            ("word_embeddings.weight", "word_embeddings"),
            ("position_embeddings.weight", "position_embeddings"),
            ("token_type_embeddings.weight", "token_type_embeddings"),
            ("LayerNorm.weight", "ln_scale"), ("LayerNorm.bias", "ln_bias")):
        out[prefix + "embeddings." + torch_name] = _a(emb[flax_name])
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

    enc = params["encoder"]
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
        lp = prefix + "encoder.layer.%d." % i
        for j, name in enumerate(("query", "key", "value")):
            out[lp + "attention.self.%s.weight" % name] = _t(
                qkv_k[i, :, j * H:(j + 1) * H])
            out[lp + "attention.self.%s.bias" % name] = _a(
                qkv_b[i, j * H:(j + 1) * H])
        for torch_name, (flax_name, transpose) in per_layer.items():
            mat = np.asarray(enc[flax_name][i])
            out[lp + torch_name] = _t(mat) if transpose else _a(mat)
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
