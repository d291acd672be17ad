"""Weights for the port's BUA detector.

The port's :class:`extract.detector.BUADetector` keeps detectron2's key
layout, so the reference's Caffe-converted checkpoints
(``bua-caffe-frcn-r101_with_attributes.pth``, configs yaml MODEL.WEIGHTS)
load almost as they stand: :func:`detector_state_from_torch` takes the keys
the port has from the checkpoint's state dict (``backbone.stem.conv1``,
``backbone.res{2,3,4}.{i}.conv{1..3}`` with their ``.norm``, ``shortcut``
projections, ``roi_heads.res5.{i}.*``, ``proposal_generator.rpn_head.*``,
``roi_heads.box_predictor.*``). FrozenBN weight/bias are read as they are
(the Caffe conversion pre-folds the running statistics), as the JAX
converter reads them.

:func:`detector_state_from_jax` carries the JAX package's flax tree
(``init_detector_params``, numpy leaves) across: HWIO kernels → OIHW,
``[in, out]`` dense kernels → ``[out, in]``, ``scale`` → ``weight``.
:func:`load_detector_weights` reads a ``.pth``/``.pt`` checkpoint or a
flax ``.msgpack`` dump (the JAX ``ModelSaver`` format, through the port's
own decoder), as JAX ``train_detector.load_weights`` does.
"""
from __future__ import annotations

import logging
from typing import Dict, Mapping

import numpy as np
import torch

from meme_challenge_tpu_torch.extract.detector import (
    BUADetector,
    DetectorConfig,
    init_detector,
)
from meme_challenge_tpu_torch.models.convert import read_flax_msgpack

logger = logging.getLogger("meme_challenge_tpu_torch.extract.convert")

# the attribute head, absent from checkpoints without attributes
ATTRIBUTE_KEYS = tuple(
    "roi_heads.box_predictor.%s" % k for k in (
        "cls_embedding.weight", "attr_linear1.weight", "attr_linear1.bias",
        "attr_linear2.weight", "attr_linear2.bias"))


def detector_keys(cfg: DetectorConfig):
    """The port's parameter names for ``cfg``, in state-dict order."""
    with torch.device("meta"):
        return list(BUADetector(cfg).state_dict())


def detector_state_from_torch(path_or_sd, cfg: DetectorConfig
                              ) -> Dict[str, torch.Tensor]:
    """The port's state from a detectron2-layout BUA checkpoint (a path or
    a state dict). A missing key raises ``KeyError``, except the attribute
    head's, which stay out of the result with a warning (they keep their
    random initialisation, as in the JAX converter)."""
    if isinstance(path_or_sd, str):
        # the reference's checkpoints are full pickles (detectron2 writes
        # numpy arrays and metadata), read as the JAX converter reads them
        ckpt = torch.load(path_or_sd, map_location="cpu", weights_only=False)
        if isinstance(ckpt, dict) and "model" in ckpt:
            ckpt = ckpt["model"]
    else:
        ckpt = path_or_sd
    state, missing = {}, []
    for key in detector_keys(cfg):
        if key not in ckpt:
            if key in ATTRIBUTE_KEYS:
                missing.append(key)
                continue
            raise KeyError("checkpoint lacks %r" % key)
        state[key] = torch.as_tensor(np.asarray(
            ckpt[key].cpu().numpy() if hasattr(ckpt[key], "cpu")
            else ckpt[key], np.float32))
    if missing:
        logger.warning("Checkpoint lacks attribute head pieces %s — "
                       "attribute outputs stay random-init.", missing)
    return state


def _conv(w) -> torch.Tensor:
    """flax HWIO → torch OIHW."""
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1))))


def _vec(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, np.float32))


def _dense(tree: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    return {prefix + ".weight": torch.from_numpy(np.ascontiguousarray(
                np.asarray(tree["kernel"], np.float32).T)),
            prefix + ".bias": _vec(tree["bias"])}


def _conv_norm(tree: Mapping, conv: str, bn: str, prefix: str
               ) -> Dict[str, torch.Tensor]:
    return {prefix + ".weight": _conv(tree[conv]["kernel"]),
            prefix + ".norm.weight": _vec(tree[bn]["scale"]),
            prefix + ".norm.bias": _vec(tree[bn]["bias"])}


def _blocks(stage: Mapping, prefix: str) -> Dict[str, torch.Tensor]:
    out = {}
    for i in range(len(stage)):
        block = stage["block%d" % i]
        p = "%s.%d" % (prefix, i)
        for j in (1, 2, 3):
            out.update(_conv_norm(block, "conv%d" % j, "bn%d" % j,
                                  "%s.conv%d" % (p, j)))
        if "shortcut" in block:
            out.update(_conv_norm(block, "shortcut", "shortcut_bn",
                                  p + ".shortcut"))
    return out


def detector_state_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """The port's state from a flax ``BUADetector`` tree (numpy leaves):
    ``{"backbone", "rpn", "roi_head"}``, the attribute head included where
    the tree has it."""
    bb, rpn, roi = params["backbone"], params["rpn"], params["roi_head"]
    state = _conv_norm(bb, "conv1", "bn1", "backbone.stem.conv1")
    for stage in ("res2", "res3", "res4"):
        state.update(_blocks(bb[stage], "backbone." + stage))
    state.update(_blocks(roi["res5"]["res5"], "roi_heads.res5"))
    head = "proposal_generator.rpn_head."
    for ours, theirs in (("conv", "conv"),
                         ("objectness_logits", "objectness"),
                         ("anchor_deltas", "anchor_deltas")):
        state[head + ours + ".weight"] = _conv(rpn[theirs]["kernel"])
        state[head + ours + ".bias"] = _vec(rpn[theirs]["bias"])
    pred = "roi_heads.box_predictor."
    for ours, theirs in (("cls_score", "cls_score"),
                         ("bbox_pred", "bbox_pred"),
                         ("attr_linear1", "attr_fc"),
                         ("attr_linear2", "attr_score")):
        if theirs in roi:
            state.update(_dense(roi[theirs], pred + ours))
    if "cls_embed" in roi:
        state[pred + "cls_embedding.weight"] = _vec(
            roi["cls_embed"]["embedding"])
    return state


def load_detector_weights(path: str, cfg: DetectorConfig, seed: int = 0
                          ) -> Dict[str, torch.Tensor]:
    """A full detector state from the file at ``path``: a torch
    ``.pth``/``.pt`` (Caffe-converted, detectron2 layout) or a flax
    ``.msgpack`` dump of the JAX package. What the file lacks (no file at
    all, or a checkpoint without the attribute head) comes from random
    weights drawn from ``seed`` (:func:`init_detector`)."""
    with torch.device("meta"):
        shapes = {k: tuple(v.shape)
                  for k, v in BUADetector(cfg).state_dict().items()}
    loaded = {}
    if path and path.endswith((".pth", ".pt")):
        loaded = detector_state_from_torch(path, cfg)
    elif path:
        tree = read_flax_msgpack(path)
        loaded = detector_state_from_jax(tree.get("params", tree))
    for key, value in loaded.items():
        if tuple(value.shape) != shapes.get(key):
            raise ValueError("%s: %s has shape %s, the config expects %s"
                             % (path, key, tuple(value.shape),
                                shapes.get(key)))
    if set(loaded) == set(shapes):
        return {k: loaded[k] for k in shapes}
    state = init_detector(cfg, torch.Generator().manual_seed(seed)
                          ).state_dict()
    state.update(loaded)
    return state
