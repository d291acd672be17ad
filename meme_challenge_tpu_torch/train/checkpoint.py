"""Checkpointing in the reference's torch format.

Counterpart of ``meme_challenge_tpu/train/checkpoint.py``. ``ModelSaver``
writes ``torch.save({'model_state_dict': sd})`` (reference utils/save.py:53-64)
— the format the JAX package's ``save_reference_checkpoint`` writes
(convert.py:516-524), so a checkpoint moves between the two packages and the
reference. Flax msgpack, the JAX ``ModelSaver``'s own format, is read by
``models/convert.py`` (``load_pretrained``) without flax.

``save_train_state`` / ``load_train_state`` keep the full training state
for a mid-training resume (parameters, optimizer moments, step count,
epoch) in a torch file of the port's own; ``save_training_meta`` writes the
hyper-parameters and git information (reference utils/save.py:11-48).
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
from typing import Mapping, Union

import torch
from torch import nn

from meme_challenge_tpu_torch.models.convert import (
    load_torch_state_dict,
    meme_uniter_state_from_checkpoint,
)


class ModelSaver:
    """Best-model weights persistence (reference utils/save.py:53-64)."""

    def __init__(self, output_path: str):
        self.output_path = output_path

    def save(self, model: Union[nn.Module, Mapping[str, torch.Tensor]]
             ) -> None:
        """Write ``model``'s weights: a module, or its ``state_dict``."""
        sd = model.state_dict() if isinstance(model, nn.Module) else model
        sd = {k: v.detach().cpu() for k, v in sd.items()}
        os.makedirs(os.path.dirname(os.path.abspath(self.output_path)),
                    exist_ok=True)
        tmp = self.output_path + ".tmp"
        torch.save({"model_state_dict": sd}, tmp)
        os.replace(tmp, self.output_path)

    def load(self, model: nn.Module) -> nn.Module:
        """Load the saved weights into ``model`` (strict key match)."""
        sd = meme_uniter_state_from_checkpoint(
            load_torch_state_dict(self.output_path))
        model.load_state_dict(sd, strict=True)
        return model


def tree_to(tree, device):
    """A state tree (dicts of tensors and ints) on ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.detach().to(device) if isinstance(tree, torch.Tensor) else tree


def save_train_state(path: str, state, epoch: int) -> None:
    """Full-state checkpoint of a ``steps.TrainState`` for resume."""
    payload = {"params": tree_to(state.model.state_dict(), "cpu"),
               "opt_state": tree_to(state.opt_state, "cpu"),
               "step": int(state.step), "epoch": int(epoch)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def load_train_state(path: str, state):
    """Restores ``state`` (its model's parameters, its optimizer state and
    step) in place from :func:`save_train_state`'s file; returns
    (state, epoch)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(payload["params"], strict=True)
    device = next(state.model.parameters()).device
    state.opt_state = tree_to(payload["opt_state"], device)
    state.step = int(payload["step"])
    return state, int(payload["epoch"])


def save_training_meta(output_dir: str, config, model_config=None) -> None:
    """log/hps.json + log/model.json + log/git_info.json (reference
    utils/save.py:11-48)."""
    log_dir = os.path.join(output_dir, "log")
    os.makedirs(log_dir, exist_ok=True)
    cfg = (dataclasses.asdict(config)
           if dataclasses.is_dataclass(config) else dict(config))
    with open(os.path.join(log_dir, "hps.json"), "w") as f:
        json.dump(cfg, f, indent=4, default=str)
    if model_config is not None:
        mc = (dataclasses.asdict(model_config)
              if dataclasses.is_dataclass(model_config) else dict(model_config))
        with open(os.path.join(log_dir, "model.json"), "w") as f:
            json.dump(mc, f, indent=4)
    try:
        def git(*args):
            return subprocess.run(
                ["git", *args], timeout=10, stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL,
                cwd=os.path.dirname(os.path.abspath(__file__)),
            ).stdout.decode().strip()

        info = {"branch": git("rev-parse", "--abbrev-ref", "HEAD"),
                "sha": git("rev-parse", "HEAD"),
                "is_dirty": bool(git("status", "--short"))}
        with open(os.path.join(log_dir, "git_info.json"), "w") as f:
            json.dump(info, f, indent=4)
    except Exception:  # git info is best-effort (the reference catches too)
        pass
