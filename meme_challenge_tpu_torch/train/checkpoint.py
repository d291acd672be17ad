"""Checkpointing in the reference's torch format.

Counterpart of ``meme_challenge_tpu/train/checkpoint.py``. ``ModelSaver``
writes ``torch.save({'model_state_dict': sd})`` (reference utils/save.py:53-64)
— the format the JAX package's ``save_reference_checkpoint`` writes
(convert.py:516-524), so a checkpoint moves between the two packages and the
reference. Flax msgpack, the JAX ``ModelSaver``'s own format, cannot be read
without flax.
"""
from __future__ import annotations

import os

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

    def save(self, model: nn.Module) -> None:
        sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
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
