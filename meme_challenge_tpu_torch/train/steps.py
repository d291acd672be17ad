"""Eval steps.

Counterpart of the eval half of ``meme_challenge_tpu/train/steps.py``; the
train steps come with the training slice (ROADMAP.md).

- Host batches stay numpy until :func:`to_device`, the trainer boundary:
  model inputs become tensors on the device there, ``img_feat`` still fp16 as
  stored (the model upcasts it).
- ``gather_micro`` assembles a micro-batch on the device from the whole
  dataset's device-resident arrays plus a batch of indices
  (``--device_resident_data``).
- :class:`EvalPipeline` keeps each batch's probabilities on the device and
  fetches them once per pass, or oldest-first beyond a window. CUDA runs a
  stream's work in order, so the JAX package's chain token is not needed.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

# batch keys the model reads; everything else (ids, labels, sample_mask)
# stays on the host
MODEL_INPUT_KEYS = ("input_ids", "position_ids", "txt_mask", "img_feat",
                    "img_pos_feat", "img_mask")


def to_device(arrays: Dict[str, np.ndarray], device,
              keys=MODEL_INPUT_KEYS) -> Dict[str, torch.Tensor]:
    """Numpy arrays of ``keys`` (those present) → tensors on ``device``,
    dtypes as stored."""
    return {k: torch.from_numpy(np.ascontiguousarray(arrays[k])).to(device)
            for k in keys if k in arrays and arrays[k] is not None}


def gather_micro(data: Dict[str, torch.Tensor],
                 micro_batch: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """Assemble a micro-batch ON DEVICE from full-dataset arrays + indices.

    All non-``indices`` keys of the micro-batch overlay the gathered arrays.
    """
    idx = micro_batch["indices"].long()
    out = {k: v.index_select(0, idx) for k, v in data.items()}
    for k, v in micro_batch.items():
        if k != "indices":
            out[k] = v
    return out


def make_eval_step(model_apply_eval: Callable, probs_fn: Callable,
                   gather_data: bool = False):
    """Eval step: device batch → probabilities on the device.

    ``model_apply_eval(batch)`` → logits; ``probs_fn(logits)`` →
    probabilities (sigmoid / softmax per loss mode). ``gather_data=True``:
    the step takes ``data`` and the batch carries ``indices``
    (device-resident pipeline)."""

    def eval_step(batch, data=None):
        with torch.inference_mode():
            if gather_data:
                batch = gather_micro(data, batch)
            return probs_fn(model_apply_eval(batch))

    return eval_step


def sigmoid_probs(logits: torch.Tensor) -> torch.Tensor:
    """BCE heads: sigmoid of ``logits[:, 0]`` in fp32 (trainer.py:155-157)."""
    return torch.sigmoid(logits.reshape(logits.shape[0], -1)[:, 0].float())


def softmax_probs(logits: torch.Tensor) -> torch.Tensor:
    """CE heads: fp32 softmax over classes (trainer.py:153-154)."""
    return torch.softmax(logits.float(), dim=-1)


def fetch_all(pending: list) -> list:
    """Drain a pass's in-flight results at one host sync point."""
    return [p.cpu().numpy() for p in pending]


# in-flight depth for eval passes over HOST-BATCH loaders (each pending
# batch holds device work the host has raced ahead of); index-mode loaders
# upload a few hundred bytes a batch and stay unbounded
EVAL_INFLIGHT_WINDOW = 8


class EvalPipeline:
    """Eval results with a bounded in-flight window.

    ``add`` keeps one batch's device output; once more than ``window`` are
    in flight, the OLDEST is fetched. ``window=None`` disables the bound.
    ``results`` drains the tail and returns every output in add-order.
    """

    def __init__(self, window: Optional[int] = EVAL_INFLIGHT_WINDOW):
        self._window = window
        self._pending: list = []
        self._done: list = []

    def add(self, out: torch.Tensor) -> None:
        self._pending.append(out)
        if (self._window is not None
                and len(self._pending) > self._window):
            self._done.append(self._pending.pop(0).cpu().numpy())

    def results(self) -> list:
        return self._done + fetch_all(self._pending)
