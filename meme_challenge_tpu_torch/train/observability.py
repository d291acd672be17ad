"""Scalar logging for ``--vis_path``.

Counterpart of ``ScalarWriter`` in ``meme_challenge_tpu/train/observability.py``
(reference utils/utils.py:25-60: Train/*, Validation/*,
Stats/time_per_train_iter, Stats/learning_rate, Stats/time_validation — the
same scalar names). Two sinks: ``scalars.jsonl`` always, and TensorBoard
where ``torch.utils.tensorboard`` imports (the reference's sink).
"""
from __future__ import annotations

import json
import logging
import os
import time
from typing import Iterable, Tuple

logger = logging.getLogger("meme_challenge_tpu_torch.observability")


class ScalarWriter:
    """Fan-out scalar writer (TensorBoard + JSONL)."""

    def __init__(self, log_dir: str, use_tensorboard: bool = True):
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except Exception as e:  # tensorboard is optional
                logger.info("TensorBoard writer unavailable (%s); "
                            "JSONL only.", e)

    def add_scalar(self, name: str, value: float, step: int) -> None:
        self._jsonl.write(json.dumps(
            {"name": name, "value": float(value), "step": int(step),
             "ts": time.time()}) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(name, value, step)

    def add_scalars(self, triples: Iterable[Tuple[str, int, float]]) -> None:
        for name, step, value in triples:
            self.add_scalar(name, value, step)

    def flush(self) -> None:
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        self.flush()
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
