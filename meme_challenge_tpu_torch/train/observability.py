"""Scalar logging for ``--vis_path``.

Counterpart of ``ScalarWriter`` in ``meme_challenge_tpu/train/observability.py``
(reference utils/utils.py:25-60: Train/*, Validation/*,
Stats/time_per_train_iter, Stats/learning_rate, Stats/time_validation — the
same scalar names). Two sinks: ``scalars.jsonl`` always, and TensorBoard
where ``torch.utils.tensorboard`` imports (the reference's sink).
``profile_trace`` is the counterpart of JAX's ``profile_trace``: a
``torch.profiler`` trace of a block, left under a log directory. ``span``
names a range of the port's host work (``meme.*``) in such a trace.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import time
from typing import Iterable, Optional, Tuple

import torch

logger = logging.getLogger("meme_challenge_tpu_torch.observability")

try:
    _RecordFunctionFast = torch._C._profiler._RecordFunctionFast
except AttributeError:  # a torch without it: ranges are not recorded
    _RecordFunctionFast = None


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str):
    """A named range of host work, recorded while a ``torch.profiler`` is
    active (``profile_trace``, a benchmark's profiled slice) and nothing
    otherwise (≈ 0.5 µs a range): ``with span("meme.step"): ...``.

    The range is a FUNCTION-scope host event, on the profiler's clock and
    in its Chrome trace, nested under whatever range is open. It is not a
    ``record_function`` user annotation, since the profiler mirrors those
    onto the device's timeline as CUDA events, which a reader of the trace
    would take for kernels (launch counts, busy time). Where the installed
    torch lacks the fast record function, a range is a no-op."""
    if _RecordFunctionFast is None:
        return _NO_SPAN
    return _RecordFunctionFast(name)


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


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """torch.profiler trace around a block, written under ``log_dir`` as a
    Chrome trace (``trace_<pid>_<time>.json``); with CUDA activity when a
    card is there. A no-op, creating no directory, when ``log_dir`` is
    falsy."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, "trace_%d_%d.json" % (os.getpid(), time.time_ns())))
