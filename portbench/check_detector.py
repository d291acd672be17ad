"""The comparison that decides ``correct`` in the detector cell.

Of the run's first optimizer steps against the reference's
(``reference/detector.py``), the same images on the same draws from the
same weights:

- ``loss_gap``: the largest gap of any of the five losses in any step,
  relative to the reference's;
- ``label_gap``: the anchors and proposals of the first step whose label
  (anchor: positive, negative, ignored; proposal: class or background) or
  whose being sampled differs. Labels and samples depend on the boxes and
  the draws alone, never on the weights, so the limit is 0;
- ``grad_gap`` and ``delta_gap``: as the fine-tune cells'
  (:func:`check.leaf_gap` over :func:`check.counted_leaves`), of the first
  gradient as the optimizer took it (the momentum trace after one step)
  and of each leaf's change over the steps.

``limits/<cell>.json`` holds the limits; PERF.md gives the readings each
was set from.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from portbench.check import counted_leaves, leaf_gap
from portbench.reference.detector import DECISION_KEYS


def compare(got: dict, want: dict) -> Dict[str, float]:
    """``got`` / ``want``: ``loss`` [steps, 5], the four decision arrays
    of :data:`DECISION_KEYS`, ``grad`` and ``delta`` (leaf → norm)."""
    loss = np.abs(got["loss"] - want["loss"]) / np.maximum(
        np.abs(want["loss"]), 1e-30)
    labels = sum(int((np.asarray(got[k]) != np.asarray(want[k])).sum())
                 for k in DECISION_KEYS)
    leaves = counted_leaves(want["grad"])
    return {"loss_gap": float(loss.max()), "label_gap": float(labels),
            "grad_gap": leaf_gap(got["grad"], want["grad"], leaves),
            "delta_gap": leaf_gap(got["delta"], want["delta"], leaves)}
