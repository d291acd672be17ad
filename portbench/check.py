"""The comparison that decides ``correct``.

Training (:func:`compare_train`), of the run's first optimizer steps
against the reference's:

- ``loss_gap``: the largest gap of a micro-batch's loss, relative to the
  reference's;
- ``prob_gap``: the largest gap of a valid meme's probability;
- ``grad_gap``: by the worst leaf, the gap between the norms of the first
  gradient as the optimizer got it, over the larger of the reference's
  norm of that leaf and of the median leaf;
- ``delta_gap``: the same of each leaf's change over the steps.

Leaves whose first gradient in the reference is under a thousandth of the
median leaf's (a key's bias under softmax, a table no input reached) move
by round-off and decay alone and are left out of both leaf gaps.

Scoring (:func:`compare_scores`): ``prob_gap``, the largest gap of a
probability over every answer the window gave; an answer missing is a gap
of 1.

Each cell's limits are in ``limits/<cell>.json``; PERF.md gives the
readings each was set from.
"""
from __future__ import annotations

import json
import os
import statistics
from typing import Dict, List

import numpy as np

LIMITS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "limits")
QUIET_LEAF = 1e-3


def limits(cell: str, directory: str = LIMITS_DIR) -> Dict[str, float]:
    with open(os.path.join(directory, cell + ".json")) as f:
        return {k: float(v) for k, v in json.load(f).items()
                if not k.startswith("_")}


def counted_leaves(ref_grad: Dict[str, float]) -> List[str]:
    med = statistics.median(ref_grad.values())
    return [n for n, g in ref_grad.items() if g >= QUIET_LEAF * med]


def leaf_gap(got: Dict[str, float], want: Dict[str, float],
             leaves: List[str]) -> float:
    med = statistics.median(want[n] for n in leaves)
    return max(abs(got[n] - want[n]) / max(want[n], med) for n in leaves)


def compare_train(got: dict, want: dict, mask: np.ndarray) -> Dict[str, float]:
    """``got`` / ``want``: ``loss`` ``[steps, accum]``, ``probs``
    ``[steps, accum, B]``, ``grad`` and ``delta`` (leaf → norm); ``mask``
    ``[steps, accum, B]`` the valid memes."""
    valid = mask.astype(bool)
    has = valid.any(-1)
    loss = np.abs(got["loss"] - want["loss"]) / np.abs(want["loss"])
    probs = np.abs(got["probs"].reshape(mask.shape)
                   - want["probs"].reshape(mask.shape))
    leaves = counted_leaves(want["grad"])
    return {"loss_gap": float(loss[has].max()),
            "prob_gap": float(probs[valid].max()),
            "grad_gap": leaf_gap(got["grad"], want["grad"], leaves),
            "delta_gap": leaf_gap(got["delta"], want["delta"], leaves)}


def compare_scores(passes: List[tuple], want: Dict[int, float]) -> tuple:
    """``passes``: per scoring pass ``(probs, ids)`` as the program gave
    them; ``want``: id → the reference's probability. Returns
    ({"prob_gap": worst}, per-answer gaps)."""
    gaps = []
    for probs, ids in passes:
        seen = dict(zip((int(i) for i in ids), np.asarray(probs, float)))
        gaps += [abs(seen[i] - p) if i in seen else 1.0
                 for i, p in want.items()]
    return {"prob_gap": float(max(gaps)) if gaps else 1.0}, np.asarray(gaps)
