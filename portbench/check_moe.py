"""The comparison that decides ``correct`` in the Moonlight cell.

Of the run's first optimizer steps against the reference's
(``reference/moe_mla.py``), the same host batches on the same dropout
draws from the same weights. Where a router's 6th and 7th scores (with
the correction bias) lie at most ``ROUTE_MARGIN`` apart in the reference,
rounding may pick either, and one token's other pick moves its meme's
loss, probability and the steps' gradients by far more than rounding: the
reference there takes the program's picks, in every checked step and
micro-batch, and its own everywhere else.

- ``loss_gap``, ``prob_gap``, ``grad_gap`` and ``delta_gap``: as the
  fine-tune cells' (:func:`check.compare_train`), the first gradient as
  AdamW took it (the first moment after one step over ``1 − β1``);
- ``route_gap``: the valid tokens of the first micro-batch whose set of
  picked experts (all 64, held or not) differs from the one the reference
  picks by its own scores (no tie decided by the program's), among those
  whose 6th and 7th router scores (with the correction bias) lie
  more than ``ROUTE_MARGIN`` apart in the reference, in each meme's first
  expert layer where any of its tokens' picks differ. A pick within the
  margin may flip on rounding; one outside it may not, so the limit is 0.
  Later layers of that meme are left out: a flip within the margin changes
  the token's state (a held expert's part, or the weights' normalisation),
  attention carries it to the meme's later tokens, and their picks may
  then differ by any margin.

``limits/<cell>.json`` holds the limits; PERF.md gives the readings each
was set from.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from portbench.check import compare_train

# scores are sigmoids in (0, 1); the program's and the reference's agree to
# ~1e-6 through 27 layers at float32, so 1e-4 leaves a hundredfold room
ROUTE_MARGIN = 1e-4


def route_gap(got_sets: np.ndarray, want_sets: np.ndarray,
              margins: np.ndarray, rows: np.ndarray) -> float:
    """``[layers, tokens, experts]`` pick sets, ``[layers, tokens]``
    margins and each token's meme ``[tokens]``."""
    differs = (got_sets != want_sets).any(-1)
    layers = differs.shape[0]
    first = np.full(int(rows.max()) + 1 if rows.size else 0, layers)
    for layer in range(layers - 1, -1, -1):
        first[rows[differs[layer]]] = layer
    at_first = np.arange(layers)[:, None] == first[rows][None, :]
    return float((differs & at_first & (margins > ROUTE_MARGIN)).sum())


def compare(got: dict, want: dict, mask: np.ndarray) -> Dict[str, float]:
    out = compare_train(got, want, mask)
    out["route_gap"] = route_gap(got["pick_sets"], want["pick_sets"],
                                 want["margins"], want["rows"])
    return out
