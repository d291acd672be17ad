"""Classification metrics (host-side, pure numpy).

Parity: reference data/metrics.py. Semantics preserved exactly:

- ``standard_metrics`` dispatches binary vs multiclass on the shape of probs
  (data/metrics.py:16-20).
- binary recall/precision clamp the denominator at 1e-4
  (data/metrics.py:40-41); F1 is 0.0 when either is 0.0.
- ``find_optimal_threshold`` sweeps 0.0, every predicted probability, and 1.0,
  then refines an interior argmax to the midpoint with the *next* threshold
  (data/metrics.py:113-126) — this midpoint rule is the bitwise-parity target
  for ensemble thresholds.
- ``aucroc`` warns + returns 0.0 when only one class is present
  (data/metrics.py:162-164).

A copy of ``meme_challenge_tpu/core/metrics.py`` (plain numpy), kept so
that the port imports nothing of the JAX package.
"""
from __future__ import annotations

import logging
from typing import Dict, Optional

import numpy as np

LOGGER = logging.getLogger("meme_challenge_tpu_torch.metrics")


def _as_numpy(x) -> np.ndarray:
    if isinstance(x, np.ndarray):
        return x
    if hasattr(x, "numpy"):  # torch tensors
        return x.detach().cpu().numpy() if hasattr(x, "detach") else x.numpy()
    return np.asarray(x)


def _tfpn(preds: np.ndarray, labels: np.ndarray, true_label: int) -> Dict[str, float]:
    """TP/TN/FP/FN counts for one class (reference get_TFPN_dict, metrics.py:83-95)."""
    is_pos = preds == true_label
    correct = preds == labels
    return {
        "TP": float(np.logical_and(is_pos, correct).sum()),
        "TN": float(np.logical_and(~is_pos, correct).sum()),
        "FP": float(np.logical_and(is_pos, ~correct).sum()),
        "FN": float(np.logical_and(~is_pos, ~correct).sum()),
    }


def standard_metrics(probs, labels, *args, **kwargs) -> Dict[str, float]:
    """Dispatch binary vs multiclass exactly like reference metrics.py:16-20."""
    probs = _as_numpy(probs)
    labels = _as_numpy(labels)
    if probs.ndim == 1 and np.all(np.logical_or(labels == 0, labels == 1)):
        return standard_metrics_binary(probs, labels, *args, **kwargs)
    return standard_metrics_multiclass(probs, labels, **kwargs)


def standard_metrics_binary(
    probs,
    labels,
    threshold: float = 0.5,
    add_aucroc: bool = True,
    add_optimal_acc: bool = False,
    **_kwargs,
) -> Dict[str, float]:
    probs = _as_numpy(probs).astype(np.float64)
    labels = _as_numpy(labels).astype(np.int64)
    assert np.all((probs <= 1.0) & (probs >= 0.0)), (
        "probabilities outside the [0, 1] range, but are as follows: %s" % probs
    )
    assert np.all((labels == 0) | (labels == 1)), (
        "expected binary labels, got values outside {0, 1}, but are as follows: %s" % labels
    )
    if np.all((probs == 0) | (probs == 1)):
        LOGGER.warning(
            "Standard metrics received discrete predictions as probabilities, "
            "but expects probabilities between 0.0 and 1.0."
        )

    preds = (probs > threshold).astype(np.int64)
    d = _tfpn(preds, labels, true_label=1)
    metrics: Dict[str, float] = {}
    metrics["accuracy"] = (d["TP"] + d["TN"]) / preds.shape[0]
    metrics["recall"] = d["TP"] / max(d["TP"] + d["FN"], 1e-4)
    metrics["precision"] = d["TP"] / max(d["TP"] + d["FP"], 1e-4)
    if metrics["recall"] == 0.0 or metrics["precision"] == 0.0:
        metrics["F1"] = 0.0
    else:
        metrics["F1"] = (
            2 * metrics["precision"] * metrics["recall"]
            / (metrics["precision"] + metrics["recall"])
        )

    if add_aucroc:
        metrics["aucroc"] = aucroc(probs, labels)

    if add_optimal_acc:
        opt_threshold = find_optimal_threshold(probs, labels, metric="accuracy")
        metrics["optimal_threshold"] = float(opt_threshold)
        metrics["optimal_accuracy"] = standard_metrics_binary(
            probs, labels, threshold=opt_threshold,
            add_aucroc=False, add_optimal_acc=False,
        )["accuracy"]

    return {k: float(v) for k, v in metrics.items()}


def standard_metrics_multiclass(probs, labels, **_kwargs) -> Dict[str, float]:
    probs = _as_numpy(probs)
    labels = _as_numpy(labels).astype(np.int64)
    assert probs.ndim == 2, "per-class probability columns are required here."
    preds = probs.argmax(axis=-1)
    per_class = [_tfpn(preds, labels, true_label=i) for i in range(probs.shape[1])]
    recalls = [d["TP"] / max(d["TP"] + d["FN"], 1e-4) for d in per_class]
    precisions = [d["TP"] / max(d["TP"] + d["FP"], 1e-4) for d in per_class]
    f1s = [
        (2 * r * p / (r + p)) if (r + p) > 0.0 else 0.0
        for r, p in zip(recalls, precisions)
    ]
    return {
        "accuracy": float((preds == labels).mean()),
        "recall": float(sum(recalls) / len(recalls)),
        "precision": float(sum(precisions) / len(precisions)),
        "F1": float(sum(f1s) / len(f1s)),
        "aucroc": -1.0,
        "optimal_threshold": -1.0,
        "optimal_accuracy": -1.0,
    }


def find_optimal_threshold(probs, labels, metric: str = "accuracy",
                           show_plot: bool = False) -> float:
    """Exhaustive threshold sweep with interior-midpoint refinement.

    Parity: reference metrics.py:98-148. Candidate thresholds are
    [0.0, sorted(probs)..., 1.0]; the best score's threshold is refined to the
    midpoint with the *following* candidate iff the argmax is interior.
    """
    del show_plot  # plotting is a host-tool concern; intentionally not supported
    probs = _as_numpy(probs).astype(np.float64)
    labels = _as_numpy(labels).astype(np.int64)

    base = standard_metrics(probs, labels)
    assert metric in base, (
        'Metric needs to be a key of the dict standard_metrics returns. '
        'Given metric: "%s", possible: "%s"' % (metric, list(base.keys()))
    )

    # Vectorized sweep (the reference loops in Python; identical scores).
    thresholds = np.concatenate([[0.0], np.sort(probs), [1.0]])
    # preds[i, j] = probs[j] > thresholds[i]
    preds = probs[None, :] > thresholds[:, None]
    lab = labels[None, :].astype(bool)
    tp = np.logical_and(preds, lab).sum(axis=1).astype(np.float64)
    tn = np.logical_and(~preds, ~lab).sum(axis=1).astype(np.float64)
    fp = np.logical_and(preds, ~lab).sum(axis=1).astype(np.float64)
    fn = np.logical_and(~preds, lab).sum(axis=1).astype(np.float64)
    if metric == "accuracy":
        scores = (tp + tn) / probs.shape[0]
    elif metric == "recall":
        scores = tp / np.maximum(tp + fn, 1e-4)
    elif metric == "precision":
        scores = tp / np.maximum(tp + fp, 1e-4)
    elif metric == "F1":
        recall = tp / np.maximum(tp + fn, 1e-4)
        precision = tp / np.maximum(tp + fp, 1e-4)
        scores = np.where(
            (recall == 0.0) | (precision == 0.0),
            0.0,
            2 * precision * recall / np.maximum(precision + recall, 1e-12),
        )
    else:
        # Fall back to the per-threshold metric dict for exotic metrics.
        scores = np.array([
            standard_metrics_binary(probs, labels, t, add_aucroc=False)[metric]
            for t in thresholds
        ])

    argmax = int(scores.argmax())
    if argmax != len(thresholds) - 1 and argmax != 0:
        best_threshold = (thresholds[argmax] + thresholds[argmax + 1]) / 2
    else:
        best_threshold = thresholds[argmax]

    reproduced = standard_metrics_binary(
        probs, labels, best_threshold, add_aucroc=False)[metric]
    if reproduced != scores[argmax]:
        LOGGER.warning(
            "threshold sweep self-check failed: re-scoring the selected "
            "threshold gave a different value (swept %f, re-scored %f)",
            scores[argmax], reproduced,
        )
    return float(best_threshold)


def aucroc(probs, labels) -> float:
    """Macro AUROC — the Hateful Memes Challenge metric.

    Parity: reference metrics.py:151-167 (sklearn ``roc_auc_score``,
    single-class guard returns 0.0). Implemented via tie-aware rank statistic
    (Mann-Whitney U), which equals the trapezoidal ROC integral exactly.
    """
    probs = _as_numpy(probs).astype(np.float64)
    labels = _as_numpy(labels).astype(np.int64)
    assert np.all((probs <= 1.0) & (probs >= 0.0)), "probabilities outside the [0, 1] range"
    assert np.all((labels == 0) | (labels == 1)), "expected binary labels, got values outside {0, 1}"
    if not (np.any(labels == 0) and np.any(labels == 1)):
        LOGGER.warning("AUROC is undefined with a single label class "
                       "present; reporting 0.")
        return 0.0
    return float(_rank_auc(probs, labels))


def _rank_auc(probs: np.ndarray, labels: np.ndarray) -> float:
    """AUROC via average ranks (exact, tie-aware)."""
    order = np.argsort(probs, kind="mergesort")
    sorted_p = probs[order]
    n = probs.shape[0]
    # Average rank of each tie group: mean of 1-based ranks [start+1 .. end].
    start = np.searchsorted(sorted_p, sorted_p, side="left")
    end = np.searchsorted(sorted_p, sorted_p, side="right")
    avg_rank_sorted = (start + end + 1) / 2.0
    ranks = np.empty(n, dtype=np.float64)
    ranks[order] = avg_rank_sorted
    n_pos = int(labels.sum())
    n_neg = n - n_pos
    pos_rank_sum = ranks[labels == 1].sum()
    return (pos_rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)
