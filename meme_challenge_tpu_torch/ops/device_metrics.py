"""Batched metrics on the device for the ensemble weight search.

Counterpart of ``meme_challenge_tpu/ops/device_metrics.py``: the tie-aware
rank AUROC and the masked mixing of fold predictions, as torch operations
over a whole candidate population at once (``[K, N]`` tensors, the batch on
the first axis). They were plain ``jnp`` in the JAX package, never Pallas,
and stay plain torch here. All math is fp32, as there.

``auroc_batched`` uses average ranks, which equals sklearn's trapezoidal
``roc_auc_score`` exactly (the statistic of ``core/metrics.py:_rank_auc``).
The ranks are half-integers and their sums stay below 2²⁴, so every sum is
exact in fp32 whatever the order of summation: a score depends only on the
order of the mixed predictions.
"""
from __future__ import annotations

import torch


def _ranks(probs: torch.Tensor) -> torch.Tensor:
    """Average 1-based ranks along the last axis, ties shared.

    For the sorted row, ``start[i]`` is the first index of i's tie run (a
    running max over the run starts) and ``end[i]`` the last (a running min
    from the right over the run ends, through ``flip``); the run's average
    rank is ``(start + end) / 2 + 1``."""
    n = probs.shape[-1]
    sorted_p, order = torch.sort(probs, dim=-1)
    idx = torch.arange(n, device=probs.device).expand_as(order)
    differs = sorted_p[..., 1:] != sorted_p[..., :-1]
    edge = torch.ones_like(differs[..., :1])
    is_start = torch.cat([edge, differs], dim=-1)
    is_end = torch.cat([differs, edge], dim=-1)
    start = torch.cummax(torch.where(is_start, idx, 0), dim=-1).values
    end = torch.cummin(torch.where(is_end, idx, n - 1).flip(-1),
                       dim=-1).values.flip(-1)
    avg_sorted = (start + end).float() * 0.5 + 1.0
    return torch.empty_like(avg_sorted).scatter_(-1, order, avg_sorted)


def auroc_batched(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Exact AUROC of each row of ``probs`` ``[K, N]`` against ``labels``
    ``[N]`` (0/1); returns ``[K]`` fp32."""
    ranks = _ranks(probs.float())
    labels = labels.float()
    n_pos = labels.sum()
    n_neg = labels.shape[0] - n_pos
    pos_rank_sum = (ranks * labels).sum(dim=-1)
    return (pos_rank_sum - n_pos * (n_pos + 1) * 0.5) / (n_pos * n_neg)


def auroc(probs: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Exact AUROC of one prediction vector ``[N]`` (a 0-d fp32 tensor)."""
    return auroc_batched(probs[None], labels)[0]


def ensemble_prediction(predictions: torch.Tensor, weights: torch.Tensor,
                        on_logits: bool) -> torch.Tensor:
    """Masked weighted mixing of fold predictions.

    Semantics of reference create_ensemble_prediction (utils/ensemble.py:
    157-177): −1 marks a missing prediction (masked out, placeholder 0.5);
    logit-space mixing clips probabilities to [1e-8, 1]; the summed weight
    of each column is clipped to [1e-4, 1e5], and a column whose weights are
    all zero gives 0.5.

    predictions: ``[F, N]`` probabilities; weights: ``[F]`` or ``[K, F]``.
    Returns ``[N]`` or ``[K, N]``."""
    predictions = predictions.float()
    inv = predictions == -1
    preds = torch.where(inv, 0.5, predictions)
    mask = 1.0 - inv.float()
    if on_logits:
        preds = (torch.log(preds.clamp(1e-8, 1.0))
                 - torch.log((1.0 - preds).clamp(1e-8, 1.0)))
    w = weights.float()[..., None]                       # [..., F, 1]
    w_per = (w * mask).sum(dim=-2)                       # [..., N]
    out = (w * preds * mask).sum(dim=-2) / w_per.clamp(1e-4, 1e5)
    out = torch.where(w_per == 0.0, 0.5, out)
    if on_logits:
        out = torch.sigmoid(out)
    return out


def ensemble_scores(predictions: torch.Tensor, weight_pop: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """AUROC of each candidate weight vector in both mixing spaces.

    predictions: ``[F, N]``; weight_pop: ``[K, F]``; labels: ``[N]``.
    Returns ``[2, K]``: row 0 the logit-space scores, row 1 prob-space."""
    return torch.stack([
        auroc_batched(ensemble_prediction(predictions, weight_pop, True),
                      labels),
        auroc_batched(ensemble_prediction(predictions, weight_pop, False),
                      labels)])


def ensemble_scores_logit(predictions: torch.Tensor,
                          weight_pop: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Logit-space scores only, ``[K]``: the EA's fitness (it never mixes
    in probability space)."""
    return auroc_batched(ensemble_prediction(predictions, weight_pop, True),
                         labels)
