"""Loss functions for the trainer.

Counterpart of ``meme_challenge_tpu/train/losses.py`` (reference
train_template.py:64-69 + 95-126): ``bce`` / ``bce_logits`` (+``pos_wt``
positive-class reweighting, torch ``BCEWithLogitsLoss(pos_weight=...)``
semantics) / ``ce``. All losses are masked means over the valid samples of a
(possibly padded) static batch, with the denominator ``max(Σmask, 1)``.
Leading axes (a fold axis, an accumulation axis) are kept: labels and mask
``[..., B]`` give one loss per row, ``[...]``.

``denominator`` (``[...]``, default ``Σmask`` of the rows given) lets a rank
that holds some rows of a batch take its share of the whole batch's masked
mean: the ranks' losses over their rows, each divided by the whole batch's
``max(Σmask, 1)``, sum to the one-process loss (a ``data`` mesh axis,
``train/steps.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _masked_mean(per_sample: torch.Tensor, sample_mask: torch.Tensor,
                 denominator: Optional[torch.Tensor] = None) -> torch.Tensor:
    m = sample_mask.float()
    den = m.sum(-1) if denominator is None else denominator
    return (per_sample * m).sum(-1) / torch.clamp_min(den, 1.0)


def bce_logits_loss(logits: torch.Tensor, labels: torch.Tensor,
                    sample_mask: torch.Tensor, pos_weight: float = 1.0,
                    denominator: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted binary cross-entropy on logits,
    ``-[w·y·log σ(x) + (1−y)·log(1−σ(x))]``, in the stable log-sigmoid form.
    Returns (masked mean loss, probabilities)."""
    x = logits.reshape(labels.shape).float()
    y = labels.float()
    per = -(pos_weight * y * F.logsigmoid(x) + (1.0 - y) * F.logsigmoid(-x))
    return _masked_mean(per, sample_mask, denominator), torch.sigmoid(x)


def bce_loss(logits: torch.Tensor, labels: torch.Tensor,
             sample_mask: torch.Tensor,
             denominator: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reference 'bce' mode (sigmoid, then BCE): unweighted bce_logits in the
    stable form."""
    return bce_logits_loss(logits, labels, sample_mask, pos_weight=1.0,
                           denominator=denominator)


def ce_loss(logits: torch.Tensor, labels: torch.Tensor,
            sample_mask: torch.Tensor,
            denominator: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy over n_classes logits. Returns (loss, softmax probs)."""
    logits = logits.float()
    logp = F.log_softmax(logits, dim=-1)
    per = -logp.gather(-1, labels.long()[..., None])[..., 0]
    return (_masked_mean(per, sample_mask, denominator),
            torch.softmax(logits, dim=-1))


def make_loss_fn(loss_func: str, pos_wt: float = 1.0):
    """Dispatch matching reference train_template.py:64-69."""
    if loss_func == "bce_logits":
        return lambda logits, labels, mask, denominator=None: bce_logits_loss(
            logits, labels, mask, pos_weight=pos_wt, denominator=denominator)
    if loss_func == "bce":
        return bce_loss
    if loss_func == "ce":
        return ce_loss
    raise ValueError(f"unknown loss_func: {loss_func}")
