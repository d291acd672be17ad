"""Detector training: anchor/proposal matching, the Faster R-CNN losses and
the train step (torch).

The port of ``meme_challenge_tpu/extract/detector_train.py``. Capability
parity with the reference's detector training path
(bottom-up-attention.pytorch/train_net.py via detectron2 DefaultTrainer):
RPN objectness + box-regression losses over matched anchors, ROI-head
classification + box-regression (+ attribute) losses over sampled
proposals, with the config's sampling hyperparameters
(RPN.BATCH_SIZE_PER_IMAGE 64, ROI_HEADS.BATCH_SIZE_PER_IMAGE 64,
POSITIVE_FRACTION 0.5, configs/bua-caffe/*.yaml).

Matching and sampling keep the JAX package's static shapes (thresholds
over sorted scores, no dynamic index sets), so a step issues no host sync:
its losses stay on the device until the caller reads them.

The step trains every parameter of the detector: each FrozenBN weight and
bias and the stem too (327 tensors at ``DetectorConfig()``), as the JAX
step's ``value_and_grad`` over the whole tree does. The reference's
detectron2 recipe freezes them (FREEZE_AT 3); neither package does.

Repeatability: on a card, cuDNN's default backward algorithms for the
convolutions (``dgrad_engine``, ``wgrad_alg0_engine``) accumulate in an
order that changes from run to run, so two identical gradient passes gave
different bits. The step's gradient pass runs under
:func:`deterministic_cudnn` (cuDNN's deterministic algorithms, no
autotuning), scoped to the pass: other paths of the process keep their
algorithms. ROIAlign's backward (autograd's sorted
``index_put_(accumulate=True)``) repeats as it is.

Randomness: where JAX draws from ``jax.random.split(rng, 3)``, the step
draws from an explicit ``torch.Generator`` on its device, in JAX's order:
the RPN sampling uniforms (one per anchor), the ROI sampling uniforms (one
per proposal), the proposal jitter ``[P, 4]`` in ``[-jitter, jitter)``.
:meth:`DetectorTrainStep.step_with_draws` takes those three tensors as
given, so a step can be held to JAX's value for value on JAX's own draws.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Tuple

import numpy as np
import torch
from torch.nn import functional as F

from meme_challenge_tpu_torch.extract.detector import (
    DetectorConfig,
    make_anchors,
)
from meme_challenge_tpu_torch.extract.ops import roi_align
from meme_challenge_tpu_torch.ops.iou import pairwise_iou

Tensor = torch.Tensor


def encode_boxes(anchors: Tensor, targets: Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0)) -> Tensor:
    """Inverse of decode_boxes: gt boxes → regression deltas."""
    wx, wy, ww, wh = weights
    aw = anchors[:, 2] - anchors[:, 0]
    ah = anchors[:, 3] - anchors[:, 1]
    acx = anchors[:, 0] + 0.5 * aw
    acy = anchors[:, 1] + 0.5 * ah
    tw = targets[:, 2] - targets[:, 0]
    th = targets[:, 3] - targets[:, 1]
    tcx = targets[:, 0] + 0.5 * tw
    tcy = targets[:, 1] + 0.5 * th
    aw_, ah_ = aw.clamp(min=1e-6), ah.clamp(min=1e-6)
    return torch.stack([
        wx * (tcx - acx) / aw_,
        wy * (tcy - acy) / ah_,
        ww * torch.log(tw.clamp(min=1e-6) / aw_),
        wh * torch.log(th.clamp(min=1e-6) / ah_),
    ], dim=1)


def _best_match(boxes: Tensor, gt_boxes: Tensor, gt_mask: Tensor
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """(IoU [N, G] with the padding rows at −1, best gt index [N] (the first
    on a tie, as ``jnp.argmax``), best IoU [N])."""
    iou = pairwise_iou(boxes, gt_boxes, zero_union="eps")
    iou = torch.where(gt_mask[None, :], iou, -1.0)
    return iou, torch.argmax(iou, dim=1), torch.amax(iou, dim=1)


def match_anchors(anchors: Tensor, gt_boxes: Tensor, gt_mask: Tensor,
                  pos_iou: float = 0.7, neg_iou: float = 0.3
                  ) -> Tuple[Tensor, Tensor]:
    """RPN anchor matching (detectron2 Matcher + low-quality matches).

    Returns (labels [N] ∈ {1 pos, 0 neg, −1 ignore}, matched_gt_idx [N]).
    ``gt_mask`` flags valid rows of the (padded, static-size) gt array.
    """
    iou, best_gt, best_iou = _best_match(anchors, gt_boxes, gt_mask)
    labels = torch.where(best_iou >= pos_iou, 1,
                         torch.where(best_iou < neg_iou, 0, -1))
    # low-quality matches: each gt's best anchor becomes positive
    best_anchor_per_gt = torch.amax(iou, dim=0)                 # [G]
    is_best = ((iou == best_anchor_per_gt[None, :]) & gt_mask[None, :]
               & (best_anchor_per_gt[None, :] > 0))
    return torch.where(is_best.any(dim=1), 1, labels), best_gt


def subsample_labels(labels: Tensor, uniform: Tensor, batch_size: int = 64,
                     positive_fraction: float = 0.5) -> Tensor:
    """Static-size sampling of pos/neg anchors (detectron2
    subsample_labels) on the given uniforms [N] (JAX draws them inside
    from its key): per-anchor weights {0,1} with at most ``batch_size``
    ones, ~positive_fraction positive.

    JAX reads the positive threshold at the static index ``num_pos − 1``,
    which XLA clamps to the last element when fewer than ``num_pos``
    labels exist; the index is clamped here explicitly."""
    n = labels.shape[0]
    num_pos = int(batch_size * positive_fraction)
    pos_score = torch.where(labels == 1, uniform, -1.0)
    neg_score = torch.where(labels == 0, uniform, -1.0)
    pos_thresh = torch.sort(pos_score, descending=True).values[
        min(num_pos, n) - 1]
    chosen_pos = (labels == 1) & (pos_score >= pos_thresh.clamp(min=0.0))
    n_pos = torch.clamp((labels == 1).sum(), max=num_pos)
    num_neg = batch_size - n_pos
    neg_sorted = torch.sort(neg_score, descending=True).values
    # a device index: no host sync
    neg_thresh = neg_sorted.gather(0, (num_neg - 1).clamp(0, n - 1).view(1))
    chosen_neg = (labels == 0) & (neg_score >= neg_thresh.clamp(min=0.0))
    return (chosen_pos | chosen_neg).to(torch.float32)


def smooth_l1(x: Tensor, beta: float = 1.0 / 9) -> Tensor:
    ax = torch.abs(x)
    return torch.where(ax < beta, 0.5 * x * x / beta, ax - 0.5 * beta)


def optree_bce(logits: Tensor, targets: Tensor, weights: Tensor) -> Tensor:
    log_p = F.logsigmoid(logits)
    log_np = F.logsigmoid(-logits)
    per = -(targets * log_p + (1 - targets) * log_np)
    return torch.sum(per * weights) / torch.sum(weights).clamp(min=1.0)


def rpn_losses(anchors: Tensor, objectness: Tensor, deltas: Tensor,
               gt_boxes: Tensor, gt_mask: Tensor, uniform: Tensor,
               batch_size: int = 64, positive_fraction: float = 0.5
               ) -> Dict[str, Tensor]:
    """RPN objectness BCE + box smooth-L1 over sampled anchors."""
    labels, matched = match_anchors(anchors, gt_boxes, gt_mask)
    weights = subsample_labels(labels, uniform, batch_size,
                               positive_fraction)
    targets = encode_boxes(anchors, gt_boxes[matched])
    y = (labels == 1).to(torch.float32)
    pos = y * weights
    obj_loss = optree_bce(objectness, y, weights)
    box_loss = torch.sum(smooth_l1(deltas - targets).sum(-1) * pos
                         ) / torch.sum(weights).clamp(min=1.0)
    return {"rpn_objectness": obj_loss, "rpn_box": box_loss}


def roi_labels(proposals: Tensor, gt_boxes: Tensor, gt_classes: Tensor,
               gt_mask: Tensor, fg_iou: float = 0.5
               ) -> Tuple[Tensor, Tensor, Tensor]:
    """(class labels [P], 1-based with background 0; foreground [P]; best gt
    index [P]) of the proposals. vg_data emits 0-BASED foreground classes;
    the 1601-way head reserves column 0 for background, so they shift by +1
    to match how extraction and evaluation decode predictions
    (cls_prob[:, 1:].argmax -> class k-1)."""
    _, best_gt, best_iou = _best_match(proposals, gt_boxes, gt_mask)
    fg = best_iou >= fg_iou
    labels = torch.where(fg, gt_classes[best_gt].long() + 1, 0)
    return labels, fg, best_gt


def roi_losses(proposals: Tensor, cls_logits: Tensor, bbox_deltas: Tensor,
               attr_logits: Tensor, gt_boxes: Tensor, gt_classes: Tensor,
               gt_attrs: Tensor, gt_mask: Tensor, uniform: Tensor,
               batch_size: int = 64, positive_fraction: float = 0.5,
               fg_iou: float = 0.5) -> Dict[str, Tensor]:
    """ROI-head losses: softmax CE over the classes (background = 0 for
    unmatched), per-class box smooth-L1 on foreground, attribute CE on
    foreground with attribute annotations; proposals sampled on the given
    uniforms [P]."""
    labels, fg, best_gt = roi_labels(proposals, gt_boxes, gt_classes,
                                     gt_mask, fg_iou)
    weights = subsample_labels(fg.long(), uniform, batch_size,
                               positive_fraction)
    denom = torch.sum(weights).clamp(min=1.0)
    # classification
    logp = F.log_softmax(cls_logits.float(), dim=-1)
    cls_loss = -torch.sum(logp.gather(1, labels[:, None])[:, 0] * weights
                          ) / denom
    # per-class box regression on fg
    n, c4 = bbox_deltas.shape
    picked = bbox_deltas.reshape(n, c4 // 4, 4).gather(
        1, labels[:, None, None].expand(n, 1, 4))[:, 0]
    targets = encode_boxes(proposals, gt_boxes[best_gt])
    fg_w = fg.to(torch.float32) * weights
    box_loss = torch.sum(smooth_l1(picked - targets).sum(-1) * fg_w) / denom
    # attributes on fg with annotations (gt_attrs −1 = none). Same +1
    # shift: the attribute head reserves column 0 for "no attribute" and
    # the decoders read attr_prob[:, 1:].argmax -> attribute j-1
    attr_target = gt_attrs[best_gt].long()
    has_attr = (attr_target >= 0) & fg
    safe_attr = torch.where(has_attr, attr_target + 1, 0)
    alogp = F.log_softmax(attr_logits.float(), dim=-1)
    attr_w = has_attr.to(torch.float32) * weights
    attr_loss = -torch.sum(alogp.gather(1, safe_attr[:, None])[:, 0]
                           * attr_w) / torch.sum(attr_w).clamp(min=1.0)
    return {"roi_cls": cls_loss, "roi_box": box_loss, "roi_attr": attr_loss}


def _log_prob(prob: Tensor) -> Tensor:
    """``log(clip(prob, 1e-9, 1))``: the losses take the heads' softmax
    outputs back to logits, as the JAX step does."""
    return torch.log(prob.clamp(1e-9, 1.0))


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN's deterministic algorithms, and no autotuning, inside the
    block; the process's previous settings are restored after it."""
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        yield
    finally:
        cudnn.deterministic, cudnn.benchmark = saved


class DetectorTrainStep:
    """The full detector train step: backbone + RPN losses, the static
    proposal set, ROIAlign on res4, the ROI heads and their losses, and one
    optimizer update of every parameter of ``model``.

    ``model``: a ``BUADetector`` on the step's device. ``optimizer``: a
    ``train.optim.Optimizer`` (its state lives here, ``opt_state``).

    batch: {"images" [1, H, W, 3] (the NHWC blob of ``vg_data``),
    "gt_boxes" [G, 4], "gt_classes" [G], "gt_attrs" [G] (−1 = none),
    "gt_mask" [G] bool}, numpy arrays or tensors.

    TPU-era simplifications kept from the JAX step:
    - ROI-head training proposals are the (padded, static-count)
      ground-truth boxes plus jittered copies, instead of NMS-filtered RPN
      proposals (detectron2 also appends gt to the sampled proposals); the
      RPN still trains on its own losses.
    - ROI pooling inside the step is the differentiable ROIAlign
      (extract/ops.py) rather than the Caffe ROIPool of extraction.
    """

    def __init__(self, model, cfg: DetectorConfig, optimizer,
                 num_proposals: int = 64, jitter: float = 0.1):
        self.model, self.cfg, self.optimizer = model, cfg, optimizer
        self.num_proposals, self.jitter = num_proposals, jitter
        self.num_anchors = len(cfg.anchor_scales) * len(cfg.anchor_ratios)
        self.params = dict(model.named_parameters())
        self.device = next(iter(self.params.values())).device
        self.opt_state = optimizer.init(
            {n: p.detach() for n, p in self.params.items()})
        self._anchors = {}

    # ------------------------------------------------------------ inputs

    def _upload(self, value) -> Tensor:
        """A host array or tensor on the step's device; from the host
        through pinned memory without a host sync."""
        t = torch.as_tensor(value)
        if t.device == self.device:
            return t
        if self.device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def anchors(self, feat_h: int, feat_w: int) -> Tensor:
        """The dense anchors of a ``feat_h`` × ``feat_w`` map on the device,
        made once a map size."""
        key = (feat_h, feat_w)
        if key not in self._anchors:
            self._anchors[key] = self._upload(torch.from_numpy(
                make_anchors(self.cfg, feat_h, feat_w)))
        return self._anchors[key]

    def draw(self, n_anchors: int, generator: torch.Generator
             ) -> Tuple[Tensor, Tensor, Tensor]:
        """The step's three streams, in JAX's order: RPN uniforms [N], ROI
        uniforms [P], jitter [P, 4] in [−jitter, jitter)."""
        P, dev = self.num_proposals, self.device
        rpn = torch.rand(n_anchors, generator=generator, device=dev)
        roi = torch.rand(P, generator=generator, device=dev)
        noise = torch.rand((P, 4), generator=generator, device=dev)
        return rpn, roi, noise * (2.0 * self.jitter) - self.jitter

    # ------------------------------------------------------------- losses

    def losses(self, batch, draws, aux: bool = False):
        """The five losses of ``batch`` (differentiable). ``draws``: a
        ``torch.Generator`` on the step's device, or the three tensors of
        :meth:`draw`. With ``aux``, also the decisions the losses took
        (anchor labels, proposal labels, the heads' probabilities)."""
        cfg, A, P = self.cfg, self.num_anchors, self.num_proposals
        images = self._upload(batch["images"]).permute(0, 3, 1, 2)
        gt_boxes = self._upload(batch["gt_boxes"])
        gt_classes = self._upload(batch["gt_classes"])
        gt_attrs = self._upload(batch["gt_attrs"])
        gt_mask = self._upload(batch["gt_mask"])
        feat, logits, deltas = self.model.backbone_rpn(
            images.float().contiguous())
        fh, fw = feat.shape[2], feat.shape[3]
        anchors = self.anchors(fh, fw)
        # NHWC, the order of make_anchors (FeatureExtractor._backbone_rpn)
        logits = logits.permute(0, 2, 3, 1)[0]
        fg_logit = (logits[..., A:] - logits[..., :A]).reshape(-1)
        flat_deltas = deltas.permute(0, 2, 3, 1)[0].reshape(-1, 4)
        if isinstance(draws, torch.Generator):
            draws = self.draw(anchors.shape[0], draws)
        rpn_uniform, roi_uniform, noise = draws
        losses = rpn_losses(anchors, fg_logit, flat_deltas, gt_boxes,
                            gt_mask, rpn_uniform)

        # static proposal set: gt ⊕ jittered gt, cycled over the VALID gt
        # rows only (valid-first stable order, index modulo n_valid), as
        # the padding rows would make degenerate [0,0,0,0] proposals
        order = torch.argsort((~gt_mask).to(torch.int32), stable=True)
        n_valid = gt_mask.sum().clamp(min=1)
        sel = order[torch.arange(P, device=self.device) % n_valid]
        base = gt_boxes[sel]
        wh = torch.stack([base[:, 2] - base[:, 0],
                          base[:, 3] - base[:, 1]], dim=1)
        proposals = base + noise * torch.cat([wh, wh], dim=1)
        R = cfg.pooler_resolution
        pooled = roi_align(feat[0], proposals, 1.0 / cfg.anchor_base, (R, R))
        out = self.model.roi_forward(pooled)
        losses.update(roi_losses(
            proposals, _log_prob(out["cls_prob"]), out["bbox_deltas"],
            _log_prob(out["attr_prob"]), gt_boxes, gt_classes, gt_attrs,
            gt_mask, roi_uniform))
        if not aux:
            return losses
        return losses, {
            "anchor_labels": match_anchors(anchors, gt_boxes, gt_mask)[0],
            "proposal_labels": roi_labels(proposals, gt_boxes, gt_classes,
                                          gt_mask)[0],
            "proposals": proposals, "cls_prob": out["cls_prob"],
            "attr_prob": out["attr_prob"]}

    # --------------------------------------------------------------- step

    def __call__(self, batch, generator: torch.Generator
                 ) -> Dict[str, Tensor]:
        """One optimizer step on ``batch``, drawing from ``generator``.
        Returns the losses, detached and still on the device."""
        return self._update(batch, generator)

    def step_with_draws(self, batch, rpn_uniform: Tensor,
                        roi_uniform: Tensor, jitter: Tensor
                        ) -> Dict[str, Tensor]:
        """One optimizer step on the three given draws (:meth:`draw`)."""
        draws = tuple(self._upload(t) for t in (rpn_uniform, roi_uniform,
                                                jitter))
        return self._update(batch, draws)

    def gradients(self, batch, draws
                  ) -> Tuple[Dict[str, Tensor], Dict[str, Tensor]]:
        """The losses of ``batch`` on ``draws`` (as :meth:`losses`) and the
        gradient of their sum by every parameter, under
        :func:`deterministic_cudnn`: the same inputs give the same bits."""
        with deterministic_cudnn():
            losses = self.losses(batch, draws)
            names = list(self.params)
            grads = torch.autograd.grad(sum(losses.values()),
                                        [self.params[n] for n in names])
        return losses, dict(zip(names, grads))

    def _update(self, batch, draws) -> Dict[str, Tensor]:
        losses, grads = self.gradients(batch, draws)
        self.optimizer.step(self.params, grads, self.opt_state)
        return {k: v.detach() for k, v in losses.items()}


def make_detector_train_step(model, cfg: DetectorConfig, optimizer,
                             num_proposals: int = 64, jitter: float = 0.1
                             ) -> DetectorTrainStep:
    """The counterpart of JAX ``make_detector_train_step``: a callable
    ``step(batch, generator) → losses`` that updates ``model`` in place."""
    return DetectorTrainStep(model, cfg, optimizer, num_proposals, jitter)


def loss_values(losses: Dict[str, Tensor]) -> Dict[str, float]:
    """The losses as floats, read from the device in one transfer."""
    values = torch.stack([losses[k].detach().float() for k in losses]).cpu()
    return dict(zip(losses, np.asarray(values, np.float64).tolist()))
