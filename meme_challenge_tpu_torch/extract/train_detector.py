"""Detector training/eval CLI — the reference ``train_net.py`` equivalent.

The port of ``meme_challenge_tpu/extract/train_detector.py``. The reference
drives detectron2's DefaultTrainer over NCCL ``launch``
(bottom-up-attention.pytorch/train_net.py:53-81) with a VG dataset and
VGEvaluator. Here: VG COCO-format annotations through
``extract/vg_data.py``, the full train step
(``extract/detector_train.make_detector_train_step``: RPN + ROI + attribute
losses and one update) with the JAX CLI's optimizer
(``optax.chain(clip_by_global_norm(5.0), sgd(lr, momentum=0.9))``, as the
port's ``train.optim.Optimizer``), and ``--eval-only`` running detection +
``vg_eval`` mAP@0.5 / weighted mAP (the VGEvaluator numbers, subrepo
README.md:182-186).

After each epoch the weights go to ``out_dir/detector.pth``: a torch state
dict in the port's detectron2 key layout, which ``extract_features
--weights`` and ``visualize_boxes --weights`` load as it stands (the JAX CLI
writes ``detector.msgpack``). As in JAX, no resume state is kept.

Usage:
  python -m meme_challenge_tpu_torch.extract.train_detector \\
      --train-json datasets/vg/annotations/train.json \\
      --val-json datasets/vg/annotations/val.json \\
      --image-root datasets/vg/images --out-dir ./detector_ckpt \\
      [--eval-only --weights detector.pth] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch
from torch import nn

from meme_challenge_tpu_torch.core.device import resolve_device
from meme_challenge_tpu_torch.core.seeding import dropout_generator
from meme_challenge_tpu_torch.extract.convert_detector import (
    load_detector_weights,
)
from meme_challenge_tpu_torch.extract.detector import (
    BUADetector,
    DetectorConfig,
    FeatureExtractor,
)
from meme_challenge_tpu_torch.extract.detector_train import (
    loss_values,
    make_detector_train_step,
)
from meme_challenge_tpu_torch.extract.vg_data import (
    VGDetectionLoader,
    load_vg_json,
)
from meme_challenge_tpu_torch.extract.vg_eval import evaluate_detections
from meme_challenge_tpu_torch.train.optim import Optimizer

logger = logging.getLogger("meme_challenge_tpu_torch.extract.train_detector")


def load_weights(weights_path: str, cfg: DetectorConfig, seed: int = 0):
    """Detector state from a torch ``.pth``/``.pt`` (Caffe-converted or this
    CLI's dump) or a flax ``.msgpack`` checkpoint; random weights from
    ``seed`` for what the file lacks — the single source of truth for both
    ``train`` and ``--eval-only``."""
    return load_detector_weights(weights_path, cfg, seed=seed)


def detector_optimizer(lr: float) -> Optimizer:
    """``optax.chain(clip_by_global_norm(5.0), sgd(lr, momentum=0.9))``:
    optax's clip rule (no ``+1e-6``), the momentum trace, ``foreach``
    updates of every parameter."""
    return Optimizer("sgd", lr, lambda count: 1.0, beta1=0.9,
                     max_grad_norm=5.0)


def evaluate(cfg: DetectorConfig, weights, records, image_reader=None,
             max_images: int = 0, extractor: FeatureExtractor = None,
             device="cuda"):
    """Run detection (mode 2: boxes + class scores) and score with the
    VGEvaluator-parity metrics.

    ``weights``: a detector state dict, or a live ``BUADetector`` (run as
    it stands, no copy). Pass ``extractor`` to reuse one across calls; its
    model is swapped for ``weights`` only for the duration of the call and
    restored on exit, so a caller-owned extractor is not left holding the
    last-evaluated weights."""
    ex = extractor or FeatureExtractor(cfg, weights, device=device)
    prev_model = ex.model
    if isinstance(weights, nn.Module):
        ex.model = weights
    elif extractor is not None:
        ex.model = BUADetector(cfg)
        ex.model.load_state_dict(weights, strict=True)
        ex.model.to(ex.device).eval()
    try:
        loader = VGDetectionLoader(records, cfg, is_train=False,
                                   image_reader=image_reader)
        preds, gts = [], []
        for i, rec in enumerate(records):
            if max_images and i >= max_images:
                break
            img = loader.image_reader(rec)
            out = ex.extract(img, mode=2)
            cls_prob = out["cls_prob"]
            labels = cls_prob[:, 1:].argmax(axis=1)    # 0-based foreground
            scores = cls_prob[np.arange(len(labels)), labels + 1]
            preds.append({"image_id": rec["image_id"], "boxes": out["bbox"],
                          "scores": scores, "labels": labels})
            gts.append({"image_id": rec["image_id"], "boxes": rec["boxes"],
                        "classes": rec["classes"]})
        return evaluate_detections(preds, gts,
                                   num_classes=cfg.num_classes - 1)
    finally:
        ex.model = prev_model


def save_weights(model: nn.Module, path: str) -> None:
    """The detector's state dict (CPU tensors) to ``path``, replaced
    whole."""
    tmp = path + ".tmp"
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               tmp)
    os.replace(tmp, path)


def train(args, cfg: DetectorConfig, records, val_records,
          image_reader=None):
    """``args.epochs`` epochs over ``records`` on ``args.device``; after each
    one the weights go to ``args.out_dir/detector.pth`` and, with
    ``val_records``, the live module is evaluated. Returns (the model, a
    history {"losses": [(iteration, {name: float})] at every
    ``args.log_every``-th step, "epochs": [{"epoch", "mAP",
    "weighted_mAP"}]})."""
    device = resolve_device(args.device)
    model = BUADetector(cfg)
    model.load_state_dict(load_weights(args.weights, cfg, seed=args.seed),
                          strict=True)
    model.to(device)
    step = make_detector_train_step(model, cfg, detector_optimizer(args.lr),
                                    num_proposals=args.num_proposals)
    loader = VGDetectionLoader(records, cfg, max_gt=args.max_gt,
                               is_train=True, seed=args.seed,
                               image_reader=image_reader)
    eval_ex = (FeatureExtractor(cfg, model, device=device)
               if val_records else None)
    path = os.path.join(args.out_dir, "detector.pth")
    history = {"losses": [], "epochs": []}
    it = 0
    t0 = time.time()
    for epoch in range(1, args.epochs + 1):
        for batch in loader:
            batch = {k: v for k, v in batch.items() if k != "image_id"}
            # a generator a step, the counterpart of fold_in(root, it)
            losses = step(batch, dropout_generator(args.seed, it, device))
            it += 1
            if it % args.log_every == 0:
                values = loss_values(losses)
                history["losses"].append((it, values))
                logger.info("iter %d losses %s (%.1fs)", it,
                            {k: round(v, 4) for k, v in values.items()},
                            time.time() - t0)
        save_weights(model, path)
        if val_records:
            metrics = evaluate(cfg, model, val_records,
                               image_reader=image_reader,
                               max_images=args.eval_images,
                               extractor=eval_ex)
            history["epochs"].append({"epoch": epoch,
                                      "mAP": metrics["mAP"],
                                      "weighted_mAP": metrics["weighted_mAP"]})
            logger.info("epoch %d: mAP@0.5 %.4f weighted %.4f", epoch,
                        metrics["mAP"], metrics["weighted_mAP"])
    return model, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--train-json", type=str, default="")
    ap.add_argument("--val-json", type=str, default="")
    ap.add_argument("--image-root", type=str, required=True)
    ap.add_argument("--out-dir", type=str, default="./detector_ckpt")
    ap.add_argument("--weights", type=str, default="",
                    help="torch .pth (Caffe-converted or a dump of this "
                         "CLI) or flax .msgpack")
    ap.add_argument("--eval-only", action="store_true")
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-gt", type=int, default=64)
    ap.add_argument("--num-proposals", type=int, default=64)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--eval-images", type=int, default=0,
                    help="cap eval to N images (0 = all)")
    ap.add_argument("--depth", type=int, default=101, choices=(101, 152))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = DetectorConfig(depth=args.depth)
    os.makedirs(args.out_dir, exist_ok=True)
    val_records = (load_vg_json(args.val_json, args.image_root)
                   if args.val_json else [])
    if args.eval_only:
        if not args.weights:
            raise ValueError("--eval-only needs --weights")
        metrics = evaluate(cfg, load_weights(args.weights, cfg,
                                             seed=args.seed),
                           val_records, max_images=args.eval_images,
                           device=device)
        logger.info("eval: %s", {k: v for k, v in metrics.items()
                                 if k != "per_class_ap"})
        return metrics
    records = load_vg_json(args.train_json, args.image_root)
    return train(args, cfg, records, val_records)[1]


if __name__ == "__main__":
    logging.basicConfig(
        format="%(asctime)s %(levelname)s %(name)s | %(message)s",
        datefmt="%d/%m/%Y %I:%M:%S %p", level=logging.INFO)
    main()
