"""The detector cell: the ``train_detector`` CLI's training loop, one image
a step.

Set-up writes the traffic (``traffic/vg.py``), reads it back through the
program's ``load_vg_json`` and ``VGDetectionLoader`` (training mode: the
order shuffled each epoch, random flips, the loader's own cv2 reader), builds
the detector and loads into it, by name and shape, the reference's weights
of the seed (``reference/detector.make_weights``, from the configuration's
widths), and the CLI's train step and optimizer, and drives it through its
first optimizer steps by the window's own loop, recording what the reference checks: each step's five losses,
the first step's labels and samples, the first gradient as the optimizer
took it (its momentum trace after one step) and each parameter's change
after the last. The window goes on with the same step and loader, each
step the CLI's loop body (``train_detector.train_iteration``: the upload,
timed apart as ``step.upload``, then ``step_iteration``: the step's
generator, one optimizer step, the losses read back every ``log_every``
steps), the loader started again at each epoch's end.
"""
from __future__ import annotations

import dataclasses
import gc
from types import SimpleNamespace

import numpy as np
import torch

from portbench import flops_detector
from portbench.reference import detector as ref
from portbench.reference.train import leaf_norms
from portbench.traffic import vg

CHECKED_STEPS = 3
WARMUP_STEPS = 2
PROFILED_STEPS = 3


def detector_config(cfg: dict):
    """The program's ``DetectorConfig`` of the configuration ``cfg``."""
    from meme_challenge_tpu_torch.extract.detector import DetectorConfig

    keys = {f.name for f in dataclasses.fields(DetectorConfig)}
    return DetectorConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in cfg.items() if k in keys})


class Driver:
    units = "steps"
    rate_metric = "train_samples_per_s"
    profiled_units = PROFILED_STEPS
    ucfg = SimpleNamespace(dtype="float32")

    def __init__(self, ctx):
        self.ctx = ctx

    # ------------------------------------------------------------- set-up

    def setup(self) -> None:
        from meme_challenge_tpu_torch.core.device import resolve_device
        from meme_challenge_tpu_torch.core.seeding import dropout_generator
        from meme_challenge_tpu_torch.extract.detector import BUADetector
        from meme_challenge_tpu_torch.extract.detector_train import (
            make_detector_train_step,
            subsample_labels,
        )
        from meme_challenge_tpu_torch.extract.train_detector import (
            detector_optimizer,
            step_iteration,
        )
        from meme_challenge_tpu_torch.extract.vg_data import (
            VGDetectionLoader,
            load_vg_json,
        )

        c = self.ctx
        self.step_iteration = step_iteration
        self.device = resolve_device(str(c.device))
        tc = c.mix["train"]
        self.tc = tc
        c.phase("imports")
        corpus = vg.generate(c.mix, c.seed, c.data_dir)
        c.phase("traffic written")
        self.dcfg = detector_config(c.cfg)
        records = load_vg_json(corpus.json_file, corpus.image_root)
        self.loader = VGDetectionLoader(records, self.dcfg,
                                        max_gt=tc["max_gt"], is_train=True,
                                        seed=c.seed % 2 ** 32)
        self.batches = iter(self.loader)
        model = BUADetector(self.dcfg).to(self.device)
        model.load_state_dict(self._weights(), strict=True)
        self.step = make_detector_train_step(
            model, self.dcfg, detector_optimizer(tc["lr"]),
            num_proposals=tc["num_proposals"], jitter=tc["jitter"])
        self.it = 0
        c.phase("model and step built")

        from portbench.tracing import NoSpans
        quiet = NoSpans()
        self.checked, losses = [], []
        for i in range(CHECKED_STEPS):
            host = self._next(quiet)
            self.checked.append({k: np.array(host[k]) for k in
                                 ("images", "gt_boxes", "gt_classes",
                                  "gt_attrs", "gt_mask")})
            if i == 0:
                # the first step's decisions, which no weight moves
                batch = self.step.upload(host)
                h, w = host["images"].shape[1:3]
                draws = self.step.draw(
                    ref.feat_size(h) * ref.feat_size(w)
                    * self.step.num_anchors,
                    dropout_generator(c.seed, 0, self.device))
                with torch.no_grad():
                    _, aux = self.step.losses(batch, draws, aux=True)
                decisions = {
                    "anchor_labels": aux["anchor_labels"],
                    "anchor_sampled": subsample_labels(
                        aux["anchor_labels"], draws[0]) > 0,
                    "proposal_labels": aux["proposal_labels"],
                    "proposal_sampled": subsample_labels(
                        (aux["proposal_labels"] > 0).long(), draws[1]) > 0}
                decisions = {k: v.cpu().numpy() for k, v in
                             decisions.items()}
                del aux, batch, draws
            out = self._iteration(host, quiet)
            losses.append(torch.stack([out[k] for k in ref.LOSS_KEYS]))
            if i == 0:
                grad = leaf_norms(self.step.opt_state["trace"])
        params, p0 = self.step.params, self._weights()
        self.program = {
            "loss": torch.stack(losses).cpu().numpy().astype(np.float64),
            "grad": grad,
            "delta": leaf_norms({n: params[n].detach() - p0[n]
                                 for n in params}),
            **decisions}
        del p0
        c.phase("checked steps")
        for _ in range(WARMUP_STEPS):
            self._iteration(self._next(quiet), quiet)
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def _weights(self) -> dict:
        """The reference's weights of the seed, on the device."""
        return ref.make_weights(self.ctx.cfg, self.ctx.seed, self.device)

    def _next(self, spans):
        """The loader's next batch, the loader started again at an epoch's
        end."""
        with spans.timed("batch"):
            host = next(self.batches, None)
        if host is None:
            self.batches = iter(self.loader)
            with spans.timed("batch"):
                host = next(self.batches)
        return host

    def _iteration(self, host, spans):
        """The CLI's loop body (``train_iteration``) on ``host``."""
        with spans.timed("upload"):
            batch = self.step.upload(host)
        with spans.timed("issue"):
            losses, _ = self.step_iteration(self.step, batch, self.ctx.seed,
                                            self.it, self.device,
                                            self.tc["log_every"])
        self.it += 1
        return losses

    # ------------------------------------------------------------ measures

    def window_unit(self, spans):
        """(steps, images, the blob's shape)."""
        host = self._next(spans)
        self._iteration(host, spans)
        return 1, 1, tuple(host["images"].shape[1:3])

    def unit_flops(self, shape) -> float:
        return flops_detector.step_flops(self.ctx.cfg, shape[0], shape[1],
                                         self.tc["num_proposals"])

    def attention_launches(self, shape, peak) -> list:
        """The detector has no attention."""
        return []

    # --------------------------------------------------------------- check

    def release(self) -> None:
        del self.step, self.batches, self.loader
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision="float32", fault=None) -> dict:
        c = self.ctx
        return ref.train_steps(self._weights(), self.checked, c.seed, c.cfg,
                               self.tc, self.device, precision, fault)

    def check(self) -> dict:
        from portbench.check_detector import compare

        self.ref = self.reference()
        return compare(self.program, self.ref)

    def control(self, kind: str) -> dict:
        """The numbers of a control put in the program's place: the
        reference with TF32 products and convolutions (``tf32``), or with
        the res4 map's gradient from the ROI stage dropped
        (``detached_pool``)."""
        from portbench.check_detector import compare

        got = (self.reference(precision="tf32") if kind == "tf32"
               else self.reference(fault=kind))
        return compare(got, self.ref)
