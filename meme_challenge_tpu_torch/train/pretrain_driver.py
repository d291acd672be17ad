"""Multi-task UNITER pretraining driver.

Counterpart of ``meme_challenge_tpu/train/pretrain_driver.py``: MLM, ITM
(with the IPOT alignment term, ``models/ot.py``), MRFR and MRC(-kl) steps
over a ``data.pretrain.MetaLoader`` stream, which holds the sampled task
fixed across an accumulation group, so each optimizer step mixes
micro-batches of one task (reference pretrain_meme_dataset.py:44-47).

- A step is the fine-tune step's body, ``steps.accumulate``, with
  ``_task_prepare`` → ``_task_apply`` as its forward and ``_task_reduce``
  as its per-micro loss: a backward a micro-batch, the gradients summed and
  divided by ``accum``; or, with ``fuse_accum``, one forward and backward
  over the flattened ``[accum·B]`` batch whose loss is the mean of the
  per-micro masked means. It runs eagerly (no CUDA graph). The optimizer
  and schedule are ``train/optim.py`` and ``train/schedules.py``, over
  ``steps_per_epoch × max_epoch`` steps.
- Index mode (``--device_resident_data``): the corpus's arrays are uploaded
  once; a micro-batch gathers its features on the device
  (``steps.gather_micro``), and MRFR's zeroed features and targets and
  MRC's one-hot labels are built there.
- Step k draws its dropout from ``core.seeding.dropout_generator(seed, k)``
  (JAX ``fold_in(root, state.step)``): ``steps_per_dispatch`` only groups
  consecutive same-task steps into one upload (``steps.upload_steps``), and
  chunked training equals unchunked.
- Kill-and-resume in O(1): one atomic torch file holds the weights, the
  optimizer state, ``step``/``next_step``, the python and numpy global RNG
  states at save time, ``MetaLoader.state()`` and the micro-batches
  consumed; loading it repositions every task iterator without replaying
  the stream. The JAX package's own resume files, and its legacy "origin +
  replay" records, are not read.
- The final dump goes through ``ModelSaver``: the reference's
  ``{"model_state_dict": ...}`` pretraining layout, which
  ``train.train_uniter --pretrained_model_file`` ingests.
"""
from __future__ import annotations

import json
import logging
import os
import random
import time
from typing import Dict, Optional

import numpy as np
import torch

from meme_challenge_tpu_torch.core.seeding import dropout_generator
from meme_challenge_tpu_torch.models.ot import optimal_transport_dist
from meme_challenge_tpu_torch.train.checkpoint import ModelSaver, tree_to
from meme_challenge_tpu_torch.train.observability import span
from meme_challenge_tpu_torch.train.optim import Optimizer
from meme_challenge_tpu_torch.train.schedules import make_schedule
from meme_challenge_tpu_torch.train.steps import (
    accumulate,
    create_train_state,
    gather_micro,
    stack_for_accum,
    steps_per_upload,
    to_device,
    upload_steps,
)

logger = logging.getLogger("meme_challenge_tpu_torch.pretrain")


def _encode_host_rng():
    """JSON-serializable (python, numpy) global-RNG state pair."""
    py_state = random.getstate()
    np_state = np.random.get_state()
    return (
        [py_state[0], list(py_state[1]), py_state[2]],
        [np_state[0], np.asarray(np_state[1]).tolist(),
         int(np_state[2]), int(np_state[3]), float(np_state[4])],
    )


def _decode_host_rng(py_enc, np_enc):
    v, st, gauss = py_enc
    name, keys, pos, has_g, cached = np_enc
    return ((v, tuple(st), gauss),
            (name, np.asarray(keys, np.uint32), pos, has_g, cached))


def _task_prepare(model, batch: Dict[str, torch.Tensor], task: str,
                  data: Optional[Dict[str, torch.Tensor]] = None):
    """Per-sample input assembly shared by both accumulation modes.

    ``data``: the corpus's device-resident arrays for index-mode batches:
    features are gathered on the device and the host-side augmentations
    (masked or replaced text, region masks) overlay them. MRFR's feature
    zeroing and regression targets are made here (targets = the original
    features, inputs zeroed at masked regions; reference
    pretrain_mrfr.py:42-51), and MRC's dense one-hot from its ``[B, R]``
    class ids: a comparison with ``arange(img_label_dim)``, so a padding
    row's −1 gives the all-zero row ``jax.nn.one_hot(-1)`` gives."""
    if data is None:
        return batch
    batch = gather_micro(data, batch)
    if (task == "mrfr" or task.startswith("mrc")) \
            and "feat_targets" not in batch:
        feats = batch["img_feat"].float()
        zero_mask = batch["img_masks"].float()[..., None]
        if task == "mrfr":
            batch["feat_targets"] = feats
        batch["img_feat"] = feats * (1.0 - zero_mask)
    if task.startswith("mrc") and "label_targets" not in batch:
        cls = batch.pop("label_cls").long()
        classes = torch.arange(model.img_label_dim, device=cls.device)
        batch["label_targets"] = (cls[..., None] == classes).float()
    return batch


def _task_apply(model, batch, task: str,
                generator: Optional[torch.Generator]):
    """PER-SAMPLE model outputs for one task, no reductions (so the fused
    step can run it on a flattened ``[accum·B]`` batch)."""
    if task == "itm":
        # one encoder pass serves both the ITM CE and the OT alignment term
        return model.forward_itm_with_seq(batch, deterministic=False,
                                          generator=generator)
    return model(batch, task, deterministic=False, generator=generator)


def _masked_mean(x: torch.Tensor, weight_sum: torch.Tensor) -> torch.Tensor:
    return x.sum() / torch.clamp_min(weight_sum, 1.0)


def _task_reduce(outs, batch, task: str, ot_weight: float = 0.0
                 ) -> torch.Tensor:
    """Masked-mean loss over ONE micro-batch's per-sample outputs (the
    reference tasks' own weighting; JAX pretrain_driver.py:111-154). Every
    task weights by ``sample_mask``: the TaskLoader pads the final batch by
    repeating sample 0."""
    sm = batch["sample_mask"].float()
    if task == "mlm":
        nll, mask = outs
        return _masked_mean(nll * sm[:, None], (mask * sm[:, None]).sum())
    if task == "mrfr":
        err, mask = outs
        w = mask.float() * sm[:, None]
        return _masked_mean(err * sm[:, None, None], w.sum() * err.shape[-1])
    if task.startswith("mrc"):
        loss, mask = outs
        w = mask.float() * sm[:, None]
        # mrc-kl returns per-(region, class) losses
        loss = loss * (sm[:, None, None] if loss.dim() == 3 else sm[:, None])
        return _masked_mean(loss, w.sum())
    if task == "itm":
        scores, seq = outs
        targets = batch["targets"].long()
        logp = torch.log_softmax(scores.float(), dim=-1)
        nll = -torch.gather(logp, -1, targets[:, None])[:, 0]
        loss = _masked_mean(nll * sm, sm.sum())
        if ot_weight > 0.0:
            # OT alignment: matched pairs should have a small transport
            # distance, mismatched ones a large one (+dist / −dist)
            T = batch["input_ids"].shape[1]
            dist = optimal_transport_dist(seq[:, :T], seq[:, T:],
                                          batch["txt_mask"] == 0,
                                          batch["img_mask"] == 0)
            signed = torch.where(targets == 1, dist, -dist)
            loss = loss + ot_weight * _masked_mean(signed * sm, sm.sum())
        return loss
    raise ValueError("unknown task %s" % task)


def _task_loss(model, batch, task: str, generator=None,
               ot_weight: float = 0.0, data=None) -> torch.Tensor:
    """Scalar loss for one task micro-batch: prepare → apply → reduce."""
    batch = _task_prepare(model, batch, task, data)
    return _task_reduce(_task_apply(model, batch, task, generator), batch,
                        task, ot_weight)


class PretrainTrainer:
    """Multi-task pretraining of a ``UniterForPretraining`` (on its
    device, trained in place) over a MetaLoader stream.

    ``data_arrays``: the corpus's ``device_arrays()`` for index-mode task
    loaders (uploaded once). ``task_memes`` / ``task_seconds`` add up, per
    task, the valid memes stepped and the host seconds between one step's
    dispatch and the previous one's (the loss fetches' waits included):
    train memes/s by task (:meth:`memes_per_sec_by_task`)."""

    def __init__(self, config, model: torch.nn.Module, meta_loader,
                 steps_per_epoch: int, ot_weight: float = 0.0,
                 data_arrays: Optional[Dict[str, np.ndarray]] = None):
        self.config = config
        self.model = model
        self.meta_loader = meta_loader
        self.steps_per_epoch = steps_per_epoch
        self.ot_weight = ot_weight
        self.device = next(model.parameters()).device
        self.data = (to_device(data_arrays, self.device, keys=data_arrays)
                     if data_arrays is not None else None)
        c = config
        schedule = make_schedule(
            c.scheduler, warmup_steps=c.warmup_steps,
            total_steps=steps_per_epoch * c.max_epoch,
            lr_decay_step=c.lr_decay_step,
            lr_decay_factor=c.lr_decay_factor)
        self.optimizer = Optimizer(
            c.optimizer, c.lr, schedule, beta1=c.beta1, beta2=c.beta2,
            weight_decay=c.weight_decay, max_grad_norm=c.max_grad_norm,
            mu_dtype=c.adam_mu_dtype, nu_dtype=c.adam_nu_dtype)
        self.state = create_train_state(model, self.optimizer)
        self._params = dict(model.named_parameters())
        self._consumed_micros = 0
        self.task_memes: Dict[str, int] = {}
        self.task_seconds: Dict[str, float] = {}
        self.saver = ModelSaver(os.path.join(c.model_path, c.model_save_name))

    # ------------------------------------------------------------- the step

    def step(self, task: str, batch: Dict[str, torch.Tensor],
             generator: Optional[torch.Generator]) -> torch.Tensor:
        """One optimizer step of ``task`` over device tensors ``[accum, B,
        ...]``; dropout draws from ``generator``. Returns the per-micro
        losses ``[accum]``, on the device."""
        def forward(batch):
            batch = _task_prepare(self.model, batch, task, self.data)
            return _task_apply(self.model, batch, task, generator), batch

        def loss(outs, batch):
            return _task_reduce(outs, batch, task, self.ot_weight), None

        with span("meme.step"):
            losses, _ = accumulate(
                self._params, batch, self.config.gradient_accumulation,
                self.config.fuse_accum, forward, loss,
                lambda grads: self.optimizer.step(self._params, grads,
                                                  self.state.opt_state))
        self.state.step += 1
        return losses

    # ----------------------------------------------------------- the resume

    def save_checkpoint(self, path: str, next_step: int) -> None:
        """Atomic full-state checkpoint (``.tmp`` + ``os.replace``): the
        weights, the optimizer state, the step, the host-RNG states at save
        time and every task loader's epoch position, in ONE file, so a kill
        at any instant leaves the previous checkpoint or the new one."""
        py_enc, np_enc = _encode_host_rng()
        stream_record = json.dumps({
            "rng_py": py_enc,
            "rng_np": np_enc,
            "meta": self.meta_loader.state(),
            "consumed_micros": int(self._consumed_micros),
        })
        payload = {
            "params": tree_to(self.model.state_dict(), "cpu"),
            "opt_state": tree_to(self.state.opt_state, "cpu"),
            "step": int(self.state.step),
            "next_step": int(next_step),
            "stream_record": stream_record,
        }
        t0 = time.perf_counter()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        logger.info("pretrain resume file %s: %.3f GB written in %.3f s",
                    path, os.path.getsize(path) / 1e9,
                    time.perf_counter() - t0)

    def load_checkpoint(self, path: str) -> int:
        """Restore a :meth:`save_checkpoint` file: weights, optimizer state
        and step, the host RNGs, and every task iterator's position (O(1),
        no replay); returns the next optimizer step to run. Dropout
        continues by itself: step k's generator derives from (seed, k)."""
        payload = torch.load(path, map_location="cpu", weights_only=True)
        record = json.loads(payload["stream_record"])
        if "meta" not in record:
            raise ValueError("%s holds no loader positions (a legacy replay "
                             "record), which this driver does not read"
                             % path)
        self.model.load_state_dict(payload["params"], strict=True)
        self.state.opt_state = tree_to(payload["opt_state"], self.device)
        self.state.step = int(payload["step"])
        py_state, np_state = _decode_host_rng(record["rng_py"],
                                              record["rng_np"])
        random.setstate(py_state)
        np.random.set_state(np_state)
        self.meta_loader.set_state(record["meta"])
        self._consumed_micros = int(record["consumed_micros"])
        return int(payload["next_step"])

    # ------------------------------------------------------------- the loop

    def memes_per_sec_by_task(self) -> Dict[str, float]:
        return {t: self.task_memes[t] / self.task_seconds[t]
                for t in self.task_memes if self.task_seconds[t] > 0}

    def train(self, total_steps: Optional[int] = None,
              log_every: Optional[int] = None,
              save_checkpoint: bool = True,
              checkpoint_path: Optional[str] = None,
              checkpoint_every: Optional[int] = None) -> Dict[str, float]:
        """Run ``total_steps`` optimizer steps (default ``steps_per_epoch ×
        max_epoch``); returns {task: mean loss over the last epoch}.

        ``log_every`` sets the loss-fetch cadence (default total // 10),
        the loop's only host sync. ``save_checkpoint=False`` skips the final
        ``ModelSaver`` dump. ``checkpoint_path`` enables kill-and-resume: a
        file there is loaded and training resumes at its step; a new one
        is written every ``checkpoint_every`` steps (default one nominal
        epoch) and at the end."""
        c = self.config
        accum = c.gradient_accumulation
        total = total_steps or (self.steps_per_epoch * c.max_epoch)
        cadence = log_every or max(1, total // 10)
        ckpt_cadence = checkpoint_every or self.steps_per_epoch
        start_step = 0
        if checkpoint_path and os.path.isfile(checkpoint_path):
            start_step = self.load_checkpoint(checkpoint_path)
            logger.info("resuming pretraining from %s at step %i",
                        checkpoint_path, start_step)
        # (task, device losses [accum]) per step: fetched at the cadence
        step_log: list = []
        fetched: Dict[str, list] = {}
        K = steps_per_upload(c, self.data is not None)
        pending: list = []
        clock = [time.perf_counter(), None]  # last mark, task stepped last

        def mark(task: str) -> None:
            now = time.perf_counter()
            self.task_seconds[task] = (self.task_seconds.get(task, 0.0)
                                       + now - clock[0])
            clock[:] = [now, task]

        def drain():
            for task_i, dev_losses in step_log:
                fetched.setdefault(task_i, []).append(
                    float(dev_losses.cpu().numpy().mean()))  # sync point
            step_log.clear()
            if clock[1] is not None:  # the wait counts to the last task
                mark(clock[1])

        def flush():
            if not pending:
                return
            task = pending[0][0]
            # one upload for a run of same-task steps
            hosts = [b for _, b in pending]
            for host, batch in zip(hosts, upload_steps(hosts, self.device,
                                                       hosts[0])):
                gen = dropout_generator(c.seed, self.state.step, self.device)
                step_log.append((task, self.step(task, batch, gen)))
                self.task_memes[task] = (self.task_memes.get(task, 0)
                                         + int(host["sample_mask"].sum()))
                mark(task)
            pending.clear()

        stream = iter(self.meta_loader)
        t0 = time.time()
        for opt_step in range(start_step, total):
            group, task = [], None
            for _ in range(accum):
                task_i, batch = next(stream)
                if task is not None and task_i != task:
                    raise RuntimeError("the MetaLoader must hold the task "
                                       "fixed across an accumulation group")
                task = task_i
                group.append(batch)
            self._consumed_micros += accum
            if pending and task != pending[0][0]:
                flush()
            pending.append((task, stack_for_accum(group)))
            if len(pending) >= K:
                flush()
            if (opt_step + 1) % cadence == 0:
                flush()
                drain()
                means = {t: float(np.mean(v[-50:]))
                         for t, v in fetched.items()}
                logger.info("pretrain step %i/%i losses=%s (%.1fs)",
                            opt_step + 1, total, means, time.time() - t0)
            if checkpoint_path and (opt_step + 1) % ckpt_cadence == 0 \
                    and opt_step + 1 < total:
                flush()  # the state must hold every consumed micro-batch
                self.save_checkpoint(checkpoint_path, opt_step + 1)
                clock[0] = time.perf_counter()  # no task's time
        flush()
        drain()
        logger.info("pretrain train memes/s by task: %s",
                    self.memes_per_sec_by_task())
        if checkpoint_path:
            self.save_checkpoint(checkpoint_path, total)
        if save_checkpoint:
            self.saver.save(self.model)
        return {t: float(np.mean(v[-self.steps_per_epoch:]))
                for t, v in fetched.items()}
