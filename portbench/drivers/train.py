"""The fine-tune cells: the recipe's ``Trainer`` stepped as ``train_main``
steps it, without the per-epoch evaluation.

Set-up builds the trainer (``core/config.TrainConfig`` from the mix's
``train`` keys, the recipe's ``ConfounderSampler`` and ``BatchLoader``, the
model from the weights of the seed) and drives it through its first
optimizer steps by the window's own loop, recording what the reference
checks: each step's memes, losses and probabilities, the first gradient
from the optimizer's state after step 1 and the parameters' change after
the last. The window goes on with the same trainer and loader:
``BatchLoader`` → ``steps.stack_for_accum`` → ``steps.to_device`` →
``trainer.train_step(state, batch, dropout_generator(seed, state.step))``,
with the losses and probabilities left on the device and fetched once an
epoch, and the loader reshuffled at each.
"""
from __future__ import annotations

import gc
import math
from typing import List

import numpy as np
import torch

from portbench import flops
from portbench.reference import train as ref_train
from portbench.reference import uniter as ref
from portbench.traffic import memes

CHECKED_STEPS = 3
WARMUP_STEPS = 2
PROFILED_STEPS = 3
KEYS = ("input_ids", "position_ids", "txt_mask", "img_feat", "img_pos_feat",
        "img_mask", "labels", "sample_mask")


def build_model(cfg: dict, model_flags: dict, weights: dict, device):
    """The program's MemeUniter of ``cfg`` holding ``weights``."""
    from meme_challenge_tpu_torch.core.config import UniterConfig
    from meme_challenge_tpu_torch.models.uniter import MemeUniter

    ucfg = UniterConfig.from_dict({**cfg, **model_flags})
    with torch.device("meta"):
        model = MemeUniter(ucfg, n_classes=cfg.get("n_classes", 1))
    model = model.to_empty(device=device)
    model.load_state_dict(weights, strict=True)
    return model.eval(), ucfg


class Driver:
    units = "steps"
    rate_metric = "train_samples_per_s"
    profiled_units = PROFILED_STEPS

    def __init__(self, ctx):
        self.ctx = ctx

    # ------------------------------------------------------------- set-up

    def setup(self) -> None:
        from meme_challenge_tpu_torch.core.config import TrainConfig
        from meme_challenge_tpu_torch.core.seeding import set_seed
        from meme_challenge_tpu_torch.data.meme_dataset import (
            BatchLoader,
            ConfounderSampler,
            MemeDataset,
        )
        from meme_challenge_tpu_torch.data.tokenizer import BertTokenizer
        from meme_challenge_tpu_torch.train.trainer import Trainer

        c = self.ctx
        c.phase("imports")
        self.corpus = memes.generate(c.mix, c.seed, c.data_dir,
                                     c.cfg["vocab_size"])
        c.phase("traffic written")
        set_seed(c.seed % 2 ** 32)
        tc = TrainConfig.from_dict({**c.mix["train"], "seed": c.seed,
                                    "model_path": c.data_dir})
        self.tc = tc
        ds = MemeDataset(self.corpus.split, feature_dir=self.corpus.feature_dir,
                         tokenizer=BertTokenizer(self.corpus.vocab),
                         max_txt_len=tc.max_txt_len, max_bb=tc.max_bb,
                         img_dim=c.cfg["img_dim"])
        self.dataset = ds
        loader = BatchLoader(ds, tc.batch_size, sampler=ConfounderSampler(
            ds, repeat_factor=tc.confounder_repeat))
        c.phase("dataset loaded")
        weights = ref.make_weights(c.cfg, c.seed, c.device)
        model, self.ucfg = build_model(c.cfg, c.mix["model"], weights,
                                       c.device)
        del weights
        self.trainer = Trainer(tc, model, loader, None)
        c.phase("model and trainer built")
        self.loader = loader
        self.lengths = (ds.txt_mask.sum(1) + ds.img_mask.sum(1)).astype(int)
        self.txt_lengths = ds.txt_mask.sum(1).astype(int)
        self.epoch_out: list = []
        self.it = self._epoch()

        from portbench.tracing import NoSpans
        quiet = NoSpans()
        self.checked: List[dict] = []
        outs = []
        for i in range(CHECKED_STEPS):
            host, out = self.unit(quiet)
            self.checked.append({"ids": host["ids"],
                                 "sample_mask": host["sample_mask"]})
            outs.append(out)
            if i == 0:
                p0 = ref.make_weights(c.cfg, c.seed, c.device)
                grad = ref_train.first_gradient(
                    self.trainer.state.opt_state["mu"], p0, tc.beta1,
                    tc.weight_decay)
        self.program = {
            "loss": torch.stack([o["loss"] for o in outs]).cpu().numpy(),
            "probs": torch.stack([o["probs"] for o in outs]).cpu().numpy(),
            "grad": grad,
            "delta": ref_train.change(dict(self.trainer.model
                                           .named_parameters()), p0)}
        del p0
        c.phase("checked steps")
        for _ in range(WARMUP_STEPS):
            self.unit(quiet)
        if c.device.type == "cuda":
            torch.cuda.synchronize()

    def _epoch(self):
        """The trainer's grouping of one epoch of the loader into
        ``[accum, B, ...]`` host batches; a short final group is padded
        with zero-mask copies of its last micro-batch."""
        from meme_challenge_tpu_torch.train.steps import stack_for_accum

        accum = self.tc.gradient_accumulation
        group = []
        for batch in self.loader:
            group.append(dict(batch))
            if len(group) == accum:
                yield stack_for_accum(group)
                group = []
        if group:
            pad = dict(group[-1])
            pad["sample_mask"] = np.zeros_like(pad["sample_mask"])
            group += [pad] * (accum - len(group))
            yield stack_for_accum(group)

    def _fetch(self) -> None:
        """The epoch's one host sync, as ``train_main`` makes it."""
        if self.epoch_out:
            torch.cat([o["loss"].reshape(-1) for o in self.epoch_out]).cpu()
            torch.cat([o["probs"].reshape(-1) for o in self.epoch_out]).cpu()
        self.epoch_out = []

    def unit(self, spans):
        """One optimizer step of the window's loop."""
        from meme_challenge_tpu_torch.core.seeding import dropout_generator
        from meme_challenge_tpu_torch.train.steps import to_device

        with spans.timed("batch"):
            host = next(self.it, None)
        if host is None:
            self._fetch()
            self.it = self._epoch()
            with spans.timed("batch"):
                host = next(self.it)
        with spans.timed("upload"):
            batch = to_device(host, self.ctx.device, keys=KEYS)
        trainer = self.trainer
        gen = dropout_generator(self.tc.seed, trainer.state.step,
                                self.ctx.device)
        with spans.timed("issue"):
            trainer.state, out = trainer.train_step(trainer.state, batch, gen)
        self.epoch_out.append(out)
        return host, out

    # ------------------------------------------------------------ measures

    def window_unit(self, spans):
        """(steps, valid memes, what the trace's reduction needs)."""
        host, _ = self.unit(spans)
        return 1, int(host["sample_mask"].sum()), {
            "ids": host["ids"], "sample_mask": host["sample_mask"]}

    def unit_flops(self, host) -> float:
        rows = np.asarray(host["ids"]).reshape(-1)[
            np.asarray(host["sample_mask"]).reshape(-1).astype(bool)]
        where = self.corpus.index()
        idx = [where[int(i)] for i in rows]
        return flops.step_flops(self.ctx.cfg, (
            (int(self.txt_lengths[i]), int(self.lengths[i]
                                           - self.txt_lengths[i]))
            for i in idx), train=True)

    def attention_launches(self, host, peak) -> list:
        """(kind, bound seconds) of each attention launch of one step."""
        cfg, dtype = self.ctx.cfg, self.ucfg.dtype
        heads = cfg["num_attention_heads"]
        d = cfg["hidden_size"] // heads
        where = self.corpus.index()
        ids = np.asarray(host["ids"])
        mask = np.asarray(host["sample_mask"]).astype(bool)
        groups = ([ids[mask]] if self.tc.fuse_accum
                  else [ids[a][mask[a]] for a in range(ids.shape[0])])
        out = []
        for rows in groups:
            lens = [int(self.lengths[where[int(i)]]) for i in rows]
            for kind in ("fwd", "bwd"):
                s = flops.attention_bound_s(lens, heads, d, dtype,
                                            kind == "bwd", peak)
                out += [(kind, s)] * cfg["num_hidden_layers"]
        return out

    # --------------------------------------------------------------- check

    def release(self) -> None:
        self._fetch()
        del self.trainer, self.it, self.loader, self.dataset
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision="float32", fault=None) -> dict:
        c = self.ctx
        epoch = len(self.corpus.ids) + (self.tc.confounder_repeat - 1) \
            * self.corpus.n_confounders
        total = math.ceil(epoch / self.tc.batch_size) * self.tc.max_epoch
        return ref_train.train_steps(
            c.cfg, c.mix["model"], c.mix["train"], self.corpus, self.checked,
            c.seed, c.device, total, precision=precision, fault=fault)

    def mask(self) -> np.ndarray:
        return np.stack([np.asarray(s["sample_mask"]) for s in self.checked])

    def check(self) -> dict:
        from portbench.check import compare_train

        ids = np.concatenate([np.asarray(s["ids"])[np.asarray(
            s["sample_mask"]).astype(bool)] for s in self.checked])
        if len(set(ids.tolist())) != len(ids):
            raise RuntimeError("the checked steps repeat a meme")
        self.ref = self.reference()
        return compare_train(self.program, self.ref, self.mask())

    def control(self, kind: str) -> dict:
        """The numbers of a control put in the program's place: the
        reference with TF32 products (``tf32``) or float8 operands
        (``fp8``), or with half of each micro-batch left out of the loss
        (``half_batch``)."""
        from portbench.check import compare_train

        got = (self.reference(precision=kind) if kind in ("tf32", "fp8")
               else self.reference(fault=kind))
        return compare_train(got, self.ref, self.mask())
