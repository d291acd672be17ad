"""The object-text cells: ``train_object_text --model <model>``'s training
loop (``Trainer.train_step`` as ``train_main`` steps it, without the
per-epoch evaluation), for a model of the text registry that the
configuration names (``"model"``).

Set-up checks that the registry's entry is the configuration's model,
writes the traffic (``traffic/objtext.py``), builds the CLI's training
loader (``ObjectTextDataset`` with a confidence threshold drawn per sample
and adjacent object words swapped, ``BatchLoader`` shuffled), builds the
model through ``build_text_model`` and loads into it, with
``strict=True``, the reference's weights of the seed
(``reference/moe_mla.make_weights``), and the ``Trainer``. It then drives
the trainer through its first optimizer steps by the window's own loop,
recording what the reference checks: each step's host batch, losses and
probabilities, the first gradient from AdamW's first moment after step 1,
each parameter's change after the last, and the experts each token picks
in every expert layer of each step (a forward without gradients before
the step). The reference decides its routers' near ties by those picks;
the first micro-batch's valid tokens' picks give ``route_gap``
(``check_moe``). The window goes on with the
same trainer and loader: ``BatchLoader`` → ``steps.stack_for_accum`` →
``steps.to_device`` → ``trainer.train_step(state, batch,
dropout_generator(seed, state.step))``, the losses and probabilities
fetched once an epoch.

The model's device counter of the rows routed to each held expert
(``MoeMlaBackbone.expert_rows``) is reset after set-up. In a traced
window each step ends with a copy of it to the host, in stream order and
without a wait: after the window's closing synchronisation that copy is
the counter at the profiled slice's start, read with no device work
inside the slice. It gives the window's rows, which the model FLOPs count
(:meth:`unit_flops`). After the slice's last step one more copy (a memcpy,
no kernel) gives its growth over the slice, which gives the grouped
kernel's launches their bounds, carried by the harness's per-launch bound
list under the kind ``expert`` (:meth:`attention_launches`; read by
``metrics/expert_gemm_roofline.train.py``).
"""
from __future__ import annotations

import dataclasses
import gc
import math
from types import SimpleNamespace
from typing import List

import numpy as np
import torch

from portbench import flops_moe
from portbench.reference import moe_mla as ref
from portbench.tracing import Spans
from portbench.traffic import objtext

CHECKED_STEPS = 3
WARMUP_STEPS = 2
PROFILED_STEPS = 3
HOST_KEYS = ("input_ids", "txt_mask", "labels", "sample_mask")


def registry_config(cfg: dict) -> dict:
    """The registry config's fields as the configuration file gives them:
    the router's width is the published expert count, the experts held the
    file's ``n_routed_experts``."""
    return {"n_routed_experts": cfg["n_routed_experts_published"],
            "experts_held": cfg["n_routed_experts"],
            **{k: cfg[k] for k in (
                "vocab_size", "hidden_size", "intermediate_size",
                "moe_intermediate_size", "num_hidden_layers",
                "first_k_dense_replace", "num_attention_heads",
                "kv_lora_rank", "qk_nope_head_dim", "qk_rope_head_dim",
                "v_head_dim", "num_experts_per_tok", "n_shared_experts",
                "routed_scaling_factor", "norm_topk_prob", "rms_norm_eps",
                "rope_theta", "expert_offset")}}


class Driver:
    units = "steps"
    rate_metric = "train_samples_per_s"
    profiled_units = PROFILED_STEPS
    ucfg = SimpleNamespace(dtype="float32")

    def __init__(self, ctx):
        self.ctx = ctx
        self.window_steps = 0
        self.traced = False
        self.window_rows = None
        self.slice_calls = 0

    # ------------------------------------------------------------- set-up

    def setup(self) -> None:
        from meme_challenge_tpu_torch.models import text_models as PT

        c = self.ctx
        name = c.cfg["model"]
        want = registry_config(c.cfg)
        have = dataclasses.asdict(PT.MODEL_DICT[name]["config"])
        if {k: have.get(k) for k in want} != want:
            raise ValueError("MODEL_DICT[%r] is not the configuration's "
                             "model: %s" % (name, {
                                 k: (have.get(k), v) for k, v in want.items()
                                 if have.get(k) != v}))

        from meme_challenge_tpu_torch.core.config import TrainConfig
        from meme_challenge_tpu_torch.core.seeding import set_seed
        from meme_challenge_tpu_torch.data.meme_dataset import BatchLoader
        from meme_challenge_tpu_torch.data.object_text import (
            ObjectTextDataset,
        )
        from meme_challenge_tpu_torch.data.tokenizer import BertTokenizer
        from meme_challenge_tpu_torch.train.trainer import Trainer

        c.phase("imports")
        self.corpus = objtext.generate(c.mix, c.seed, c.data_dir,
                                       c.cfg["vocab_size"])
        c.phase("traffic written")
        set_seed(c.seed % 2 ** 32)
        tc = TrainConfig.from_dict({**c.mix["train"], "seed": c.seed,
                                    "model_path": c.data_dir})
        self.tc = tc
        o = c.mix["objects"]
        ds = ObjectTextDataset(
            self.corpus.split, self.corpus.objects, self.corpus.classes,
            tokenizer=BertTokenizer(self.corpus.vocab),
            max_txt_len=tc.max_txt_len,
            confidence_threshold=(o["threshold_min"], o["threshold_max"]),
            swap_prob=o["swap_prob"])
        loader = BatchLoader(ds, tc.batch_size, shuffle_data=True)
        self.dataset, self.loader = ds, loader
        c.phase("dataset loaded")
        weights = ref.make_weights(c.cfg, c.seed, c.device)
        # the initial weights stay on the host, for the change's norms
        self.p0 = {n: t.cpu() for n, t in weights.items()
                   if not ref.is_buffer(n)}
        with torch.device("meta"):
            model = PT.build_text_model(name,
                                        num_classes=c.cfg["n_classes"])
        model = model.to_empty(device=c.device)
        model.load_state_dict(weights, strict=True)
        del weights
        self.counter = model.backbone.expert_rows
        self.trainer = Trainer(tc, model, loader, None)
        c.phase("model and trainer built")
        self.epoch_out: list = []
        self.it = self._epoch()

        from portbench.tracing import NoSpans
        quiet = NoSpans()
        self.checked: List[dict] = []
        outs = []
        for i in range(CHECKED_STEPS):
            host = self._next(quiet)
            picks = self._picks(model, host)
            if i == 0:
                pick_sets = self._pick_sets(picks[:, 0], host)
            out = self._step(host, quiet)
            self.checked.append({"picks": picks,
                                 **{k: np.array(host[k]) for k in HOST_KEYS}})
            outs.append(out)
            if i == 0:
                mu = self.trainer.state.opt_state["mu"]
                grad = {n: float(torch.linalg.vector_norm(m.float()))
                        / (1.0 - tc.beta1) for n, m in mu.items()}
        delta = {}
        for n, p in model.named_parameters():
            delta[n] = float(torch.linalg.vector_norm(
                p.detach() - self.p0[n].to(c.device)))
        del self.p0
        self.program = {
            "loss": torch.stack([o["loss"] for o in outs]).cpu().numpy()
            .astype(np.float64),
            "probs": torch.stack([o["probs"] for o in outs]).cpu().numpy(),
            "grad": grad, "delta": delta, "pick_sets": pick_sets}
        c.phase("checked steps")
        for _ in range(WARMUP_STEPS):
            self._step(self._next(quiet), quiet)
        if c.device.type == "cuda":
            torch.cuda.synchronize()
        self.counter.zero_()

    def _picks(self, model, host) -> np.ndarray:
        """``[expert layers, accum, B, S, k]``: the experts each token of
        the step's micro-batches picks, from the program's router under the
        step's weights (a forward without gradients before the step)."""
        from meme_challenge_tpu_torch.models import moe_mla
        from meme_challenge_tpu_torch.train.steps import to_device

        layers = []

        def grab(module, args):
            x, valid = args[0], args[1].reshape(-1)
            r = moe_mla.route(module.c, x.reshape(-1, x.shape[-1]),
                              module.gate.weight,
                              module.gate.e_score_correction_bias, valid)
            layers[-1].append(r["picks"].to(torch.int16).cpu().numpy())

        hooks = [m.register_forward_pre_hook(grab) for m in model.modules()
                 if isinstance(m, moe_mla.MoE)]
        try:
            for a in range(np.asarray(host["input_ids"]).shape[0]):
                layers.append([])
                batch = to_device({k: host[k][a]
                                   for k in ("input_ids", "txt_mask")},
                                  self.ctx.device,
                                  keys=("input_ids", "txt_mask"))
                with torch.no_grad():
                    model(batch, deterministic=True)
        finally:
            for h in hooks:
                h.remove()
        self.counter.zero_()
        shape = np.asarray(host["input_ids"]).shape[1:]
        return np.stack([np.stack(m) for m in layers], 1).reshape(
            len(layers[0]), len(layers), *shape, -1)

    def _pick_sets(self, picks: np.ndarray, host) -> np.ndarray:
        """``[expert layers, valid tokens, experts]``: of ``picks``
        ``[expert layers, B, S, k]`` (the first micro-batch's), the experts
        (of all the router's) each valid token picks."""
        valid = np.asarray(host["txt_mask"])[0].reshape(-1).astype(bool)
        flat = picks.reshape(picks.shape[0], -1, picks.shape[-1])[:, valid]
        sets = np.zeros(flat.shape[:2] + (self.ctx.cfg[
            "n_routed_experts_published"],), dtype=bool)
        np.put_along_axis(sets, flat.astype(np.int64), True, axis=-1)
        return sets

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

    def _next(self, spans):
        with spans.timed("batch"):
            host = next(self.it, None)
        if host is None:
            self._fetch()
            self.it = self._epoch()
            with spans.timed("batch"):
                host = next(self.it)
        return host

    def _step(self, host, spans):
        from meme_challenge_tpu_torch.core.seeding import dropout_generator
        from meme_challenge_tpu_torch.train.steps import (
            MODEL_INPUT_KEYS,
            TRAIN_KEYS,
            to_device,
        )

        with spans.timed("upload"):
            batch = to_device(host, self.ctx.device,
                              keys=MODEL_INPUT_KEYS + TRAIN_KEYS)
        trainer = self.trainer
        gen = dropout_generator(self.tc.seed, trainer.state.step,
                                self.ctx.device)
        with spans.timed("issue"):
            trainer.state, out = trainer.train_step(trainer.state, batch, gen)
        self.epoch_out.append(out)
        return out

    # ------------------------------------------------------------ measures

    def window_unit(self, spans):
        """(steps, valid memes, each valid meme's valid tokens)."""
        host = self._next(spans)
        self._step(host, spans)
        if isinstance(spans, Spans):
            self.traced = True
            self.window_steps += 1
            if self.window_rows is None:
                self.window_rows = torch.empty(
                    self.counter.shape, dtype=self.counter.dtype,
                    pin_memory=self.counter.is_cuda)
            # the rows so far, in stream order; the last copy is final
            # once the window has synchronised
            self.window_rows.copy_(self.counter, non_blocking=True)
        mask = np.asarray(host["sample_mask"]).astype(bool)
        lengths = np.asarray(host["txt_mask"]).sum(-1)[mask]
        return 1, int(mask.sum()), lengths

    def unit_flops(self, lengths) -> float:
        """Model FLOPs of a window step: its valid tokens outside the
        experts, and the window's routed rows shared evenly over its
        steps."""
        if not hasattr(self, "rows_a_step"):
            rows = (int(self.window_rows.sum()) if self.window_rows
                    is not None else int(self.counter.sum()))
            self.rows_a_step = rows / max(self.window_steps, 1)
        return flops_moe.step_flops(self.ctx.cfg, lengths, self.rows_a_step)

    def attention_launches(self, lengths, peak) -> list:
        """No attention kernel runs here (MLA's attention is plain torch).
        After the slice's last step: ``("expert", bound seconds)`` of each
        grouped expert launch of the slice, from the rows the counter added
        over it (each layer's launches given the slice's mean rows a
        layer)."""
        self.slice_calls += 1
        if self.slice_calls < PROFILED_STEPS or self.window_rows is None:
            return []
        rows = int(self.counter.cpu().sum() - self.window_rows.sum())
        cfg = self.ctx.cfg
        launches = PROFILED_STEPS * (cfg["num_hidden_layers"]
                                     - cfg["first_k_dense_replace"])
        return [("expert", s) for s in flops_moe.expert_launch_bounds(
            cfg, [rows / launches] * launches, peak)]

    # --------------------------------------------------------------- check

    def release(self) -> None:
        self._fetch()
        del self.trainer, self.it, self.loader, self.dataset, self.counter
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision="float32", fault=None, tie=-1.0) -> dict:
        """The reference's steps on the checked batches; each router's
        near tie (a margin at most ``tie``) decided as the program's router
        decided it (``tie`` below 0: by the reference's own scores)."""
        c = self.ctx
        total = math.ceil(len(self.corpus.ids) / self.tc.batch_size) \
            * self.tc.max_epoch
        out = ref.train_steps(c.cfg, c.mix["train"], self.checked, c.seed,
                              c.device, total, precision_kind=precision,
                              fault=fault, tie=tie)
        if c.device.type == "cuda":
            torch.cuda.empty_cache()
        return out

    def mask(self) -> np.ndarray:
        return np.stack([s["sample_mask"] for s in self.checked])

    def check(self) -> dict:
        from portbench.check_moe import ROUTE_MARGIN, compare

        self.ref = self.reference(tie=ROUTE_MARGIN)
        return compare(self.program, self.ref, self.mask())

    def control(self, kind: str) -> dict:
        """The numbers of a control put in the program's place: the
        reference with TF32 products (``tf32``), or with one of
        ``reference/moe_mla.FAULTS``."""
        from portbench.check_moe import compare

        got = (self.reference(precision=kind) if kind == "tf32"
               else self.reference(fault=kind))
        return compare(got, self.ref, self.mask())
