"""The scoring cells: whole passes of ``Trainer.predict`` over the scoring
split at the mix's batch, as the ``--max_epoch 0`` CLI scores it
(``steps.make_eval_step`` and ``EvalPipeline``), probabilities on the host
at the end of each pass. Every answer of every pass is checked."""
from __future__ import annotations

import gc

import numpy as np
import torch

from portbench import flops
from portbench.drivers.train import build_model
from portbench.reference import train as ref_train
from portbench.reference import uniter as ref
from portbench.traffic import memes


class _TimedLoader:
    """The loader, with the benchmark's ``batch`` span around each batch it
    builds."""

    def __init__(self, loader, spans):
        self._loader, self._spans = loader, spans

    def __getattr__(self, name):
        return getattr(self._loader, name)

    def __len__(self):
        return len(self._loader)

    def __iter__(self):
        it = iter(self._loader)
        while True:
            with self._spans.timed("batch"):
                batch = next(it, None)
            if batch is None:
                return
            yield batch


class Driver:
    units = "batches"
    rate_metric = "infer_samples_per_s"
    profiled_units = 1

    def __init__(self, ctx):
        self.ctx = ctx

    def setup(self) -> None:
        from meme_challenge_tpu_torch.core.config import TrainConfig
        from meme_challenge_tpu_torch.core.seeding import set_seed
        from meme_challenge_tpu_torch.data.meme_dataset import (
            BatchLoader,
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
                         img_dim=c.cfg["img_dim"], return_ids=True)
        self.loader = BatchLoader(ds, tc.batch_size)
        c.phase("dataset loaded")
        weights = ref.make_weights(c.cfg, c.seed, c.device)
        model, self.ucfg = build_model(c.cfg, c.mix["model"], weights,
                                       c.device)
        del weights
        self.trainer = Trainer(tc, model, None, None)
        c.phase("model and trainer built")
        txt = ds.txt_mask.sum(1).astype(int)
        img = ds.img_mask.sum(1).astype(int)
        self.pass_flops = flops.step_flops(c.cfg, zip(txt, img), train=False)
        self.lengths = txt + img
        self.passes: list = []
        self.unit(None)  # one warm-up pass
        self.passes = []

    def unit(self, spans):
        """One scoring pass."""
        loader = self.loader if spans is None else _TimedLoader(self.loader,
                                                                spans)
        probs, ids, _ = self.trainer.predict(loader)
        self.passes.append((probs, ids))

    def window_unit(self, spans):
        """(batches, memes scored, what the trace's reduction needs)."""
        self.unit(spans)
        return len(self.loader), len(self.passes[-1][0]), None

    def unit_flops(self, meta) -> float:
        return self.pass_flops

    def attention_launches(self, meta, peak) -> list:
        """(kind, bound seconds) of each attention launch of one pass."""
        cfg = self.ctx.cfg
        heads = cfg["num_attention_heads"]
        d = cfg["hidden_size"] // heads
        B = self.tc.batch_size
        out = []
        for start in range(0, len(self.lengths), B):
            s = flops.attention_bound_s(self.lengths[start:start + B], heads,
                                        d, self.ucfg.dtype, False, peak)
            out += [("fwd", s)] * cfg["num_hidden_layers"]
        return out

    def release(self) -> None:
        del self.trainer, self.loader
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision="float32") -> dict:
        c = self.ctx
        ids = [int(i) for i in self.corpus.ids]
        probs = ref_train.score(c.cfg, self.corpus, ids, c.mix["train"],
                                c.seed, c.device, precision=precision)
        return dict(zip(ids, probs.astype(float)))

    def check(self) -> dict:
        from portbench.check import compare_scores

        self.ref = self.reference()
        return compare_scores(self.passes, self.ref)[0]

    def control(self, kind: str) -> dict:
        """The numbers of the reference with TF32 products put in the
        program's place, as one pass."""
        from portbench.check import compare_scores

        if kind != "tf32":
            raise ValueError("scoring has no control %r" % kind)
        got = self.reference(precision="tf32")
        return compare_scores([(np.array(list(got.values())), list(got))],
                              self.ref)[0]
