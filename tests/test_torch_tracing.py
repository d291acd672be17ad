"""PyTorch port: the named host ranges (``train/observability.span``) on the
train, pretraining and scoring path, as a CPU ``torch.profiler`` records
them: their names and counts a step and a batch, their nesting, that none is
a user annotation (the profiler would mirror one onto the device's timeline,
where a trace's reader counts it as a kernel), and that the numbers of a
step and of a scoring pass are bit for bit the same with the profiler on and
off."""
import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from meme_challenge_tpu_torch.core.config import TrainConfig, UniterConfig
from meme_challenge_tpu_torch.core.seeding import (
    dropout_generator,
    torch_generator,
)
from meme_challenge_tpu_torch.data.pretrain import pretrain_corpus
from meme_challenge_tpu_torch.data.meme_dataset import BatchLoader, MemeDataset
from meme_challenge_tpu_torch.data.tokenizer import BertTokenizer
from meme_challenge_tpu_torch.models.uniter import FoldStack, MemeUniter
from meme_challenge_tpu_torch.train import losses as TL
from meme_challenge_tpu_torch.train import observability
from meme_challenge_tpu_torch.train.optim import Optimizer
from meme_challenge_tpu_torch.train.pretrain_driver import PretrainTrainer
from meme_challenge_tpu_torch.train.pretrain_init import init_pretrain_model
from meme_challenge_tpu_torch.train.pretrain_uniter import build_task_loaders
from meme_challenge_tpu_torch.train.steps import (
    EvalPipeline,
    TrainState,
    create_train_state,
    make_fold_train_step,
    make_train_step,
    stack_for_accum,
    to_device,
)
from meme_challenge_tpu_torch.train.trainer import Trainer
from meme_challenge_tpu_torch.utils.synthetic import (
    make_synthetic_dataset,
    make_vocab,
)

TINY = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, intermediate_size=64, img_dim=16,
            max_position_embeddings=64, initializer_range=0.2)
KEYS = ("input_ids", "position_ids", "txt_mask", "img_feat", "img_pos_feat",
        "img_mask", "labels", "sample_mask")


def _model(seed=0):
    torch.manual_seed(seed)
    return MemeUniter(UniterConfig(**TINY)).eval()


def _micro(seed, B=3, T=8, R=6):
    rng = np.random.RandomState(seed)
    txt = rng.randint(3, T + 1, B)
    bb = rng.randint(2, R + 1, B)
    return {
        "input_ids": rng.randint(0, 64, (B, T)).astype(np.int32),
        "position_ids": np.tile(np.arange(T, dtype=np.int32), (B, 1)),
        "txt_mask": (np.arange(T)[None] < txt[:, None]).astype(np.int32),
        "img_feat": rng.randn(B, R, 16).astype(np.float16),
        "img_pos_feat": rng.rand(B, R, 7).astype(np.float32),
        "img_mask": (np.arange(R)[None] < bb[:, None]).astype(np.int32),
        "labels": rng.randint(0, 2, B).astype(np.int32),
        "sample_mask": np.array([1] * (B - 1) + [0], np.int32),
    }


def _events(prof, prefix="meme."):
    return [e for e in prof.events() if e.name.startswith(prefix)]


def _counts(events):
    return dict(collections.Counter(e.name for e in events))


def _inside(inner, outer):
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


def _train(fuse_accum, profiled, steps=1):
    """``steps`` optimizer steps at accumulation 2, dropout on, as the
    trainer feeds them: host micro-batches stacked, uploaded, the step's
    generator drawn. Returns (losses, probs, parameters, profiler)."""
    model = _model()
    opt = Optimizer("adam", 1e-3, lambda s: 1.0, mu_dtype="bfloat16",
                    nu_dtype="bfloat16")
    state = create_train_state(model, opt)
    step = make_train_step(model, TL.make_loss_fn("bce_logits", 1.8), opt,
                           accum_steps=2, fuse_accum=fuse_accum)
    prof = profile(activities=[ProfilerActivity.CPU]) if profiled else None
    if prof is not None:
        prof.start()
    outs = []
    for i in range(steps):
        host = stack_for_accum([_micro(10 * i), _micro(10 * i + 1)])
        batch = to_device(host, "cpu", keys=KEYS)
        gen = dropout_generator(7, state.step, "cpu")
        state, out = step(state, batch, gen)
        outs.append(out)
    if prof is not None:
        prof.stop()
    return (torch.stack([o["loss"] for o in outs]),
            torch.stack([o["probs"] for o in outs]),
            {k: v.detach().clone() for k, v in model.state_dict().items()},
            prof)


def test_span_is_the_fast_record_function():
    """On the installed torch a range is recorded: the helper has not
    fallen back to its no-op."""
    assert observability._RecordFunctionFast is not None
    assert not isinstance(observability.span("meme.x"),
                          observability._NoSpan)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with observability.span("meme.x"):
            torch.ones(2) + 1
    (e,) = _events(prof)
    assert e.name == "meme.x" and not e.is_user_annotation


@pytest.mark.parametrize("fuse_accum", [False, True],
                         ids=["scan_accum", "fused_accum"])
def test_train_step_ranges(fuse_accum):
    """One step at accumulation 2: a forward and a backward a micro-batch
    (one of each fused), one optimizer phase, all three inside
    ``meme.step``; stacking, upload and the generator once a step."""
    *_, prof = _train(fuse_accum, profiled=True)
    events = _events(prof)
    passes = 1 if fuse_accum else 2
    assert _counts(events) == {
        "meme.loader.stack": 1, "meme.upload": 1, "meme.rng": 1,
        "meme.step": 1, "meme.step.forward": passes,
        "meme.step.backward": passes, "meme.step.optimizer": 1}
    (step,) = [e for e in events if e.name == "meme.step"]
    phases = sorted((e for e in events if e.name.startswith("meme.step.")),
                    key=lambda e: e.time_range.start)
    assert all(_inside(e, step) for e in phases)
    assert [e.name.rsplit(".", 1)[1] for e in phases] == (
        ["forward", "backward"] * passes + ["optimizer"])
    # the phases do not overlap: each closes before the next opens
    assert all(a.time_range.end <= b.time_range.start
               for a, b in zip(phases, phases[1:]))
    # torch's own ops are recorded inside the phases
    ops = [e for e in prof.events() if e.name.startswith("aten::")
           and _inside(e, phases[-1])]
    assert ops
    assert not [e.name for e in events if e.is_user_annotation]


@pytest.mark.parametrize("fuse_accum", [False, True],
                         ids=["scan_accum", "fused_accum"])
def test_train_step_numbers_same_under_the_profiler(fuse_accum):
    """Two steps with dropout on: losses, probabilities and every
    parameter bit for bit the same with the ranges recorded and not."""
    la, pa, sa, _ = _train(fuse_accum, profiled=False, steps=2)
    lb, pb, sb, _ = _train(fuse_accum, profiled=True, steps=2)
    assert torch.equal(la, lb) and torch.equal(pa, pb)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


def test_fold_train_step_ranges():
    """The fold-stacked step (F 2) opens the same phases."""
    models = [_model(seed) for seed in (0, 1)]
    stack = FoldStack.from_models(iter(models), 2)
    opt = Optimizer("adam", 1e-3, lambda s: 1.0, folds=2)
    state = TrainState(stack, opt.init(stack.params))
    step = make_fold_train_step(stack, TL.make_loss_fn("bce_logits", 1.8),
                                opt, accum_steps=2)
    host = [stack_for_accum([_micro(10 * f), _micro(10 * f + 1)])
            for f in range(2)]
    batch = {k: torch.from_numpy(np.stack([h[k] for h in host]))
             for k in KEYS}
    gens = [dropout_generator(f, 0, "cpu") for f in range(2)]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, batch, gens)
    events = _events(prof)
    assert _counts(events) == {"meme.step": 1, "meme.step.forward": 2,
                               "meme.step.backward": 2,
                               "meme.step.optimizer": 1}
    (outer,) = [e for e in events if e.name == "meme.step"]
    assert all(_inside(e, outer) for e in events)


@pytest.fixture(scope="module")
def pretrain_batches(tmp_path_factory):
    """Two host ITM batches ``[accum 2, B 3, ...]`` of a synthetic corpus
    and the corpus's vocabulary size."""
    root = str(tmp_path_factory.mktemp("pretrain_tracing"))
    paths = make_synthetic_dataset(root, n_train=12, n_dev=4, img_dim=16)
    tok = BertTokenizer(paths["vocab"])
    ds = pretrain_corpus(root, paths["feature_dir"], tok, max_txt_len=8,
                         max_bb=6, img_dim=16)
    np.random.seed(0)
    loader = iter(build_task_loaders(TrainConfig(batch_size=3), ds, tok,
                                     {"itm": 1}, 0.15, 0.5, 0.15)["itm"])
    return ([stack_for_accum([next(loader), next(loader)])
             for _ in range(2)], tok.vocab_size)


def _pretrain(batches, vocab_size, fuse_accum, profiled):
    """One ITM step (with the OT term) a host batch through
    ``PretrainTrainer.step``, dropout on, as the trainer feeds them.
    Returns (losses, parameters, profiler)."""
    model = init_pretrain_model(UniterConfig(**dict(TINY,
                                                    vocab_size=vocab_size)),
                                8, "cpu", torch_generator(0, "cpu"))
    trainer = PretrainTrainer(
        TrainConfig(gradient_accumulation=2, fuse_accum=fuse_accum), model,
        None, steps_per_epoch=2, ot_weight=0.1)
    prof = profile(activities=[ProfilerActivity.CPU]) if profiled else None
    if prof is not None:
        prof.start()
    losses = [trainer.step("itm", to_device(host, "cpu", keys=host),
                           dropout_generator(7, trainer.state.step, "cpu"))
              for host in batches]
    if prof is not None:
        prof.stop()
    return (torch.stack(losses),
            {k: v.detach().clone() for k, v in model.state_dict().items()},
            prof)


@pytest.mark.parametrize("fuse_accum", [False, True],
                         ids=["scan_accum", "fused_accum"])
def test_pretrain_step_ranges(pretrain_batches, fuse_accum):
    """A pretraining step opens the fine-tune step's ranges: ``meme.step``
    around a forward and a backward a micro-batch (one of each fused) and
    one optimizer phase, in order and apart."""
    batches, vocab_size = pretrain_batches
    *_, prof = _pretrain(batches[:1], vocab_size, fuse_accum, profiled=True)
    events = _events(prof, "meme.step")
    passes = 1 if fuse_accum else 2
    assert _counts(events) == {
        "meme.step": 1, "meme.step.forward": passes,
        "meme.step.backward": passes, "meme.step.optimizer": 1}
    (step,) = [e for e in events if e.name == "meme.step"]
    phases = sorted((e for e in events if e.name != "meme.step"),
                    key=lambda e: e.time_range.start)
    assert all(_inside(e, step) for e in phases)
    assert [e.name.rsplit(".", 1)[1] for e in phases] == (
        ["forward", "backward"] * passes + ["optimizer"])
    assert all(a.time_range.end <= b.time_range.start
               for a, b in zip(phases, phases[1:]))
    assert not [e.name for e in events if e.is_user_annotation]


@pytest.mark.parametrize("fuse_accum", [False, True],
                         ids=["scan_accum", "fused_accum"])
def test_pretrain_numbers_same_under_the_profiler(pretrain_batches,
                                                  fuse_accum):
    """Two pretraining steps with dropout on: the losses and every
    parameter bit for bit the same with the ranges recorded and not."""
    batches, vocab_size = pretrain_batches
    la, sa, _ = _pretrain(batches, vocab_size, fuse_accum, profiled=False)
    lb, sb, _ = _pretrain(batches, vocab_size, fuse_accum, profiled=True)
    assert la.shape == (2, 2) and torch.equal(la, lb)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)


@pytest.fixture(scope="module")
def scoring(tmp_path_factory):
    """A labelled 12-meme split (3 batches of 4) and its dataset."""
    root = str(tmp_path_factory.mktemp("tracing"))
    paths = make_synthetic_dataset(root, n_train=4, n_dev=12, n_test=4,
                                   img_dim=16, n_confounder_pairs=1)
    vocab = make_vocab(root + "/vocab.txt")
    ds = MemeDataset(paths["dev_seen"], feature_dir=paths["feature_dir"],
                     tokenizer=BertTokenizer(vocab), max_txt_len=8,
                     max_bb=6, img_dim=16, return_ids=True)
    return ds, root


def _predict(ds, root, profiled):
    trainer = Trainer(TrainConfig(model_path=root, batch_size=4), _model(),
                      None, None)
    loader = BatchLoader(ds, 4)
    assert len(loader) == 3
    if not profiled:
        return trainer.predict(loader)[0], None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        probs = trainer.predict(loader)[0]
    return probs, prof


def test_predict_ranges(scoring):
    """A scoring pass of 3 batches: the order once, a batch, an upload and
    a forward a batch, one fetch at the end (the in-flight window is not
    reached); a batch's range closes before the batch is uploaded."""
    _, prof = _predict(*scoring, profiled=True)
    events = _events(prof)
    assert _counts(events) == {
        "meme.loader.order": 1, "meme.loader.batch": 3, "meme.upload": 3,
        "meme.eval.forward": 3, "meme.eval.fetch": 1}
    by_start = sorted(events, key=lambda e: e.time_range.start)
    names = [e.name for e in by_start]
    assert names == (["meme.loader.order"]
                     + ["meme.loader.batch", "meme.upload",
                        "meme.eval.forward"] * 3 + ["meme.eval.fetch"])
    assert all(a.time_range.end <= b.time_range.start
               for a, b in zip(by_start, by_start[1:]))
    assert not [e.name for e in events if e.is_user_annotation]


def test_predict_numbers_same_under_the_profiler(scoring):
    a, _ = _predict(*scoring, profiled=False)
    b, _ = _predict(*scoring, profiled=True)
    assert a.shape == (12,) and np.array_equal(a, b)


def test_eval_pipeline_fetch_ranges():
    """Oldest-first fetches beyond the window, then the tail: one range a
    fetch."""
    pipe = EvalPipeline(window=1)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(3):
            pipe.add(torch.full((2,), float(i)))
        out = pipe.results()
    assert [o.tolist() for o in out] == [[0.0] * 2, [1.0] * 2, [2.0] * 2]
    assert _counts(_events(prof)) == {"meme.eval.fetch": 3}


def test_train_main_fetches_once_an_epoch(scoring):
    """``Trainer.train_main``'s host sync is one ``meme.train.fetch`` an
    epoch, and each step's phases sit inside its ``meme.step``."""
    ds, root = scoring
    cfg = TrainConfig(model_path=root, batch_size=4, max_epoch=2,
                      gradient_accumulation=2, optimizer="adam", lr=1e-3)
    train = BatchLoader(ds, 4, shuffle_data=True)
    trainer = Trainer(cfg, _model(), train, BatchLoader(ds, 4))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_main()
    counts = _counts(_events(prof))
    assert counts["meme.train.fetch"] == 2
    assert counts["meme.step"] == 4  # 3 batches: 2 groups an epoch
    assert counts["meme.step.optimizer"] == 4
    assert counts["meme.step.forward"] == counts["meme.step.backward"] == 8
