"""PyTorch port, the fold-parallel slice: ``parallel/{mesh,fold_parallel,
crossval_parallel}.py``, ``models.uniter.FoldStack``, the fold-stacked
train step, per-fold clipping and the attention wrappers' ``folds``
argument.

- F 1 against the port's own sequential ``Trainer`` with dropout on (the
  same generator streams): probabilities within 1e-6, parameters after two
  steps within 1e-5 of each tensor's largest magnitude, the same
  early-stopping epoch; both attention kernels, per-micro and
  ``fuse_accum``.
- F 3 against JAX ``FoldParallelTrainer`` (mesh None, JAX on the CPU with
  its Pallas kernels in interpret mode), dropout off, SGD with momentum:
  per-fold validation probabilities within 1e-5 and parameters within 2e-5
  of each tensor's largest magnitude after every epoch, and equal
  early-stopping arrays; per-sample and pair-blocked attention, host-batch
  and device-resident loaders.
- Unequal folds cycle; a stopped fold keeps its snapshot; kill-and-resume
  is bit-equal; the shared-loader export equals the stacked one and hits
  the upload cache; per-fold clipping; per-fold block seeds.
- The CLI with ``--mesh_shape 1 --mesh_axes fold`` against the port's
  sequential CLI and JAX ``train_crossval_fold_parallel``, and the meshes
  the port refuses.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from torch_parity import SMALL

from meme_challenge_tpu.core.config import (
    TrainConfig as JaxTrainConfig,
    UniterConfig as JaxUniterConfig,
)
from meme_challenge_tpu.core.seeding import set_seed as jax_set_seed
from meme_challenge_tpu.data.meme_dataset import (
    BatchLoader as JaxBatchLoader,
    MemeDataset as JaxMemeDataset,
)
from meme_challenge_tpu.data.tokenizer import BertTokenizer as JaxTokenizer
from meme_challenge_tpu.models.uniter import MemeUniter as JaxMemeUniter
from meme_challenge_tpu.ops import attention as JA
from meme_challenge_tpu.parallel.fold_parallel import (
    FoldParallelTrainer as JaxFoldParallelTrainer,
)
from meme_challenge_tpu.utils.synthetic import make_synthetic_dataset
from meme_challenge_tpu_torch.core.config import TrainConfig, UniterConfig
from meme_challenge_tpu_torch.core.seeding import (
    dropout_generator,
    fold_seed,
    set_seed,
    torch_generator,
)
from meme_challenge_tpu_torch.data.meme_dataset import BatchLoader, MemeDataset
from meme_challenge_tpu_torch.data.tokenizer import BertTokenizer
from meme_challenge_tpu_torch.models.convert import fold_stack_state_from_jax
from meme_challenge_tpu_torch.models.uniter import FoldStack, init_meme_uniter
from meme_challenge_tpu_torch.ops import attention as A
from meme_challenge_tpu_torch.parallel.fold_parallel import FoldParallelTrainer
from meme_challenge_tpu_torch.parallel.mesh import make_mesh
from meme_challenge_tpu_torch.train.optim import Optimizer
from meme_challenge_tpu_torch.train.steps import to_device
from meme_challenge_tpu_torch.train.trainer import Trainer

TXT, BB = 8, 8
ATTENTION = {"per_sample": dict(use_pallas_attention=True),
             "blocked": dict(use_pallas_attention=True, pallas_blocked=True)}
NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    """The tensors here are tiny, and the suite runs several workers side by
    side: one intra-op thread a worker keeps them from contending."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return make_synthetic_dataset(
        str(tmp_path_factory.mktemp("fold_parallel") / "d"), n_train=32,
        n_dev=16, n_test=8, img_dim=SMALL["img_dim"], seed=5,
        label_signal=2.0)


def _loader(synth, name, batch=4, shuffle=False, index=False, port=True):
    cls, ds_cls, tok_cls = ((BatchLoader, MemeDataset, BertTokenizer) if port
                            else (JaxBatchLoader, JaxMemeDataset,
                                  JaxTokenizer))
    ds = ds_cls(os.path.join(synth["root"], name + ".jsonl"),
                feature_dir=synth["feature_dir"],
                tokenizer=tok_cls(synth["vocab"]), max_txt_len=TXT,
                max_bb=BB, img_dim=SMALL["img_dim"],
                return_ids=True)
    return cls(ds, batch, shuffle_data=shuffle, index_batches=index)


def _config(synth, tmp_path, cls=TrainConfig, **kw):
    base = dict(data_path=synth["root"], feature_path=synth["feature_dir"],
                model_path=str(tmp_path), model_save_name="fp.ckpt",
                lr=3e-3, batch_size=4, max_epoch=2, patience=5,
                warmup_steps=2, gradient_accumulation=2, max_txt_len=TXT,
                max_bb=BB, seed=43, adam_mu_dtype="float32",
                adam_nu_dtype="float32")
    base.update(kw)
    return cls(**base)


def _stack(ucfg, seeds):
    return FoldStack.from_models(
        (init_meme_uniter(ucfg, 1, "cpu", torch_generator(s, "cpu"))
         for s in seeds), len(seeds))


def _worst_rel(got, ref) -> tuple:
    """(worst name, max |got − ref| over the largest magnitude of ref) over
    two state dicts. A tensor that is zero up to rounding (the key bias:
    softmax ignores a shift of a whole score row, so its gradient is
    rounding noise) is held to a thousandth of the model's largest
    magnitude instead, as chip_smoke.py holds gradients."""
    ref = {k: np.asarray(v, np.float64) for k, v in ref.items()}
    top = max(np.abs(v).max() for v in ref.values())
    worst = (None, 0.0)
    for k, b in ref.items():
        a = np.asarray(got[k], np.float64)
        rel = np.abs(a - b).max() / max(np.abs(b).max(), 1e-3 * top)
        worst = max(worst, (k, float(rel)), key=lambda x: x[1])
    return worst


# ------------------------------------------------ F 1 against the Trainer


@pytest.mark.parametrize("fuse", [False, True], ids=["per_micro", "fused"])
@pytest.mark.parametrize("attention", sorted(ATTENTION))
def test_f1_equals_sequential_trainer(synth, tmp_path, attention, fuse):
    """Dropout on: fold 0's generator at step k is the sequential run's
    (seeded fold_seed(seed, 0)) at step k, so the two runs draw the same
    masks and kernel seeds. SGD with momentum: Adam would turn the key
    bias's gradient, zero up to rounding, into steps of either sign."""
    ucfg = UniterConfig(**SMALL, **ATTENTION[attention])
    cfg = _config(synth, tmp_path, fuse_accum=fuse, max_epoch=4, patience=1,
                  optimizer="sgd", lr=0.05)
    seq_cfg = cfg.replace(seed=fold_seed(cfg.seed, 0),
                          model_save_name="seq.ckpt")

    def build():
        seq = Trainer(seq_cfg, init_meme_uniter(
            ucfg, 1, "cpu", torch_generator(7, "cpu")),
            _loader(synth, "train"), _loader(synth, "dev_seen"))
        par = FoldParallelTrainer(cfg, _stack(ucfg, [7]),
                                  [_loader(synth, "train")],
                                  [_loader(synth, "dev_seen")])
        return seq, par

    seq, par = build()
    groups = list(seq._device_batches(seq.train_loader))[:2]
    for host in groups:
        batch = to_device(host, "cpu", keys=list(host))
        seq.state, _ = seq.train_step(
            seq.state, batch,
            dropout_generator(seq_cfg.seed, seq.state.step, "cpu"))
        par._step({k: v[None] for k, v in batch.items()})
    name, rel = _worst_rel(
        {k: v[0].detach() for k, v in par.model.params.items()},
        {k: v.detach() for k, v in seq.model.named_parameters()})
    assert rel <= 1e-5, (name, rel)
    seq_probs, _, _ = seq._run_pass(seq.val_loader, keep_ids=False)
    par_probs, _ = par._stacked_pass(par.val_loaders, None, "val", "labels")
    np.testing.assert_allclose(par_probs[0], np.concatenate(seq_probs),
                               atol=1e-6, rtol=0)

    # whole runs: early stopping at the same epoch (patience 1)
    seq, par = build()
    calls = {"seq": 0, "par": 0}
    seq_eval, par_eval = seq.eval_model, par.eval_folds

    def count(who, fn):
        def wrapped(*a, **kw):
            calls[who] += 1
            return fn(*a, **kw)
        return wrapped

    seq.eval_model = count("seq", seq_eval)
    par.eval_folds = count("par", par_eval)
    seq_best, _ = seq.train_main()
    par_best = par.train_main()[0]
    assert calls["seq"] == calls["par"]
    assert seq.terminate_training == bool(par.done[0])
    assert abs(seq_best["aucroc"] - par_best["aucroc"]) <= 1e-6


# ------------------------------------------------ F 3 against JAX


def _jax_params(ucfg, synth, n_folds):
    model = JaxMemeUniter(ucfg, n_classes=1)
    example = _loader(synth, "dev_seen", port=False).example_batch()
    trees = [jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.key(f, impl="threefry2x32"), example,
        deterministic=True)["params"]) for f in range(n_folds)]
    return model, trees


@pytest.mark.parametrize("index", [False, True], ids=["host", "resident"])
@pytest.mark.parametrize("attention", sorted(ATTENTION))
def test_f3_equals_jax_fold_parallel_trainer(synth, tmp_path, attention,
                                             index):
    F = 3
    extra = dict(**ATTENTION[attention], **NO_DROPOUT)
    jax_ucfg = JaxUniterConfig(**SMALL, **extra)
    kw = dict(optimizer="sgd", lr=0.05, max_epoch=2, patience=1,
              early_stop_thresh=0.02)
    model, trees = _jax_params(jax_ucfg, synth, F)
    records = {"jax": [], "port": []}

    def recorder(who, base):
        class Recording(base):
            def eval_folds(self):
                live = self.best_params
                self.best_params = (self.state.params if who == "jax"
                                    else self.model.params)
                try:
                    probs, _ = self.predict_folds(self.val_loaders)
                finally:
                    self.best_params = live
                params = (fold_stack_state_from_jax(
                    jax.tree_util.tree_map(np.asarray, self.state.params))
                    if who == "jax" else
                    {k: v.detach().clone() for k, v in
                     self.model.params.items()})
                records[who].append([probs, params])
                return super().eval_folds()

            def _early_stopping_update(self, metrics):
                super()._early_stopping_update(metrics)
                records[who][-1].append((self.best_metric.copy(),
                                         self.not_improved.copy(),
                                         self.done.copy()))
        return Recording

    # the same loaders in both packages: shuffle off, each fold its own
    # train set (of unequal lengths: the shorter ones cycle), val sets of
    # equal length
    names = ["train", "dev_unseen", "dev_seen"]
    jax_set_seed(1)
    jax_tr = recorder("jax", JaxFoldParallelTrainer)(
        _config(synth, tmp_path, JaxTrainConfig, **kw), model,
        jax.tree_util.tree_map(lambda *x: np.stack(x), *trees),
        [_loader(synth, n, port=False, index=index) for n in names],
        [_loader(synth, "dev_seen", port=False, index=index)
         for _ in names])
    jax_tr.train_main()
    set_seed(1)
    port_tr = recorder("port", FoldParallelTrainer)(
        _config(synth, tmp_path, **kw),
        FoldStack(UniterConfig(**SMALL, **extra), 1,
                  fold_stack_state_from_jax(trees)),
        [_loader(synth, n, index=index) for n in names],
        [_loader(synth, "dev_seen", index=index) for _ in names])
    port_tr.train_main()

    assert len(records["jax"]) == len(records["port"]) >= 2
    for (jp, jparams, jstop), (pp, pparams, pstop) in zip(records["jax"],
                                                          records["port"]):
        for f in range(F):
            np.testing.assert_allclose(pp[f], jp[f], atol=1e-5, rtol=0)
        assert set(jparams) == set(pparams)
        name, rel = _worst_rel(pparams, jparams)
        assert rel <= 2e-5, (name, rel)
        for a, b in zip(pstop, jstop):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------ driver behaviour


def _small_trainer(synth, tmp_path, F=2, train=None, val=None, **kw):
    ucfg = UniterConfig(**SMALL, use_pallas_attention=True)
    cfg = _config(synth, tmp_path, **kw)
    return FoldParallelTrainer(
        cfg, _stack(ucfg, list(range(F))),
        train or [_loader(synth, "train") for _ in range(F)],
        val or [_loader(synth, "dev_seen") for _ in range(F)])


def test_unequal_folds_cycle(synth, tmp_path):
    """A shorter fold restarts its stream instead of cutting the longer
    fold's epoch (JAX test_fold_parallel_cycles_unequal_folds)."""
    full = _loader(synth, "train")
    short_ds = _loader(synth, "train")
    half = list(iter(short_ds))[:max(1, len(short_ds) // 2)]

    class HalfLoader:
        dataset = short_ds.dataset
        iterations = 0

        def __iter__(self):
            HalfLoader.iterations += 1
            return iter([dict(b) for b in half])

        def __len__(self):
            return len(half)

    tr = _small_trainer(synth, tmp_path, train=[full, HalfLoader()],
                        max_epoch=1, gradient_accumulation=1)
    tr.train_main()
    assert tr.state.step == len(full)
    assert HalfLoader.iterations == -(-len(full) // len(half))


def test_stopped_fold_keeps_its_snapshot(synth, tmp_path):
    """Fold 0 stops after epoch 2 (patience 1): its best snapshot stays the
    epoch-1 weights while its live weights and fold 1 train on."""
    tr = _small_trainer(synth, tmp_path, max_epoch=3, patience=1)
    script = iter([[0.6, 0.6], [0.5, 0.7], [0.9, 0.8]])
    after = []

    def scripted_eval():
        after.append({k: v.detach().clone()
                      for k, v in tr.model.params.items()})
        return [{"aucroc": a, "loss": 1.0} for a in next(script)]

    tr.eval_folds = scripted_eval
    tr.train_main()
    np.testing.assert_array_equal(tr.done, [True, False])
    np.testing.assert_array_equal(tr.not_improved, [1, 0])
    assert tr.fold_val_metrics[0]["aucroc"] == 0.6
    assert tr.fold_val_metrics[1]["aucroc"] == 0.8
    for k, best in tr.best_params.items():
        assert torch.equal(best[0], after[0][k][0]), k
        assert torch.equal(best[1], after[2][k][1]), k
    moved = [k for k in tr.best_params
             if not torch.equal(tr.model.params[k][0], after[0][k][0])]
    assert moved, "the stopped fold kept training"


def test_kill_and_resume_is_bit_equal(synth, tmp_path):
    """Shuffled loaders and dropout on: a run killed after epoch 2 and
    resumed in a fresh trainer (weights clobbered) ends with the
    uninterrupted run's weights, snapshot and metrics, bit for bit."""
    ck = str(tmp_path / "resume.pt")

    def build(seed=0):
        set_seed(11)
        ucfg = UniterConfig(**SMALL, use_pallas_attention=True)
        return FoldParallelTrainer(
            _config(synth, tmp_path, max_epoch=4),
            _stack(ucfg, [seed, seed + 1]),
            [_loader(synth, "train", shuffle=True) for _ in range(2)],
            [_loader(synth, "dev_seen") for _ in range(2)])

    full = build()
    full_metrics = full.train_main()
    part = build()
    part.config = part.config.replace(max_epoch=2)
    part.train_main(checkpoint_path=ck)
    resumed = build(seed=5)
    resumed.load_checkpoint(ck)
    assert resumed.start_epoch == 3 and resumed.state.step == part.state.step
    assert resumed.train_main() == full_metrics
    for k in full.model.params:
        assert torch.equal(resumed.model.params[k], full.model.params[k]), k
        assert torch.equal(resumed.best_params[k], full.best_params[k]), k
    np.testing.assert_array_equal(resumed.best_metric, full.best_metric)


def test_shared_loader_export_and_upload_cache(synth, tmp_path):
    """``predict_folds([loader] * F)`` iterates the loader once and equals
    the stacked per-fold path; device-resident datasets upload once, and a
    second call hits the cache."""
    F = 2
    tr = _small_trainer(
        synth, tmp_path, F=F, max_epoch=1,
        train=[_loader(synth, "train", index=True) for _ in range(F)],
        val=[_loader(synth, "dev_seen", index=True) for _ in range(F)])
    tr.train_main()
    uploads, iterations = [], []

    class Counting(BatchLoader):
        def __iter__(self):
            iterations.append(1)
            return super().__iter__()

    ds = _loader(synth, "test_seen").dataset
    arrays = ds.device_arrays
    ds.device_arrays = lambda: uploads.append(1) or arrays()
    shared = Counting(ds, 4, index_batches=True)
    p1, i1 = tr.predict_folds([shared] * F)
    assert len(iterations) == 1 and len(uploads) == 1
    p2, i2 = tr.predict_folds([shared] * F)
    assert len(uploads) == 1, "the second export re-uploaded its dataset"
    separate = [_loader(synth, "test_seen", index=True) for _ in range(F)]
    p3, i3 = tr.predict_folds(separate)
    for f in range(F):
        np.testing.assert_array_equal(i1[f], i3[f])
        np.testing.assert_array_equal(p1[f], p2[f])
        np.testing.assert_allclose(p1[f], p3[f], atol=1e-6, rtol=0)
    assert not np.allclose(p1[0], p1[1]), "folds predicted alike"


@pytest.mark.parametrize("name", ["adam", "sgd"])
def test_per_fold_clipping(name):
    """Fold 0's gradient norm exceeds max_grad_norm, fold 1's does not: each
    fold's update equals a one-fold update with its own gradient."""
    rng = np.random.RandomState(0)
    shapes = [(4, 3), (5,), (2, 2, 2)]
    params = {"w%d" % i: rng.randn(2, *s).astype(np.float32)
              for i, s in enumerate(shapes)}
    grads = {k: rng.randn(*v.shape).astype(np.float32) for k, v in
             params.items()}
    for k in grads:
        grads[k][0] *= 10.0
        grads[k][1] *= 0.01
    norms = [np.sqrt(sum((g[f] ** 2).sum() for g in grads.values()))
             for f in range(2)]
    assert norms[0] > 1.0 > norms[1]
    kw = dict(beta1=0.9, beta2=0.999, max_grad_norm=1.0)
    stacked = {k: torch.tensor(v) for k, v in params.items()}
    opt = Optimizer(name, 0.1, lambda s: 1.0, folds=2, **kw)
    state = opt.init(stacked)
    for _ in range(2):
        opt.step(stacked, {k: torch.tensor(v) for k, v in grads.items()},
                 state)
    for f in range(2):
        single = {k: torch.tensor(v[f]) for k, v in params.items()}
        one = Optimizer(name, 0.1, lambda s: 1.0, **kw)
        st = one.init(single)
        for _ in range(2):
            one.step(single, {k: torch.tensor(v[f]) for k, v in
                              grads.items()}, st)
        for k in params:
            torch.testing.assert_close(stacked[k][f], single[k], rtol=0,
                                       atol=1e-7)


def test_blocked_seeds_are_per_fold():
    """B 1, H 12, F 3: the block is that of one fold's 12 pairs (not
    _largest_block(36) = 18) and the seeds are F × blocked_seed_count(1, 12),
    fold-major: the fold-stacked call equals three separate calls, forward
    and backward, and JAX's vmap of its pair-blocked kernel."""
    F, H, S, D = 3, 12, 8, 8
    assert A._largest_block(F * H) != A._largest_block(H)
    assert A.blocked_seed_count(F, H, folds=F) == F * A.blocked_seed_count(
        1, H)
    rng = np.random.RandomState(0)
    q, k, v, do = (rng.randn(F, H, S, D).astype(np.float32)
                   for _ in range(4))
    bias = np.zeros((F, 1, 1, S), np.float32)
    bias[:, ..., 6:] = -10000.0
    seeds = rng.randint(0, 2 ** 31 - 1, (A.blocked_seed_count(F, H, F),)
                        ).astype(np.int32)
    rate, scale = 0.3, D ** -0.5

    def run(qq, kk, vv, b, s, folds, dd):
        leaves = [torch.tensor(x, requires_grad=True) for x in (qq, kk, vv)]
        out = A.fused_attention_blocked(*leaves, torch.tensor(b), scale,
                                        rate, torch.tensor(s), folds=folds)
        grads = torch.autograd.grad(out, leaves, torch.tensor(dd))
        return [out.detach().numpy()] + [g.numpy() for g in grads]

    stacked = run(q, k, v, bias, seeds, F, do)
    n = A.blocked_seed_count(1, H)
    for f in range(F):
        sl = slice(f, f + 1)
        single = run(q[sl], k[sl], v[sl], bias[sl],
                     seeds[f * n:(f + 1) * n], 1, do[sl])
        for a, b in zip(stacked, single):
            np.testing.assert_array_equal(a[sl], b)
    ref = jax.vmap(lambda a, b, c, m, s: JA.fused_attention_blocked(
        a, b, c, m, scale, rate, s))(
        q[:, None], k[:, None], v[:, None], bias[:, None],
        seeds.reshape(F, n))
    np.testing.assert_allclose(stacked[0], np.asarray(ref)[:, 0], atol=1e-6,
                               rtol=0)


# ------------------------------------------------ the CLI


@pytest.mark.parametrize("shape,axes", [("2", "fold"), ("1,2", "fold,data"),
                                        ("1,2", "fold,model")])
def test_mesh_the_port_cannot_run_raises(shape, axes):
    """Without a process group the CLI refuses, before it reads any data, a
    mesh of more than one device, and names torchrun."""
    from meme_challenge_tpu_torch.train import train_uniter

    with pytest.raises(ValueError, match="torchrun"):
        train_uniter.main(["--vocab_file", "unused.txt", "--device", "cpu",
                           "--num_folds", "-1", "--mesh_shape", shape,
                           "--mesh_axes", axes])
    assert make_mesh((1,), ("fold",)).axis_names == ("fold",)
    assert make_mesh().shape == (1,)


# the encoder's attention branches (models/uniter.py), dropout on
BRANCHES = {"plain": {}, "bf16_scores": dict(attention_score_dtype="bfloat16"),
            **ATTENTION}


def _stacked_batch(F, seed=0):
    from torch_parity import make_batch

    batches = [make_batch(seed=seed + f, B=3) for f in range(F)]
    return batches, {k: torch.from_numpy(np.stack([b[k] for b in batches]))
                     for k in batches[0]}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_fold_stack_equals_per_fold_models(branch):
    """F 3, dropout on: fold f of the stack, given generator f, gives the
    logits and the gradients of fold f's own MemeUniter given the same
    generator (same draws in the same order: the embeddings' Bernoulli
    masks, the threshold masks and the kernels' seeds)."""
    F = 3
    ucfg = UniterConfig(**SMALL, **BRANCHES[branch])
    models = [init_meme_uniter(ucfg, 1, "cpu", torch_generator(s, "cpu"))
              for s in range(F)]
    stack = _stack(ucfg, list(range(F)))
    batches, sb = _stacked_batch(F)
    logits = stack(sb, deterministic=False, generators=[
        torch_generator(50 + f, "cpu") for f in range(F)])
    logits.sum().backward()
    for f, model in enumerate(models):
        out = model({k: torch.from_numpy(v) for k, v in batches[f].items()},
                    deterministic=False,
                    generator=torch_generator(50 + f, "cpu"))
        out.sum().backward()
        np.testing.assert_allclose(logits[f].detach(), out.detach(),
                                   atol=1e-6, rtol=0)
        name, rel = _worst_rel(
            {k: (v.grad[f] if v.grad is not None
                 else torch.zeros_like(v[f])) for k, v in
             stack.params.items()},
            {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()})
        assert rel <= 1e-5, (f, name, rel)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_fold_stack_remat_replays_every_folds_dropout(policy):
    """remat on a FoldStack with dropout on: each fold's generator state is
    set again for the recompute, so the gradients equal those without
    remat, bit for bit."""
    F = 2
    grads = {}
    for remat in (False, True):
        ucfg = UniterConfig(**SMALL, use_pallas_attention=True, remat=remat,
                            remat_policy=policy)
        stack = _stack(ucfg, [0, 1])
        gens = [torch_generator(7 + f, "cpu") for f in range(F)]
        for seed in (1, 2):  # the second micro-batch draws after the first
            _, sb = _stacked_batch(F, seed)
            stack(sb, deterministic=False, generators=gens).sum().backward()
        grads[remat] = {k: v.grad for k, v in stack.params.items()}
    for k, g in grads[False].items():
        if g is None:
            assert grads[True][k] is None, k
        else:
            assert torch.equal(grads[True][k], g), k


def test_cli_fold_parallel_matches_sequential_and_jax(tmp_path):
    """``--mesh_shape 1 --mesh_axes fold --num_folds -1 --crossval_use_dev``
    on the CPU: the port's sequential CLI's file names and CSV columns,
    JAX train_crossval_fold_parallel's file names, validation metrics,
    per-fold thresholds' CSV labels and ensemble weights (host EA), from
    one reference checkpoint with dropout off. Then JAX's per-fold flax
    dump loads into the port with JAX's logits; the meshes the port cannot
    run raise."""
    from meme_challenge_tpu.core.artifacts import load_predictions
    from meme_challenge_tpu.models.convert import save_reference_checkpoint
    from meme_challenge_tpu.parallel.crossval_parallel import (
        train_crossval_fold_parallel,
    )
    from meme_challenge_tpu.train.train_uniter import (
        build_entry,
        init_meme_uniter_params,
    )
    from meme_challenge_tpu_torch.models.convert import load_pretrained
    from meme_challenge_tpu_torch.train import train_uniter as port_cli
    from torch_parity import flax_params, jax_logits, make_batch, torch_logits

    ckpt = str(tmp_path / "start.pt")
    save_reference_checkpoint(ckpt, flax_params())
    kw = dict(model_save_name="cv.ckpt", max_epoch=2, patience=5, lr=3e-3,
              warmup_steps=2, gradient_accumulation=2, confounder_repeat=3,
              pos_wt=1.8, batch_size=4, max_txt_len=8, max_bb=8, seed=7,
              num_folds=-1, crossval_dev_size=8, crossval_use_dev=True,
              adam_mu_dtype="float32", adam_nu_dtype="float32")
    ucfg = dict(SMALL, use_pallas_attention=True, **NO_DROPOUT)
    ucfg_path = str(tmp_path / "uniter.json")
    with open(ucfg_path, "w") as f:
        json.dump(ucfg, f)
    dirs, results = {}, {}
    for who in ("jax", "port_seq", "port_fold"):
        synth = make_synthetic_dataset(
            str(tmp_path / ("data_" + who)), n_train=40, n_dev=20, n_test=9,
            img_dim=SMALL["img_dim"], seed=3, label_signal=0.7)
        dirs[who] = model_path = str(tmp_path / who)
        if who == "jax":
            jax_set_seed(7)
            cfg = JaxTrainConfig(data_path=synth["root"],
                                 feature_path=synth["feature_dir"],
                                 model_path=model_path,
                                 pretrained_model_file=ckpt, **kw)
            jax_u = JaxUniterConfig(**ucfg)
            lf, tl, _ = build_entry(cfg, jax_u, synth["vocab"])
            model = JaxMemeUniter(jax_u, n_classes=1)
            os.makedirs(model_path)
            results[who] = train_crossval_fold_parallel(
                cfg, model, lambda seed, ex: init_meme_uniter_params(
                    model, jax_u, cfg, jax.random.PRNGKey(seed), ex),
                lf, tl, num_folds=-1, dev_size=8, use_dev_set=True)
            continue
        argv = ["--vocab_file", synth["vocab"], "--uniter_config", ucfg_path,
                "--device", "cpu", "--data_path", synth["root"],
                "--feature_path", synth["feature_dir"], "--model_path",
                model_path, "--pretrained_model_file", ckpt]
        for k, v in kw.items():
            argv += (["--%s" % k] if v is True else ["--%s" % k, str(v)])
        if who == "port_fold":
            argv += ["--mesh_shape", "1", "--mesh_axes", "fold"]
        results[who] = port_cli.main(argv)

    files = {who: sorted(f for f in os.listdir(d) if "resume" not in f)
             for who, d in dirs.items()}
    assert files["port_fold"] == files["jax"] == files["port_seq"]
    assert os.path.isfile(os.path.join(dirs["port_fold"],
                                       "crossval_resume.pt"))
    n_folds = len(results["jax"]["val_metrics"])
    assert n_folds == len(results["port_fold"]["val_metrics"]) >= 2
    for a, b in zip(results["jax"]["val_metrics"],
                    results["port_fold"]["val_metrics"]):
        assert set(a) == set(b)
        for k in a:
            assert abs(a[k] - b[k]) <= 1e-5, (k, a[k], b[k])
    ens_j, ens_p = results["jax"]["ensemble"], results["port_fold"]["ensemble"]
    assert ens_p["config"] == ens_j["config"]
    assert abs(ens_p["threshold"] - ens_j["threshold"]) <= 1e-6
    for name in files["jax"]:
        if not name.endswith(".csv"):
            continue
        tables = {who: load_predictions(os.path.join(dirs[who], name))
                  for who in dirs}
        assert list(tables["port_fold"]) == list(tables["jax"]) == list(
            tables["port_seq"]), name
        a, b = tables["jax"], tables["port_fold"]
        np.testing.assert_array_equal(a["id"], b["id"])
        np.testing.assert_allclose(b["proba"], a["proba"], atol=2e-6,
                                   rtol=0, err_msg=name)
        if not name.endswith("_ensemble.csv"):
            # labels at 0.5 (validation) or the fold's own threshold
            np.testing.assert_array_equal(a["label"], b["label"],
                                          err_msg=name)
    for f in range(n_folds):
        with open(os.path.join(dirs["port_fold"],
                               "cv_fold_%d_metrics.json" % f)) as fh:
            assert set(json.load(fh)) == {"dev", "test"}

    # JAX's per-fold flax-msgpack dump → the port, logits to JAX's
    dump = os.path.join(dirs["jax"], "cv_fold_1.ckpt")
    from flax import serialization

    with open(dump, "rb") as fh:
        params = serialization.msgpack_restore(fh.read())["params"]
    model = init_meme_uniter(UniterConfig(**ucfg), 1, "cpu",
                             torch_generator(0, "cpu"))
    assert load_pretrained(model, dump) == "finetuned"
    batch = make_batch(seed=2)
    np.testing.assert_allclose(torch_logits(model.eval(), batch),
                               jax_logits(params, batch, **ATTENTION[
                                   "per_sample"]), atol=1e-5, rtol=0)
