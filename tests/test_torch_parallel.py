"""PyTorch port, the multi-device slice: ``parallel/mesh.py``,
``FoldParallelTrainer`` and the crossval driver over a ``torch.distributed``
mesh, and the attention kernels' seed shard (the plain versions).

The ranks run on this CPU over ``gloo`` (``tests/torch_parallel_ranks.py``),
spawned once for the module: a world of 2 ranks and one of 4, side by side,
each rank on one intra-op thread with a ``file://`` rendezvous under the
module's temporary directory and a timeout on every collective. The
oracles run here, meanwhile:

- the port's one-process ``FoldStack`` step (dropout on, SGD): a (2,) fold
  mesh and a (1, 2) fold × data mesh, each with a padded tail micro-batch
  whose valid rows differ between the data ranks, within 1e-6; a (1, 2, 2)
  fold × data × model step within 1e-5;
- JAX ``FoldParallelTrainer`` on the virtual mesh of the same shape, dropout
  off, weights carried by the converter: within 1e-5 of each tensor's
  largest magnitude;
- the one-process forward, dropout on, for a model-split forward: logits
  within 1e-5 (both kernels' plain versions and the plain branch);
- the one-process crossval driver: a 2-rank run writes the same CSVs, rank
  0 alone runs the ensemble search, and a 2-rank resume file resumes in one
  process to the same CSVs.
"""
import csv
import os
import subprocess
import sys
from glob import glob

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh, NamedSharding, PartitionSpec as P

import torch_parallel_ranks as R
from meme_challenge_tpu.core.config import (
    TrainConfig as JaxTrainConfig,
    UniterConfig as JaxUniterConfig,
)
from meme_challenge_tpu.models.uniter import MemeUniter as JaxMemeUniter
from meme_challenge_tpu.parallel import mesh as jax_mesh
from meme_challenge_tpu.parallel.fold_parallel import (
    FoldParallelTrainer as JaxFoldParallelTrainer,
)
from meme_challenge_tpu_torch.data.crossval_splits import (
    generate_crossval_splits,
)
from meme_challenge_tpu_torch.models.convert import (
    fold_stack_state_from_jax,
    meme_uniter_state_from_jax,
)
from meme_challenge_tpu_torch.ops import attention as A
from meme_challenge_tpu_torch.parallel import mesh as port_mesh
from meme_challenge_tpu_torch.utils.synthetic import make_synthetic_dataset

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
WORLDS = (2, 4)
RANK_TIMEOUT = 300  # seconds for a world's processes to finish


@pytest.fixture(autouse=True, scope="module")
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The ranks' inputs: the synthetic dataset with its fold splits, 4
    folds of JAX weights in the port's layout (``init.pt``) and one
    global step's batch ``[2 folds, 2 micro, 4 rows]`` (``batch.npz``) whose
    last micro-batch is a padded tail of one valid row."""
    d = str(tmp_path_factory.mktemp("parallel"))
    synth = make_synthetic_dataset(os.path.join(d, "data"), n_train=48,
                                   n_dev=16, n_test=8, img_dim=R.SMALL[
                                       "img_dim"], seed=5, label_signal=2.0)
    generate_crossval_splits(synth["root"], dev_size=8)
    model = JaxMemeUniter(JaxUniterConfig(**R.SMALL), n_classes=1)
    example = R.loader(synth["root"], "dev_seen").example_batch()
    trees = [jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.key(f, impl="threefry2x32"), example,
        deterministic=True)["params"]) for f in range(4)]
    torch.save(fold_stack_state_from_jax(trees), os.path.join(d, "init.pt"))
    folds = []
    for name in ("train", "dev_unseen"):
        micro = [dict(b) for b, _ in zip(R.loader(synth["root"], name),
                                         range(R.ACCUM))]
        for b in micro:
            b.pop("ids")
        folds.append({k: np.stack([b[k] for b in micro]) for k in micro[0]})
    batch = {k: np.stack([f[k] for f in folds]) for k in folds[0]}
    batch["sample_mask"][:, -1] = [1, 0, 0, 0]
    np.savez(os.path.join(d, "batch.npz"), **batch)
    return {"dir": d, "data": synth["root"], "trees": trees, "batch": batch}


class _Worlds:
    """The ranks of both worlds, started together; ``result(n)`` waits for
    world n and loads what its rank 0 saved."""

    def __init__(self, inputs: dict):
        self.out = os.path.join(inputs["dir"], "out")
        os.makedirs(self.out, exist_ok=True)
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join([ROOT, TESTS]))
        self.procs, self.logs, self.loaded = {}, {}, {}
        for n in WORLDS:
            store = os.path.join(inputs["dir"], "store%d" % n)
            self.procs[n] = []
            for rank in range(n):
                log = open(os.path.join(self.out, "world%d_rank%d.log"
                                        % (n, rank)), "w")
                self.logs[(n, rank)] = log
                self.procs[n].append(subprocess.Popen(
                    [sys.executable, os.path.join(TESTS,
                                                  "torch_parallel_ranks.py"),
                     str(n), str(rank), store, inputs["dir"], self.out],
                    stdout=log, stderr=subprocess.STDOUT, env=env,
                    cwd=ROOT))

    def result(self, n: int) -> dict:
        if n not in self.loaded:
            for rank, proc in enumerate(self.procs[n]):
                try:
                    rc = proc.wait(timeout=RANK_TIMEOUT)
                except subprocess.TimeoutExpired:
                    self.close()
                    rc = "timeout"
                if rc != 0:
                    with open(os.path.join(self.out, "world%d_rank%d.log"
                                           % (n, rank))) as f:
                        tail = f.read()[-3000:]
                    pytest.fail("world %d rank %d: %s\n%s"
                                % (n, rank, rc, tail))
            self.loaded[n] = torch.load(os.path.join(
                self.out, "world%d.pt" % n), weights_only=False)
        return self.loaded[n]

    def close(self) -> None:
        for procs in self.procs.values():
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait(timeout=30)
        for log in self.logs.values():
            log.close()


@pytest.fixture(scope="module")
def worlds(inputs):
    w = _Worlds(inputs)
    yield w
    w.close()


def _one_process_step(inputs, variant: str) -> dict:
    trainer = R.step_trainer(inputs["dir"], variant)
    R.one_step(trainer, inputs["batch"])
    return {k: v.detach().clone() for k, v in trainer.model.params.items()}


@pytest.fixture(scope="module")
def one_process_steps(worlds, inputs):
    return {v: _one_process_step(inputs, v) for v in ("per_sample",
                                                     "blocked")}


@pytest.fixture(scope="module")
def jax_steps(worlds, inputs):
    """One step of JAX ``FoldParallelTrainer`` on each step mesh of 2 virtual
    devices, dropout off: the fold-stacked parameters after it."""
    data = inputs["data"]
    ucfg = JaxUniterConfig(**R.SMALL, **R.NO_DROPOUT)
    cfg = R.train_config(data, os.path.join(inputs["dir"], "jax"))
    jcfg = JaxTrainConfig(**{f: getattr(cfg, f) for f in (
        "data_path", "feature_path", "model_path", "model_save_name", "lr",
        "optimizer", "batch_size", "max_epoch", "patience", "warmup_steps",
        "gradient_accumulation", "max_txt_len", "max_bb", "seed",
        "adam_mu_dtype", "adam_nu_dtype")})
    from meme_challenge_tpu.data.meme_dataset import (
        BatchLoader as JaxBatchLoader,
        MemeDataset as JaxMemeDataset,
    )
    from meme_challenge_tpu.data.tokenizer import BertTokenizer as JaxTok

    def jax_loader(name):
        ds = JaxMemeDataset(os.path.join(data, name + ".jsonl"),
                            feature_dir=os.path.join(data, "img_feats"),
                            tokenizer=JaxTok(os.path.join(data, "vocab.txt")),
                            max_txt_len=R.TXT, max_bb=R.BB,
                            img_dim=R.SMALL["img_dim"], return_ids=True)
        return JaxBatchLoader(ds, R.BATCH)

    stacked = jax.tree_util.tree_map(lambda *x: np.stack(x),
                                     *inputs["trees"][:R.FOLDS])
    out = {}
    for name, (shape, axes) in R.STEP_MESHES.items():
        mesh = jax_mesh.make_mesh(shape, axes,
                                  devices=jax.devices()[:np.prod(shape)])
        tr = JaxFoldParallelTrainer(
            jcfg, JaxMemeUniter(ucfg, n_classes=1), stacked,
            [jax_loader("train") for _ in range(R.FOLDS)],
            [jax_loader("dev_seen") for _ in range(R.FOLDS)], mesh=mesh)
        state, _ = tr._train_step(tr.state, inputs["batch"],
                                  jax.random.split(jax.random.key(0),
                                                   R.FOLDS), tr._train_data)
        out[name] = fold_stack_state_from_jax(
            jax.tree_util.tree_map(np.asarray, state.params))
    return out


def _abs_err(got: dict, ref: dict) -> tuple:
    assert set(got) == set(ref)
    return max(((k, float((got[k] - ref[k]).detach().abs().max()))
                for k in ref), key=lambda kv: kv[1])


def _rel_err(got: dict, ref: dict) -> tuple:
    """(worst name, max |got − ref| over ref's largest magnitude). A tensor
    that is zero up to rounding (the key bias: softmax ignores a shift of a
    whole score row) is held to a thousandth of the largest magnitude of
    all, as tests/test_torch_fold_parallel.py holds it."""
    assert set(got) == set(ref)
    top = max(float(v.abs().max()) for v in ref.values())
    return max(((k, float((got[k] - ref[k]).abs().max()
                          / max(float(ref[k].abs().max()), 1e-3 * top)))
                for k in ref), key=lambda kv: kv[1])


# ------------------------------------------------------------- the mesh


def test_make_mesh_checks_the_world_size(worlds):
    """Without a group one device: a wider mesh raises and names torchrun;
    in a 2-rank group a mesh of 4 raises."""
    assert port_mesh.make_mesh().shape == (1,)
    assert port_mesh.make_mesh((1, 1), ("fold", "data")).size == 1
    with pytest.raises(ValueError, match="torchrun"):
        port_mesh.make_mesh((2,), ("fold",), "cpu")
    assert "needs 4 devices, the run has 2" in worlds.result(2)["wrong_world"]


def _marker(shape, spec) -> np.ndarray:
    """A leaf that varies only along the dim its spec splits over
    ``model`` (0 elsewhere), so the converter carries the split dim."""
    dims = [d for d, a in enumerate(spec) if a == "model"]
    if not dims:
        return np.zeros(shape, np.float32)
    d = dims[0]
    view = [1] * len(shape)
    view[d] = shape[d]
    return np.broadcast_to(np.arange(1, shape[d] + 1, dtype=np.float32)
                           .reshape(view), shape).copy()


def _with_vocab(tree, vocab: int):
    """``tree`` with a word-embedding table of ``vocab`` rows."""
    if not isinstance(tree, dict):
        return tree
    return {k: (np.zeros((vocab,) + v.shape[1:], np.float32)
                if k == "word_embeddings" else _with_vocab(v, vocab))
            for k, v in tree.items()}


@pytest.mark.parametrize("model_size,vocab", [(2, 64), (2, 63), (4, 64)])
def test_param_specs_split_the_dims_jax_splits(inputs, model_size, vocab):
    """``uniter_param_specs`` + ``filter_divisible_specs`` on the port's
    names split the same dims as JAX's specs on the corresponding leaves
    (carried across by the converter); a vocabulary the model axis does not
    divide falls back to replication in both."""
    tree = _with_vocab(inputs["trees"][0], vocab)
    jmesh = JaxMesh(np.array(jax.devices()[:model_size]).reshape(
        1, 1, model_size), ("fold", "data", "model"))
    jspecs = jax_mesh.filter_divisible_specs(
        jmesh, tree, jax_mesh.uniter_param_specs(tree, model_axis="model"))
    markers = meme_uniter_state_from_jax(jax.tree_util.tree_map(
        lambda leaf, spec: _marker(leaf.shape, spec), tree, jspecs,
        is_leaf=lambda x: isinstance(x, P)))
    sd = meme_uniter_state_from_jax(tree)
    pmesh = port_mesh.Mesh((1, 1, model_size), ("fold", "data", "model"))
    specs = port_mesh.filter_divisible_specs(
        pmesh, sd, port_mesh.uniter_param_specs(sd, "model"))
    n_split = 0
    for name, m in markers.items():
        varying = [d for d in range(m.dim())
                   if m.dim() and (m != m.select(d, 0).unsqueeze(d)).any()]
        want = varying[0] if varying else None
        got = specs[name].get("model")
        assert (got.dim if got is not None else None) == want, name
        n_split += got is not None
    assert n_split > 0
    word = "uniter_model.embeddings.word_embeddings.weight"
    assert ("model" in specs[word]) == (vocab % model_size == 0)
    stacked = port_mesh.uniter_param_specs(sd, "model", fold_axis="fold")
    name = "uniter_model.encoder.layer.0.intermediate.dense.weight"
    assert stacked[name] == {"fold": port_mesh.Shard(0),
                             "model": port_mesh.Shard(1)}
    assert port_mesh.placements(pmesh, stacked[name]) == [
        port_mesh.Shard(0), port_mesh.Replicate(), port_mesh.Shard(1)]
    assert port_mesh.replicated(pmesh) == [port_mesh.Replicate()] * 3
    assert port_mesh.data_sharding(pmesh) == [
        port_mesh.Replicate(), port_mesh.Shard(0), port_mesh.Replicate()]


def test_uneven_folds_raise_as_jax(worlds):
    """3 folds over a fold axis of 2: JAX's fold-sharded device_put raises
    ValueError, and so does the port's trainer."""
    mesh = JaxMesh(np.array(jax.devices()[:2]), ("fold",))
    with pytest.raises(ValueError, match="divisible"):
        jax.device_put(np.zeros((3, 2)), NamedSharding(mesh, P("fold")))
    assert "do not split evenly" in worlds.result(2)["uneven"]


# ------------------------------------------------------------ the steps


@pytest.mark.parametrize("variant", ["per_sample", "blocked"])
@pytest.mark.parametrize("mesh", sorted(R.STEP_MESHES))
def test_split_step_equals_one_process_step(worlds, one_process_steps, mesh,
                                            variant):
    """Dropout on: a fold-split and a data-split step (the padded tail's
    valid rows on one data rank only) equal the one-process FoldStack step
    within 1e-6."""
    got = worlds.result(2)["%s/%s" % (mesh, variant)]
    name, err = _abs_err(got, one_process_steps[variant])
    assert err <= 1e-6, (name, err)


@pytest.mark.parametrize("mesh", sorted(R.STEP_MESHES))
def test_split_step_equals_jax_on_the_virtual_mesh(worlds, jax_steps, mesh):
    """Dropout off: the step equals JAX FoldParallelTrainer's on the virtual
    mesh of the same shape within 1e-5 of each tensor's largest magnitude."""
    name, err = _rel_err(worlds.result(2)["%s/off" % mesh], jax_steps[mesh])
    assert err <= 1e-5, (name, err)


@pytest.mark.parametrize("variant", ["per_sample", "blocked", "plain"])
def test_model_split_forward_equals_one_process(worlds, inputs, variant):
    """A model axis of 2 (each rank 2 of the 4 heads), dropout on: the
    logits equal the one-process forward within 1e-5."""
    res = worlds.result(2)
    trainer = R.step_trainer(inputs["dir"], variant)
    ref = R.forward_logits(trainer.model, inputs["batch"])
    assert res["model2/%s/heads" % variant] == R.SMALL["hidden_size"] // 2
    np.testing.assert_allclose(res["model2/%s" % variant].numpy(),
                               ref.numpy(), atol=1e-5, rtol=0)


def test_fold_data_model_mesh_trains(worlds, one_process_steps):
    """(1, 2, 2) on 4 ranks: the encoder, the word embeddings and
    img_linear split; the first step equals the one-process step within
    1e-5; 2 epochs give finite per-fold AUROC."""
    import json

    res = worlds.result(4)
    split = res["3axis/split"]
    for leaf in ("uniter_model.embeddings.word_embeddings.weight",
                 "uniter_model.img_embeddings.img_linear.weight",
                 "uniter_model.encoder.layer.1.attention.self.key.bias",
                 "uniter_model.encoder.layer.1.output.dense.weight"):
        assert leaf in split
    name, err = _abs_err(res["3axis/step"], one_process_steps["per_sample"])
    assert err <= 1e-5, (name, err)
    metrics = json.loads(res["3axis/metrics"])
    assert len(metrics) == R.FOLDS
    assert all(np.isfinite(m["aucroc"]) for m in metrics)


def test_four_folds_one_a_rank(worlds):
    """JAX test_eight_folds_one_per_device at 4 folds on 4 ranks: each rank
    holds one fold's weights, and 2 epochs give every fold finite AUROC."""
    import json

    res = worlds.result(4)
    assert res["fold4/ranks"] == [[[r], 1, 1] for r in range(4)]
    metrics = json.loads(res["fold4/metrics"])
    assert len(metrics) == 4 and all(np.isfinite(m["aucroc"])
                                     for m in metrics)


# -------------------------------------------------------- the crossval


def _csvs(path: str) -> dict:
    out = {}
    for p in sorted(glob(os.path.join(path, "*_fold_*_preds.csv"))):
        with open(p) as f:
            out[os.path.basename(p)] = list(csv.DictReader(f))
    return out


def _assert_same_csvs(got: dict, ref: dict) -> None:
    assert sorted(got) == sorted(ref) and got
    for name, rows in ref.items():
        assert [r["id"] for r in got[name]] == [r["id"] for r in rows], name
        np.testing.assert_allclose(
            [float(r["proba"]) for r in got[name]],
            [float(r["proba"]) for r in rows], atol=1e-6, rtol=0,
            err_msg=name)


@pytest.fixture(scope="module")
def one_process_crossval(worlds, inputs):
    path = os.path.join(inputs["dir"], "cv1")
    res = R.crossval(inputs["data"], path)
    return res, _csvs(path)


def test_two_rank_crossval_writes_the_one_process_csvs(worlds, inputs,
                                                       one_process_crossval):
    """A (2,) fold mesh runs the driver: the same per-fold CSVs (paths,
    rows, probabilities within 1e-6) and validation metrics as one process;
    rank 0 alone runs the ensemble search and writes its outputs."""
    import json

    res, ref = one_process_crossval
    ranks = worlds.result(2)
    _assert_same_csvs(_csvs(os.path.join(worlds.out, "cv2")), ref)
    assert ranks["cv2/ensemble_ran"] == [True, False]
    assert glob(os.path.join(worlds.out, "cv2", "*_ensemble.csv"))
    got = json.loads(ranks["cv2/val_metrics"])
    for a, b in zip(got, res["val_metrics"]):
        assert abs(a["aucroc"] - b["aucroc"]) <= 1e-6


@pytest.mark.parametrize("ranks", [1, 2])
def test_two_rank_resume_file_resumes(worlds, inputs, one_process_crossval,
                                      ranks):
    """The resume file of a 2-rank run stopped after epoch 1 resumes in one
    process, and on 2 ranks (each reading its part), to the CSVs of the
    uninterrupted one-process run."""
    worlds.result(2)
    path = os.path.join(worlds.out, "cv2_killed")
    assert os.path.isfile(os.path.join(path, "crossval_resume.pt"))
    if ranks == 1:
        assert not _csvs(path)
        R.crossval(inputs["data"], path)
    else:
        path = os.path.join(worlds.out, "cv2_resumed")
    _assert_same_csvs(_csvs(path), one_process_crossval[1])


def test_cli_over_two_ranks_writes_the_one_process_csvs(worlds, inputs):
    """``train_uniter --mesh_shape 2 --mesh_axes fold`` in a 2-rank group
    routes to the fold-parallel driver over the ranks and writes the CSVs
    of the one-process ``--mesh_shape 1`` run."""
    worlds.result(2)
    path = os.path.join(inputs["dir"], "cli1")
    R.cli_run(inputs["data"], path, ["--mesh_shape", "1", "--mesh_axes",
                                     "fold"])
    _assert_same_csvs(_csvs(os.path.join(worlds.out, "cli2")), _csvs(path))
    assert len(glob(os.path.join(worlds.out, "cli2", "*_ensemble.csv"))) \
        == len(glob(os.path.join(path, "*_ensemble.csv"))) > 0


# ------------------------------------------------- the kernels' seed shard


def test_hash_offset_equals_the_global_slice():
    """The plain hash of a (blk, S, S) index space at an offset is the
    slice of the larger space's bits that starts there, with one seed or
    one a row."""
    S = 9
    seeds = torch.tensor([7, -3, 2 ** 31 - 1], dtype=torch.int64)
    whole = A._hash_bits((6, S, S), seeds)
    for k in range(0, 5):
        np.testing.assert_array_equal(
            A._hash_bits((2, S, S), seeds, k * S * S),
            whole[:, k:k + 2])
    per_row = A._hash_bits((1, S, S), seeds, torch.tensor([0, 3, 5]) * S * S)
    for i, k in enumerate([0, 3, 5]):
        np.testing.assert_array_equal(per_row[i, 0], whole[i, k])


@pytest.mark.parametrize("blocked", [False, True], ids=["per_sample",
                                                         "blocked"])
def test_seed_shard_equals_the_whole_runs_slice(blocked):
    """A launch of some rows and heads of each fold (``SeedShard``) gives
    the whole launch's slice, forward and backward, with the same dropped
    positions: 2 folds of 6 rows and 4 heads, rows [2, 5) and heads [1, 3)
    (6·4 = 24 pairs a fold: one block; 3·2 = 6 local pairs would make other
    blocks)."""
    F_, B, H, S, D, rate = 2, 6, 4, 10, 8, 0.3
    gen = torch.Generator().manual_seed(0)
    q, k, v, do = (torch.randn(F_ * B, H, S, D, generator=gen)
                   for _ in range(4))
    bias = torch.zeros(F_ * B, 1, 1, S)
    if blocked:
        fn, n = A.fused_attention_blocked_plain, A.blocked_seed_count(
            F_ * B, H, F_)
    else:
        fn, n = A.fused_attention_plain, F_ * B
    seeds = torch.randint(0, 2 ** 31 - 1, (n,), generator=gen,
                          dtype=torch.int32)
    rows = [f * B + r for f in range(F_) for r in range(2, 5)]
    heads = slice(1, 3)
    part = [t[rows][:, heads].contiguous() for t in (q, k, v, do)]
    shard = A.SeedShard(2, B, 1, H)
    kw = dict(folds=F_)
    whole = fn(q, k, v, bias, 0.125, rate, seeds, **kw)
    got = fn(*part[:3], bias[rows], 0.125, rate, seeds, shard=shard, **kw)
    np.testing.assert_allclose(got, whole[rows][:, heads], atol=1e-6,
                               rtol=0)
    seed_map = A._seed_map(len(rows), 2, F_, shard, blocked)
    keep = A._pair_keep(len(rows), 2, S, rate, seeds, seed_map)
    group = A._seed_map(F_ * B, H, F_, None, blocked)
    keep_whole = A._pair_keep(F_ * B, H, S, rate, seeds, group)
    assert torch.equal(keep, keep_whole[rows][:, heads])
    assert 0 < int((~keep).sum()) < keep.numel()
    grads = A.fused_attention_bwd_plain(*part[:3], bias[rows], part[3],
                                        0.125, rate, seeds, seed_map)
    ref = A.fused_attention_bwd_plain(q, k, v, bias, do, 0.125, rate, seeds,
                                      group)
    for a, b in zip(grads, ref):
        np.testing.assert_allclose(a, b[rows][:, heads], atol=1e-6, rtol=0)


def test_resolve_device_under_torchrun(monkeypatch):
    """Under torchrun ``cuda`` is the process's own card."""
    from meme_challenge_tpu_torch.core.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert resolve_device("cuda") == torch.device("cuda", 3)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    monkeypatch.delenv("LOCAL_RANK")
    assert resolve_device("cuda") == torch.device("cuda")
