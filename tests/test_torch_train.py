"""PyTorch port, training: train/losses.py, train/schedules.py and
train/optim.py against the JAX functions and the optax chain over several
steps; the train step in both accumulation modes against the JAX step with
a padded final micro-batch (dropout off); a trainer epoch with two steps
an upload against one step an upload (dropout on); full-state resume;
scalar logs, the profiler trace and the training meta."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    SMALL,
    flax_params,
    make_batch,
    port_tree_from_jax,
    torch_model,
)

from meme_challenge_tpu.core.config import UniterConfig as JaxUniterConfig
from meme_challenge_tpu.models.uniter import MemeUniter as JaxMemeUniter
from meme_challenge_tpu.train import losses as JL
from meme_challenge_tpu.train import schedules as JS
from meme_challenge_tpu.train.optim import make_optimizer as jax_optimizer
from meme_challenge_tpu.train.steps import (
    create_train_state as jax_train_state,
    make_train_step as jax_train_step,
)
from meme_challenge_tpu_torch.train import losses as TL
from meme_challenge_tpu_torch.train import schedules as TS
from meme_challenge_tpu_torch.train.checkpoint import (
    load_train_state,
    save_train_state,
    save_training_meta,
)
from meme_challenge_tpu_torch.train.observability import (
    ScalarWriter,
    profile_trace,
)
from meme_challenge_tpu_torch.train.optim import (
    Optimizer,
    head_lr_scales,
    layer_freeze_scales,
    no_decay_mask,
)
from meme_challenge_tpu_torch.train.steps import (
    create_train_state,
    make_train_step,
)
from meme_challenge_tpu_torch.train.trainer import Trainer
from meme_challenge_tpu_torch.core.config import TrainConfig, UniterConfig
from meme_challenge_tpu_torch.core.seeding import dropout_generator
from meme_challenge_tpu_torch.data.meme_dataset import BatchLoader, MemeDataset
from meme_challenge_tpu_torch.data.tokenizer import BertTokenizer
from meme_challenge_tpu_torch.models.uniter import MemeUniter
from meme_challenge_tpu_torch.utils.synthetic import (
    make_synthetic_dataset,
    make_vocab,
)

NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)


# ------------------------------------------------------------------- losses

@pytest.mark.parametrize("mask", [[1, 1, 0, 1, 0], [0, 0, 0, 0, 0]],
                         ids=["partial", "padded"])
@pytest.mark.parametrize("loss_func", ["bce_logits", "bce", "ce"])
def test_losses_match_jax(loss_func, mask):
    rng = np.random.RandomState(0)
    n_cls = 2 if loss_func == "ce" else 1
    logits = (rng.randn(5, n_cls) * 4).astype(np.float32)
    labels = np.array([1, 0, 1, 1, 0], np.int32)
    mask = np.array(mask, np.int32)
    j_loss, j_probs = JL.make_loss_fn(loss_func, 1.8)(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))
    t_loss, t_probs = TL.make_loss_fn(loss_func, 1.8)(
        torch.from_numpy(logits), torch.from_numpy(labels),
        torch.from_numpy(mask))
    assert abs(t_loss.item() - float(j_loss)) <= 1e-6
    np.testing.assert_allclose(t_probs.numpy(), np.asarray(j_probs),
                               atol=1e-7, rtol=0)
    if not mask.any():
        assert t_loss.item() == 0.0


# ---------------------------------------------------------------- schedules

@pytest.mark.parametrize("name", ["step", "multi_step", "warmup",
                                  "warmup_cosine", "constant"])
def test_schedules_match_jax(name):
    kw = dict(warmup_steps=5, total_steps=30, lr_decay_step=3,
              lr_decay_factor=0.8)
    j, t = JS.make_schedule(name, **kw), TS.make_schedule(name, **kw)
    for step in range(45):
        ref = float(np.asarray(j(jnp.int32(step)), np.float32))
        assert abs(t(step) - ref) <= 1e-7, (step, t(step), ref)


# ---------------------------------------------------------------- optimizer

# flax leaf names of the decay mask's exclusions and what they become
def test_no_decay_mask_translates_the_jax_names():
    names = list(port_tree_from_jax(flax_params()))
    mask = no_decay_mask(names)
    off = sorted(n for n, d in mask.items() if not d)
    assert all(n.endswith("bias") or n.endswith("LayerNorm.weight")
               or n.endswith("layer_norm.weight") for n in off)
    assert mask["uniter_model.img_embeddings.mask_embedding.weight"]
    assert not mask["uniter_model.img_embeddings.img_layer_norm.weight"]
    assert not mask["uniter_model.img_embeddings.pos_layer_norm.weight"]
    assert mask["linear.weight"] and not mask["linear.bias"]


def test_update_scales_by_name():
    names = list(port_tree_from_jax(flax_params()))
    freeze = layer_freeze_scales(names, 1)
    assert freeze["uniter_model.encoder.layer.0.output.dense.weight"] == 0.0
    assert freeze["uniter_model.encoder.layer.1.output.dense.weight"] == 1.0
    assert freeze["linear.weight"] == 1.0
    head = head_lr_scales(names, 1e-4, 1e-3, lambda n: n.startswith("linear"))
    assert head["linear.bias"] == pytest.approx(10.0)
    assert head["uniter_model.pooler.dense.weight"] == 1.0


# fp32 moments: one fp32 ulp of the O(1) parameters (seen: 1.2e-7). bf16
# moments: a moment whose fp32 value differs by an ulp can round to the
# neighbouring bf16 value, which moves that element's update by 2⁻⁸ of
# itself, up to lr·2⁻⁸ = 4e-5 at lr 1e-2 (seen: 3.5e-5)
ATOL = {"float32": 1e-6, "bfloat16": 1e-4}


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["adam", "adamw", "adamax", "sgd"])
def test_optimizer_matches_optax_chain(name, moments):
    """Five updates of the SMALL MemeUniter's parameters by the same random
    gradients (global norms above and below max_grad_norm, so clipping both
    acts and stands aside), weight decay through the mask, a warmup-cosine
    schedule whose first update has LR 0. The port and optax agree to fp32
    rounding (ATOL)."""
    kw = dict(warmup_steps=2, total_steps=10, lr_decay_step=3,
              lr_decay_factor=0.8)
    params = flax_params()
    tx = jax_optimizer(name, 1e-2, JS.make_schedule("warmup_cosine", **kw),
                       weight_decay=0.1, max_grad_norm=1.0,
                       params_example=params, mu_dtype=moments,
                       nu_dtype=moments)
    j_params = jax.tree_util.tree_map(jnp.asarray, params)
    j_state = tx.init(j_params)
    opt = Optimizer(name, 1e-2, TS.make_schedule("warmup_cosine", **kw),
                    weight_decay=0.1, max_grad_norm=1.0, mu_dtype=moments,
                    nu_dtype=moments)
    t_params = {k: torch.from_numpy(v)
                for k, v in port_tree_from_jax(params).items()}
    t_state = opt.init(t_params)
    rng = np.random.RandomState(1)
    for step in range(5):
        scale = 0.3 if step % 2 else 1e-3  # global norm ≈ 10 vs ≈ 0.03
        grads = jax.tree_util.tree_map(
            lambda x: (rng.randn(*x.shape) * scale).astype(np.float32),
            params)
        updates, j_state = tx.update(grads, j_state, j_params)
        j_params = jax.tree_util.tree_map(lambda p, u: p + u, j_params,
                                          updates)
        before = {k: v.clone() for k, v in t_params.items()}
        opt.step(t_params, {k: torch.from_numpy(v) for k, v in
                            port_tree_from_jax(grads).items()}, t_state)
        ref = port_tree_from_jax(j_params)
        for k, v in t_params.items():
            np.testing.assert_allclose(v.numpy(), ref[k], atol=ATOL[moments],
                                       rtol=0, err_msg="%s step %d" % (k,
                                                                      step))
        changed = any(not torch.equal(before[k], t_params[k])
                      for k in t_params)
        assert changed == (step > 0)  # warmup: LR 0 on the first update
    assert t_state["count"] == 5
    if name in ("adam", "adamw"):
        dt = getattr(torch, moments)
        assert all(m.dtype == dt for m in t_state["mu"].values())


# --------------------------------------------------------------- train step

def _step_batch(seed):
    """[accum 2, B 3] numpy batch; micro 1 is the zero-mask padding of a
    short final group."""
    micros = [dict(make_batch(seed=seed + a), labels=np.array([1, 0, 1],
                                                               np.int32),
                   sample_mask=np.array([1, 1, 0], np.int32))
              for a in range(2)]
    micros[1]["sample_mask"] = np.zeros(3, np.int32)
    return {k: np.stack([m[k] for m in micros]) for k in micros[0]}


@pytest.mark.parametrize("fuse_accum", [False, True],
                         ids=["scan_accum", "fused_accum"])
def test_train_step_matches_jax(fuse_accum):
    """Two optimizer steps of MemeUniter with dropout off, accumulation 2,
    the second micro-batch padded: per-micro losses and probabilities, and
    the parameters after each step. The optimizer is SGD with momentum and
    weight decay, so a parameter moves by lr times its gradient and the
    tolerance is that of the gradients (Adam would turn the fp32 noise of
    gradients that are zero up to rounding, such as the key bias's, into
    ±lr steps; the optimizer is held to optax on its own above)."""
    cfg = dict(SMALL, **NO_DROPOUT)
    params = flax_params()
    kw = dict(beta1=0.9, weight_decay=1e-3, max_grad_norm=5.0)
    tx = jax_optimizer("sgd", 0.5, lambda s: 1.0, params_example=params, **kw)
    jmodel = JaxMemeUniter(JaxUniterConfig(**cfg))
    step_j = jax_train_step(
        lambda p, b, r: jmodel.apply({"params": p}, b, deterministic=False,
                                     rngs={"dropout": r}),
        JL.make_loss_fn("bce_logits", 1.8), tx, accum_steps=2, donate=False,
        fuse_accum=fuse_accum)
    j_state = jax_train_state(jax.tree_util.tree_map(jnp.asarray, params), tx)

    model = torch_model(params, **NO_DROPOUT)
    opt = Optimizer("sgd", 0.5, lambda s: 1.0, **kw)
    state = create_train_state(model, opt)
    step_t = make_train_step(model, TL.make_loss_fn("bce_logits", 1.8), opt,
                             accum_steps=2, fuse_accum=fuse_accum)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    for i in range(2):
        batch = _step_batch(10 * i)
        j_state, j_out = step_j(j_state, {k: jnp.asarray(v) for k, v in
                                          batch.items()},
                                jax.random.PRNGKey(i))
        state, t_out = step_t(state, {k: torch.from_numpy(v) for k, v in
                                      batch.items()}, None)
        np.testing.assert_allclose(t_out["loss"].numpy(),
                                   np.asarray(j_out["loss"]), atol=1e-6)
        assert float(t_out["loss"][1]) == 0.0  # the padded micro-batch
        np.testing.assert_allclose(t_out["probs"].numpy(),
                                   np.asarray(j_out["probs"]), atol=1e-6)
        ref = port_tree_from_jax(j_state.params)
        for k, v in model.state_dict().items():
            np.testing.assert_allclose(v.numpy(), ref[k], atol=1e-6, rtol=0,
                                       err_msg=k)
    moved = max(float((model.state_dict()[k] - start[k]).abs().max())
                for k in start)
    assert moved > 1e-3
    assert state.step == 2 and state.opt_state["count"] == 2


def test_chunked_steps_equal_single_steps_with_dropout(tmp_path):
    """A ``Trainer`` epoch on index-mode loaders with two steps an upload
    (``steps_per_dispatch`` 2: a group of two and a tail of one) equals the
    epoch with one step an upload: dropout on, every step's losses and
    every weight bit for bit, since each step draws from (seed, step)."""
    paths = make_synthetic_dataset(str(tmp_path), n_train=20, n_dev=8,
                                   n_test=4, img_dim=16)
    ds = MemeDataset(paths["train"], feature_dir=paths["feature_dir"],
                     tokenizer=BertTokenizer(make_vocab(
                         str(tmp_path / "vocab.txt"))),
                     max_txt_len=8, max_bb=6, img_dim=16)
    tiny = UniterConfig(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                        num_attention_heads=4, intermediate_size=64,
                        img_dim=16, max_position_embeddings=64,
                        initializer_range=0.2)

    def run(K):
        torch.manual_seed(0)
        cfg = TrainConfig(model_path=str(tmp_path), batch_size=4,
                          gradient_accumulation=2, max_epoch=1,
                          optimizer="adam", lr=1e-3, seed=7,
                          steps_per_dispatch=K, no_model_checkpoints=True)
        trainer = Trainer(cfg, MemeUniter(tiny),
                          BatchLoader(ds, 4, index_batches=True),
                          BatchLoader(ds, 4, index_batches=True))
        step, losses = trainer.train_step, []

        def record(*args):
            state, out = step(*args)
            losses.append(out["loss"])
            return state, out

        trainer.train_step = record
        trainer.train_main()
        assert trainer.state.step == 3  # 5 batches: 3 groups of 2
        return torch.stack(losses), trainer.model.state_dict()

    la, a = run(1)
    lb, b = run(2)
    assert torch.equal(la, lb)
    assert all(torch.equal(a[k], b[k]) for k in a)
    # and dropout was on: another seed gives other losses
    model = torch_model(flax_params(), use_pallas_attention=True)
    b0 = {k: torch.from_numpy(v[0]) for k, v in _step_batch(0).items()}
    with torch.no_grad():
        x = model(b0, deterministic=False,
                  generator=dropout_generator(7, 0, "cpu"))
        y = model(b0, deterministic=False,
                  generator=dropout_generator(8, 0, "cpu"))
    assert not torch.equal(x, y)


# ------------------------------------------------------ resume, logs, meta

def test_train_state_resume_roundtrip(tmp_path):
    model = torch_model(flax_params(), **NO_DROPOUT)
    opt = Optimizer("adam", 1e-3, lambda s: 1.0, mu_dtype="bfloat16",
                    nu_dtype="bfloat16")
    state = create_train_state(model, opt)
    step = make_train_step(model, TL.make_loss_fn("bce_logits"), opt,
                           accum_steps=2)
    state, _ = step(state, {k: torch.from_numpy(v) for k, v in
                            _step_batch(0).items()}, None)
    path = str(tmp_path / "state.pt")
    save_train_state(path, state, epoch=3)

    other = torch_model(flax_params(seed=1), **NO_DROPOUT)
    restored = create_train_state(other, opt)
    restored, epoch = load_train_state(path, restored)
    assert epoch == 3 and restored.step == 1
    assert restored.opt_state["count"] == 1
    sd_a, sd_b = model.state_dict(), other.state_dict()
    assert all(torch.equal(sd_a[k], sd_b[k]) for k in sd_a)
    for slot in ("mu", "nu"):
        for k, v in state.opt_state[slot].items():
            assert torch.equal(v, restored.opt_state[slot][k])
            assert restored.opt_state[slot][k].dtype == torch.bfloat16


def test_profile_trace_noop_and_real(tmp_path):
    """As JAX's profile_trace (tests/test_observability.py): a falsy log
    directory is a no-op that creates nothing; a real one is left holding
    the profiler's trace of the block."""
    with profile_trace(None):
        pass
    with profile_trace(""):
        pass
    assert os.listdir(tmp_path) == []

    trace_dir = str(tmp_path / "trace")
    with profile_trace(trace_dir):
        (torch.ones(8, 8) @ torch.ones(8, 8)).sum().item()
    found = []
    for root, _dirs, files in os.walk(trace_dir):
        found += [os.path.join(root, f) for f in files]
    assert found, "profiler trace should leave artifacts under the log dir"
    with open(found[0]) as f:
        assert any("aten::mm" in e.get("name", "")
                   for e in json.load(f)["traceEvents"])


def test_scalar_writer_and_training_meta(tmp_path):
    from meme_challenge_tpu_torch.core.config import TrainConfig, UniterConfig

    w = ScalarWriter(str(tmp_path / "vis"), use_tensorboard=False)
    w.add_scalars([("Train/Epoch_Loss", 4, 0.5), ("Validation/aucroc", 1,
                                                  0.75)])
    w.close()
    with open(tmp_path / "vis" / "scalars.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [(r["name"], r["step"], r["value"]) for r in rows] == [
        ("Train/Epoch_Loss", 4, 0.5), ("Validation/aucroc", 1, 0.75)]

    save_training_meta(str(tmp_path), TrainConfig(seed=3),
                       UniterConfig(**SMALL))
    log = tmp_path / "log"
    assert json.loads((log / "hps.json").read_text())["seed"] == 3
    assert json.loads((log / "model.json").read_text())["hidden_size"] == 32
    assert os.path.isfile(log / "git_info.json")
