"""PyTorch port, models/uniter.py: MemeUniter logits, and the training loss
with its gradients, against the JAX package on the text-only, image-only
and joint branches, with padded text and boxes, through each of the
encoder's attention branches (the fused kernels' plain versions on the CPU,
bf16 score storage, plain fp32); and the training-mode dropout (seeded,
keep fractions of both bit widths). Weights come from one flax init carried
across by ``meme_uniter_state_from_jax``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (
    ATTENTION,
    SMALL,
    branch,
    flax_params,
    jax_logits,
    make_batch,
    port_tree_from_jax,
    torch_logits,
    torch_model,
)

from meme_challenge_tpu.core.config import UniterConfig as JaxUniterConfig
from meme_challenge_tpu.models.uniter import MemeUniter as JaxMemeUniter
from meme_challenge_tpu.train.losses import bce_logits_loss as jax_bce_logits
from meme_challenge_tpu_torch.core.config import UniterConfig
from meme_challenge_tpu_torch.models import uniter as U
from meme_challenge_tpu_torch.train.losses import bce_logits_loss

BRANCHES = ("joint", "text", "image")

# bf16 compute rounds every activation to 8 mantissa bits (~4e-3 relative);
# over 2 layers the two frameworks round at different points (XLA fuses
# elementwise chains in fp32, torch rounds after each op), so O(1) logits
# differ by a few bf16 ulps (largest seen: 1.05e-2)
BF16_ATOL = 3e-2


@pytest.mark.parametrize("attention", sorted(ATTENTION))
@pytest.mark.parametrize("name", BRANCHES)
def test_logits_match_jax_fp32(attention, name):
    params = flax_params()
    batch = branch(make_batch(seed=1), name)
    ref = jax_logits(params, batch, **ATTENTION[attention])
    out = torch_logits(torch_model(params, **ATTENTION[attention]), batch)
    assert out.shape == ref.shape == (3, 1)
    assert np.abs(ref).max() > 0.05  # the logits carry signal
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("attention", sorted(ATTENTION))
@pytest.mark.parametrize("name", BRANCHES)
def test_logits_match_jax_bf16(attention, name):
    params = flax_params()
    batch = branch(make_batch(seed=2), name)
    cfg = dict(ATTENTION[attention], dtype="bfloat16")
    ref = jax_logits(params, batch, **cfg)
    out = torch_logits(torch_model(params, **cfg), batch)
    np.testing.assert_allclose(out, ref, atol=BF16_ATOL, rtol=0)


def test_two_class_head_matches_jax():
    params = flax_params(n_classes=2)
    batch = make_batch(seed=3)
    ref = jax_logits(params, batch, n_classes=2, use_pallas_attention=True)
    out = torch_logits(torch_model(params, n_classes=2,
                                   use_pallas_attention=True), batch)
    np.testing.assert_allclose(out, ref, atol=1e-5, rtol=0)


def test_mrfr_mask_row_zero_contributes_nothing():
    """Row 0 of the MRFR mask embedding is pinned to zero: img_masks of all
    zeros give the same embeddings as no img_masks at all."""
    model = torch_model(flax_params())
    emb = model.uniter_model.img_embeddings
    b = make_batch(seed=4)
    feat = torch.from_numpy(b["img_feat"])
    pos = torch.from_numpy(b["img_pos_feat"])
    typ = model.uniter_model.embeddings.type_embed(
        torch.ones(feat.shape[:2], dtype=torch.long))
    with torch.no_grad():
        plain = emb(feat, pos, typ)
        zeros = emb(feat, pos, typ, torch.zeros(feat.shape[:2],
                                                 dtype=torch.long))
        ones = emb(feat, pos, typ, torch.ones(feat.shape[:2],
                                               dtype=torch.long))
    assert torch.equal(plain, zeros)
    assert not torch.allclose(plain, ones)


def test_init_is_seeded_and_shaped():
    cfg = UniterConfig(**SMALL)
    a = U.init_meme_uniter(cfg, 1, "cpu", torch.Generator().manual_seed(5))
    b = U.init_meme_uniter(cfg, 1, "cpu", torch.Generator().manual_seed(5))
    c = U.init_meme_uniter(cfg, 1, "cpu", torch.Generator().manual_seed(6))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    w = "uniter_model.encoder.layer.0.attention.self.query.weight"
    assert not torch.equal(sa[w], sc[w])
    assert abs(float(sa[w].std()) - SMALL["initializer_range"]) < 0.05
    assert torch.equal(sa["uniter_model.embeddings.LayerNorm.weight"],
                       torch.ones(SMALL["hidden_size"]))
    assert float(sa["linear.bias"].abs().max()) == 0.0


# ---------------------------------------------------------------- training

NO_DROPOUT = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
# the four attention branches on the joint input, and the text-only and
# image-only inputs through the fused kernel
LOSS_CASES = ([("joint", a) for a in sorted(ATTENTION)]
              + [("text", "fused"), ("image", "fused")])
# gradient tolerance relative to each parameter's largest gradient: fp32
# products summed in other orders over 2 layers (largest seen: 2.5e-6);
# bf16 score storage rounds the fp32 scores to bf16 in both packages, and a
# score summed in another order can round to the neighbouring bf16 value
GRAD_TOL = {"bf16_scores": 1e-3}
GRAD_TOL_FP32 = 2e-5
# the key bias's gradient is zero up to rounding (softmax ignores a shift of
# a whole score row): both packages' values are noise, held below
# NOISE_TOL of the model's largest gradient instead of compared
NOISE_ONLY = "attention.self.key.bias"
NOISE_TOL = 1e-3


@pytest.mark.parametrize("name,attention", LOSS_CASES)
def test_loss_and_grads_match_jax(name, attention):
    """bce_logits (pos_wt 1.8, one sample masked out) of MemeUniter in
    training mode with dropout off: the loss, and the gradient of every
    parameter carried across the QKV split and the transposes."""
    params = flax_params()
    cfg = dict(ATTENTION[attention], **NO_DROPOUT)
    batch = branch(make_batch(seed=6), name)
    labels, mask = np.array([1, 0, 1], np.int32), np.array([1, 1, 0],
                                                           np.int32)
    jmodel = JaxMemeUniter(JaxUniterConfig(**{**SMALL, **cfg}))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jb, deterministic=False)
        return jax_bce_logits(logits, jnp.asarray(labels), jnp.asarray(mask),
                              pos_weight=1.8)[0]

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    ref = port_tree_from_jax(jgrads)

    model = torch_model(params, **cfg)
    logits = model({k: torch.from_numpy(v) for k, v in batch.items()},
                   deterministic=False)
    loss, _ = bce_logits_loss(logits, torch.from_numpy(labels),
                              torch.from_numpy(mask), pos_weight=1.8)
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-6
    tol = GRAD_TOL.get(attention, GRAD_TOL_FP32)
    grads = dict(model.named_parameters())
    assert set(grads) == set(ref)
    top = max(np.abs(r).max() for r in ref.values())
    for n, p in grads.items():
        g = (p.grad.numpy() if p.grad is not None
             else np.zeros(p.shape, np.float32))
        r = ref[n]
        if n.endswith(NOISE_ONLY):
            assert max(np.abs(g).max(), np.abs(r).max()) <= NOISE_TOL * top, n
            continue
        err = np.abs(g - r).max()
        assert err <= tol * np.abs(r).max(), (n, err, np.abs(r).max())
    assert np.abs(ref["linear.weight"]).max() > 1e-3  # the loss has signal


@pytest.mark.parametrize("attention", sorted(ATTENTION))
def test_dropout_is_seeded(attention):
    """Training mode (dropout 0.1 / 0.1): one generator seed gives the same
    logits twice, another seed other logits, and both differ from eval."""
    model = torch_model(flax_params(), **ATTENTION[attention])
    batch = make_batch(seed=7)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    def run(seed):
        with torch.no_grad():
            if seed is None:
                return model(tb).numpy()
            return model(tb, deterministic=False,
                         generator=torch.Generator().manual_seed(seed)).numpy()

    a, b, c, ev = run(1), run(1), run(2), run(None)
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 1e-4
    assert np.abs(a - ev).max() > 1e-4


@pytest.mark.parametrize("bits8,keep", [(False, 0.9), (True, 1 - 26 / 256)])
def test_threshold_dropout_keep_fraction(bits8, keep):
    x = torch.ones(1000, 1000)
    y = U.threshold_dropout(x, 0.1, torch.Generator().manual_seed(0), bits8)
    kept = y != 0
    assert abs(float(kept.float().mean()) - keep) < 3e-3
    # kept values are scaled by the effective keep probability
    np.testing.assert_allclose(y[kept].numpy(), 1.0 / keep, rtol=1e-6)


def test_bernoulli_dropout_keep_fraction_and_identity():
    x = torch.ones(1000, 1000)
    y = U.bernoulli_dropout(x, 0.1, torch.Generator().manual_seed(0))
    assert abs(float((y != 0).float().mean()) - 0.9) < 3e-3
    assert U.bernoulli_dropout(x, 0.1, None) is x
    assert U.threshold_dropout(x, 0.0, torch.Generator()) is x


def test_training_without_generator_raises():
    model = torch_model(flax_params())
    tb = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    with pytest.raises(ValueError, match="Generator"):
        model(tb, deterministic=False)


def test_remat_training_raises():
    """remat=True keeps the encoder's rules: training with dropout on and no
    generator raises, inference runs (remat changes no value there)."""
    model = torch_model(flax_params(), remat=True)
    tb = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    with pytest.raises(ValueError, match="Generator"):
        model(tb, deterministic=False)
    with torch.no_grad():
        assert torch.equal(model(tb), torch_model(flax_params())(tb))


# the fused kernel (its plain version here) and the plain attention branch
REMAT_ATTENTION = ("fused", "fused_blocked", "plain")


def _loss_and_grads(model, batch, generator=None):
    labels, mask = torch.tensor([1, 0, 1]), torch.tensor([1, 1, 0])
    logits = model({k: torch.from_numpy(v) for k, v in batch.items()},
                   deterministic=False, generator=generator)
    loss, _ = bce_logits_loss(logits, labels, mask, pos_weight=1.8)
    loss.backward()
    return loss.item(), {n: p.grad.numpy() for n, p in
                         model.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("attention", REMAT_ATTENTION)
def test_remat_loss_and_grads_match_jax(attention, policy):
    """Dropout off: the loss and every gradient with remat (each layer
    checkpointed; "dots" keeping the products) against JAX ``remat=True``
    with the same policy, to the tolerance of the plain gradient parity."""
    params = flax_params()
    cfg = dict(ATTENTION[attention], **NO_DROPOUT, remat=True,
               remat_policy=policy)
    batch = make_batch(seed=8)
    labels, mask = np.array([1, 0, 1], np.int32), np.array([1, 1, 0],
                                                           np.int32)
    jmodel = JaxMemeUniter(JaxUniterConfig(**{**SMALL, **cfg}))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        logits = jmodel.apply({"params": p}, jb, deterministic=False)
        return jax_bce_logits(logits, jnp.asarray(labels), jnp.asarray(mask),
                              pos_weight=1.8)[0]

    jloss, jgrads = jax.value_and_grad(loss_fn)(params)
    ref = port_tree_from_jax(jgrads)
    loss, grads = _loss_and_grads(torch_model(params, **cfg), batch)
    assert abs(loss - float(jloss)) <= 1e-6
    top = max(np.abs(r).max() for r in ref.values())
    assert set(grads) <= set(ref)
    for n, r in ref.items():
        g = grads.get(n, np.zeros_like(r))
        if n.endswith(NOISE_ONLY):
            assert max(np.abs(g).max(), np.abs(r).max()) <= NOISE_TOL * top, n
            continue
        err = np.abs(g - r).max()
        assert err <= GRAD_TOL_FP32 * np.abs(r).max(), (n, err)


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("attention", REMAT_ATTENTION)
def test_remat_replays_dropout(attention, policy):
    """Dropout 0.1 / 0.1 from one generator seed: the loss and gradients with
    remat equal those without it bit for bit (the recompute replays the
    threshold masks and the kernel's seeds), the generator ends where it
    would without remat, and the dropout was on."""
    params = flax_params()
    batch = make_batch(seed=9)
    out, ends = {}, {}
    for remat in (False, True):
        gen = torch.Generator().manual_seed(11)
        model = torch_model(params, remat=remat, remat_policy=policy,
                            **ATTENTION[attention])
        out[remat] = _loss_and_grads(model, batch, gen)
        ends[remat] = torch.rand(4, generator=gen)
    (l0, g0), (l1, g1) = out[False], out[True]
    assert l1 == l0
    assert set(g0) == set(g1)
    for n in g0:
        np.testing.assert_array_equal(g1[n], g0[n], err_msg=n)
    assert torch.equal(ends[True], ends[False])
    off = _loss_and_grads(torch_model(params, **ATTENTION[attention],
                                      **NO_DROPOUT), batch)
    assert off[0] != l0
