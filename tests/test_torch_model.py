"""PyTorch port, models/uniter.py: MemeUniter logits against the JAX package
on the text-only, image-only and joint branches, with padded text and boxes,
through each of the encoder's three attention branches (the fused kernel's
plain version on the CPU, bf16 score storage, plain fp32). Weights come from
one flax init carried across by ``meme_uniter_state_from_jax``."""
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
    torch_logits,
    torch_model,
)

from meme_challenge_tpu_torch.core.config import UniterConfig
from meme_challenge_tpu_torch.models import uniter as U

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


def test_dropout_forward_raises():
    model = torch_model(flax_params())
    tb = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    with pytest.raises(NotImplementedError, match="training slice"):
        model(tb, deterministic=False)
