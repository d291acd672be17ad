"""Shared fixtures of the ``test_torch_*`` parity tests: one flax MemeUniter
init, carried into the PyTorch port, and numpy batches from a seed."""
import functools

import jax
import numpy as np
import torch

from meme_challenge_tpu.core.config import UniterConfig as JaxUniterConfig
from meme_challenge_tpu.models.uniter import MemeUniter as JaxMemeUniter
from meme_challenge_tpu_torch.core.config import UniterConfig
from meme_challenge_tpu_torch.models.convert import meme_uniter_state_from_jax
from meme_challenge_tpu_torch.models.uniter import MemeUniter

# small UNITER: 2 layers, hidden 32, 4 heads; initializer_range 0.2 keeps
# the logits O(1) so an absolute tolerance means something
SMALL = dict(vocab_size=64, hidden_size=32, num_hidden_layers=2,
             num_attention_heads=4, intermediate_size=64, img_dim=16,
             max_position_embeddings=32, initializer_range=0.2)

# the three attention branches of the encoder (models/uniter.py:317-356)
ATTENTION = {
    "plain": {},
    "fused": dict(use_pallas_attention=True),
    "fused_blocked": dict(use_pallas_attention=True, pallas_blocked=True),
    "bf16_scores": dict(attention_score_dtype="bfloat16"),
}


def make_batch(seed=0, B=3, T=8, R=6, img_dim=16, vocab=64):
    """Numpy model inputs with padded text and padded boxes."""
    rng = np.random.RandomState(seed)
    txt_len = rng.randint(3, T + 1, B)
    txt_len[0] = T
    n_bb = rng.randint(2, R + 1, B)
    return {
        "input_ids": rng.randint(0, vocab, (B, T)).astype(np.int32),
        "position_ids": np.tile(np.arange(T, dtype=np.int32), (B, 1)),
        "txt_mask": (np.arange(T)[None] < txt_len[:, None]).astype(np.int32),
        "img_feat": rng.randn(B, R, img_dim).astype(np.float16),
        "img_pos_feat": rng.rand(B, R, 7).astype(np.float32),
        "img_mask": (np.arange(R)[None] < n_bb[:, None]).astype(np.int32),
    }


def branch(batch, name):
    """The text-only / image-only / joint view of a batch."""
    if name == "text":
        return {k: v for k, v in batch.items() if not k.startswith("img")}
    if name == "image":
        return {k: v for k, v in batch.items()
                if k.startswith("img")}
    return dict(batch)


@functools.lru_cache(maxsize=None)
def flax_params(n_classes=1, seed=0):
    """One flax MemeUniter init (numpy leaves) at the SMALL width."""
    model = JaxMemeUniter(JaxUniterConfig(**SMALL), n_classes=n_classes)
    batch = {k: jax.numpy.asarray(v) for k, v in make_batch().items()}
    params = model.init(jax.random.PRNGKey(seed), batch,
                        deterministic=True)["params"]
    return jax.tree_util.tree_map(np.asarray, params)


def jax_logits(params, batch, n_classes=1, **cfg):
    model = JaxMemeUniter(JaxUniterConfig(**{**SMALL, **cfg}),
                          n_classes=n_classes)
    jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    out = model.apply({"params": params}, jb, deterministic=True)
    return np.asarray(out, dtype=np.float32)


def torch_model(params, n_classes=1, **cfg):
    model = MemeUniter(UniterConfig(**{**SMALL, **cfg}), n_classes=n_classes)
    model.load_state_dict(meme_uniter_state_from_jax(params), strict=True)
    return model.eval()


def torch_logits(model, batch):
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        return model(tb).float().numpy()
