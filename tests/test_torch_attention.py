"""PyTorch port, ops/attention.py: the plain PyTorch versions of the two fused
attention kernels against the JAX package's Pallas kernels (interpret mode on
the CPU), with and without dropout; the counter hash bit for bit against the
numpy replica; the block-size policy; and the wrapper's guards. The CUDA
kernels themselves run only on the card (chip_smoke.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meme_challenge_tpu.ops import attention as J
from meme_challenge_tpu_torch.ops import attention as T
from test_attention_kernel import _numpy_hash_bits


def _inputs(seed, B, H, S, D):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(B, H, S, D).astype(np.float32) for _ in range(3))
    lens = rng.randint(4, S + 1, size=B)
    mask = (np.arange(S)[None] < lens[:, None]).astype(np.float32)
    bias = ((1.0 - mask) * -10000.0)[:, None, None, :].astype(np.float32)
    return q, k, v, bias


SHAPES = [(2, 3, 24, 8), (3, 4, 16, 8), (2, 12, 24, 16)]
KERNELS = {"per_sample": (J.fused_attention, T.fused_attention),
           "blocked": (J.fused_attention_blocked, T.fused_attention_blocked)}


@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_matches_jax_kernel(shape, kernel, rate):
    B, H, S, D = shape
    q, k, v, bias = _inputs(sum(shape), *shape)
    scale = 1.0 / np.sqrt(D)
    n_seeds = B if kernel == "per_sample" else J.blocked_seed_count(B, H)
    seeds = np.random.RandomState(7).randint(
        0, 2 ** 31 - 1, size=n_seeds).astype(np.int32)
    jax_fn, torch_fn = KERNELS[kernel]
    ref = np.asarray(jax_fn(*map(jnp.asarray, (q, k, v, bias)), scale, rate,
                            jnp.asarray(seeds)))
    out = torch_fn(*map(torch.from_numpy, (q, k, v, bias)), scale, rate,
                   torch.from_numpy(seeds)).numpy()
    np.testing.assert_allclose(out, ref, atol=2e-5, rtol=0)
    # bit-identical masks: exactly the same outputs are exactly zero
    # (here none), and the dropped probabilities show through a one-hot v
    eye = np.zeros_like(v)
    eye[..., np.arange(D), np.arange(D)] = 1.0
    p_ref = np.asarray(jax_fn(*map(jnp.asarray, (q, k, eye, bias)), scale,
                              rate, jnp.asarray(seeds)))
    p_out = torch_fn(*map(torch.from_numpy, (q, k, eye, bias)), scale, rate,
                     torch.from_numpy(seeds)).numpy()
    np.testing.assert_array_equal(p_out == 0, p_ref == 0)
    if rate > 0:
        assert (p_out == 0).any()


def test_plain_bf16_matches_jax_kernel():
    B, H, S, D = 2, 3, 24, 8
    q, k, v, bias = _inputs(0, B, H, S, D)
    scale = 1.0 / np.sqrt(D)
    seeds = np.array([3, 91], np.int32)
    ref = J.fused_attention(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
                            jnp.asarray(bias), scale, 0.25,
                            jnp.asarray(seeds))
    out = T.fused_attention(*(torch.from_numpy(x).bfloat16()
                              for x in (q, k, v)),
                            torch.from_numpy(bias), scale, 0.25,
                            torch.from_numpy(seeds))
    assert out.dtype == torch.bfloat16
    # both round p to bf16 before P·V and the output to bf16: one bf16 ulp
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=2e-2, rtol=0)


@pytest.mark.parametrize("seed", [0, 1, 12345, 2 ** 31 - 2, 2 ** 31 - 1])
def test_hash_bits_match_numpy_replica(seed):
    # 3 × 300 × 300: linear indices up to 270k, so idx × 0x85EBCA6B and
    # seed × 2654435761 wrap many times over in uint32
    shape = (3, 300, 300)
    ref = _numpy_hash_bits(shape, seed)
    out = T._hash_bits(shape, seed).numpy()
    assert out.min() >= 0 and out.max() < 2 ** 32
    np.testing.assert_array_equal(out.astype(np.uint32), ref)


def test_hash_bits_vector_of_seeds_and_negative_seed():
    shape = (2, 5, 7)
    seeds = torch.tensor([-1, 0, 2 ** 31 - 1], dtype=torch.int32)
    out = T._hash_bits(shape, seeds).numpy().astype(np.uint32)
    for i, s in enumerate(seeds.tolist()):
        np.testing.assert_array_equal(
            out[i], _numpy_hash_bits(shape, np.uint32(s & 0xFFFFFFFF)))


def test_mul32_wraps_like_uint32():
    rng = np.random.RandomState(0)
    a = rng.randint(0, 2 ** 32, size=1000, dtype=np.uint64)
    for b in (2654435761, 0x85EBCA6B, 0xC2B2AE35, 0xFFFFFFFF, 1):
        ref = (a * np.uint64(b)) & np.uint64(0xFFFFFFFF)
        out = T._mul32(torch.from_numpy(a.astype(np.int64)), b).numpy()
        np.testing.assert_array_equal(out.astype(np.uint64), ref)


def test_blocked_seed_count_matches_jax():
    for B in range(1, 21):
        for H in range(1, 17):
            assert T.blocked_seed_count(B, H) == J.blocked_seed_count(B, H)
            assert T._largest_block(B * H) == J._largest_block(B * H)


def test_cpu_path_launches_no_kernel():
    before = dict(T.LAUNCHES)
    q, k, v, bias = map(torch.from_numpy, _inputs(0, 2, 2, 16, 8))
    T.fused_attention(q, k, v, bias, 0.5)
    T.fused_attention_blocked(q, k, v, bias, 0.5)
    assert T.LAUNCHES == before


def test_non_cuda_device_raises():
    q, k, v, bias = (torch.from_numpy(x).to("meta")
                     for x in _inputs(0, 1, 2, 16, 8))
    with pytest.raises(ValueError, match="cuda or cpu"):
        T.fused_attention(q, k, v, bias, 0.5)
