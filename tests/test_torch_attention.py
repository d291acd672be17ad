"""PyTorch port, ops/attention.py: the plain PyTorch versions of the two fused
attention kernels and of their backward against the JAX package's Pallas
kernels and ``jax.grad`` through their custom VJPs (interpret mode on the
CPU), with and without dropout; the autograd functions against the plain
backward; the counter hash bit for bit against the numpy replica; the
block-size policy; the rule that routes a launch to the tensor-core or the
CUDA-core body; the float32 tensor-core body's 3×TF32 products, emulated;
and the wrapper's guards. The CUDA kernels themselves run only on the card
(chip_smoke.py)."""
import json
import os

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from meme_challenge_tpu.ops import attention as J
from meme_challenge_tpu_torch.core.config import TrainConfig
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


# ------------------------------------------------------------------ backward

BWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _bwd_case(seed, B, H, S, D, dtype, kernel):
    q, k, v, bias = _inputs(seed, B, H, S, D)
    do = np.random.RandomState(seed + 1).randn(B, H, S, D).astype(np.float32)
    n_seeds = B if kernel == "per_sample" else J.blocked_seed_count(B, H)
    seeds = np.random.RandomState(11).randint(
        0, 2 ** 31 - 1, size=n_seeds).astype(np.int32)
    group = H if kernel == "per_sample" else T._largest_block(B * H)
    return q, k, v, bias, do, seeds, group


def _jax_grads(kernel, q, k, v, bias, do, scale, rate, seeds, dtype):
    jax_fn = KERNELS[kernel][0]
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def f(q_, k_, v_):
        out = jax_fn(q_, k_, v_, jnp.asarray(bias), scale, rate,
                     jnp.asarray(seeds))
        return jnp.sum(out.astype(jnp.float32) * jnp.asarray(do, jd)
                       .astype(jnp.float32))

    grads = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x, jd)
                                              for x in (q, k, v)))
    return [np.asarray(g, np.float32) for g in grads]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("S", [17, 24])
def test_plain_backward_matches_jax_grad(S, kernel, rate, dtype):
    """fused_attention_bwd_plain against jax.grad of the Pallas kernel's
    custom VJP (_bwd_kernel / _blk_bwd_kernel in interpret mode): each
    gradient within BWD_TOL of its largest magnitude. bf16 rounds p, pd and
    ds where the JAX kernel does; the products differ by fp32 summation
    order only."""
    B, H, D = 2, 3, 8
    q, k, v, bias, do, seeds, group = _bwd_case(S, B, H, S, D, dtype, kernel)
    scale = 1.0 / np.sqrt(D)
    ref = _jax_grads(kernel, q, k, v, bias, do, scale, rate, seeds, dtype)
    td = getattr(torch, dtype)
    got = T.fused_attention_bwd_plain(
        *(torch.from_numpy(x).to(td) for x in (q, k, v)),
        torch.from_numpy(bias), torch.from_numpy(do).to(td), scale, rate,
        torch.from_numpy(seeds), group)
    for g, r in zip(got, ref):
        assert g.dtype == td
        err = np.abs(g.float().numpy() - r).max() / np.abs(r).max()
        assert err <= BWD_TOL[dtype], err
    if rate > 0:
        # dropout reaches the gradient: dv of a dropped (i, j) pair is zero
        # where the rate-0 gradient is not
        no_drop = T.fused_attention_bwd_plain(
            *(torch.from_numpy(x).to(td) for x in (q, k, v)),
            torch.from_numpy(bias), torch.from_numpy(do).to(td), scale, 0.0,
            None, group)
        assert not torch.equal(got[2], no_drop[2])


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_autograd_function_matches_plain_backward_on_cpu(kernel, rate):
    """The wrapper's autograd backward on CPU tensors is the plain backward:
    the same gradients bit for bit, no gradient for the bias, and no kernel
    launch counted."""
    B, H, S, D = 2, 4, 24, 8
    q, k, v, bias, do, seeds, group = _bwd_case(5, B, H, S, D, "float32",
                                                kernel)
    scale = 1.0 / np.sqrt(D)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    tbias = torch.from_numpy(bias).requires_grad_()
    before = dict(T.LAUNCHES)
    out = KERNELS[kernel][1](*leaves, tbias, scale, rate,
                             torch.from_numpy(seeds))
    out.backward(torch.from_numpy(do))
    ref = T.fused_attention_bwd_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(bias),
        torch.from_numpy(do), scale, rate, torch.from_numpy(seeds), group)
    for leaf, r in zip(leaves, ref):
        assert torch.equal(leaf.grad, r)
    assert tbias.grad is None
    assert T.LAUNCHES == before


def test_launch_counts_name_every_kernel():
    assert set(T.LAUNCHES) == {"fused_attention", "fused_attention_blocked",
                               "fused_attention_bwd",
                               "fused_attention_blocked_bwd"}


# ------------------------------------------------------------------- routes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _main_path_shape(config):
    """(S, D) of a configuration's attention on the main path: S = the
    training defaults' max_txt_len + max_bb, D = hidden / heads."""
    with open(os.path.join(ROOT, "configs", config)) as f:
        cfg = json.load(f)
    train = TrainConfig()
    return (train.max_txt_len + train.max_bb,
            cfg["hidden_size"] // cfg["num_attention_heads"])


@pytest.mark.parametrize("backward", [False, True], ids=["fwd", "bwd"])
@pytest.mark.parametrize("config", ["uniter-base.json", "uniter-large.json"])
def test_route_main_path_shapes(config, backward):
    """At the shipped configurations' shapes (S 160, D 64) both dtypes take
    their tensor-core body in both directions."""
    S, D = _main_path_shape(config)
    assert (S, D) == (160, 64)
    assert T.attention_route(torch.bfloat16, S, D, backward) == "mma_bf16"
    assert T.attention_route(torch.float32, S, D, backward) == "mma_tf32x3"


# (S, D, backward, route of bf16) on each side of each limit: S <= 160 (the
# register tile), and the backward's shared memory within 227 KB (D <= 80 at
# S 160, D 128 up to S 128)
ROUTE_LIMITS = [
    (1, 4, False, "mma_bf16"), (1, 4, True, "mma_bf16"),
    (160, 128, False, "mma_bf16"), (161, 64, False, "cuda_core"),
    (161, 64, True, "cuda_core"), (256, 128, False, "cuda_core"),
    (256, 128, True, "cuda_core"), (160, 80, True, "mma_bf16"),
    (160, 84, True, "cuda_core"), (160, 128, True, "cuda_core"),
    (128, 128, True, "mma_bf16"), (144, 128, True, "cuda_core"),
    (17, 16, True, "mma_bf16"), (100, 64, True, "mma_bf16"),
]


# the float32 route at the same cases: mma_tf32x3 with S <= 160 and D <= 128,
# the backward only up to D 64 (its dk and dv registers)
FP32_ROUTE_CUDA_CORE = {(161, 64, False), (161, 64, True), (256, 128, False),
                        (256, 128, True), (160, 80, True), (160, 84, True),
                        (160, 128, True), (128, 128, True), (144, 128, True)}


@pytest.mark.parametrize("S,D,backward,route", ROUTE_LIMITS,
                         ids=lambda x: str(x))
def test_route_limits(S, D, backward, route):
    assert T.attention_route(torch.bfloat16, S, D, backward) == route
    fits = T.mma_smem_bytes(S, D, backward) <= T.MAX_SMEM
    assert (route == "mma_bf16") == (S <= T.MMA_MAX_S and fits)
    fp32 = T.attention_route(torch.float32, S, D, backward)
    assert fp32 == ("cuda_core" if (S, D, backward) in FP32_ROUTE_CUDA_CORE
                    else "mma_tf32x3")
    fits = T.tf32_smem_bytes(S, D, backward) <= T.MAX_SMEM
    assert (fp32 == "mma_tf32x3") == (
        S <= T.MMA_MAX_S and D <= (T.TF32_BWD_MAX_D if backward else
                                   T.MMA_MAX_D) and fits)


@pytest.mark.parametrize("S,D,backward,nbytes", [
    # forward: K, V [160][72] and 5 tiles of Q rows [80][72] bf16 + bias
    (160, 64, False, (2 * 160 + 80) * 72 * 2 + 160 * 4),
    # backward: Q, K, V, dout [160][72] + pd, ds [160][168] bf16 + bias
    (160, 64, True, (4 * 160 * 72 + 2 * 160 * 168) * 2 + 160 * 4),
    # S 17 pads to 16-row tiles: one forward tile, D 16 pads to 16 + 8
    (17, 16, False, (2 * 32 + 32) * 24 * 2 + 32 * 4),
])
def test_mma_smem_bytes_layout(S, D, backward, nbytes):
    assert T.mma_smem_bytes(S, D, backward) == nbytes


@pytest.mark.parametrize("S,D,backward,nbytes", [
    # forward: K and 5 tiles of Q rows [.][72], V [160][68] fp32 + bias
    (160, 64, False, ((160 + 80) * 72 + 160 * 68 + 160) * 4),
    # backward: K, V and 2 stages of 32-row Q, dout chunks [.][68], the dS
    # chunk [32][168], bias, max, sum, 1/sum and delta rows
    (160, 64, True, ((2 * 160 + 4 * 32) * 68 + 32 * 168 + 5 * 160) * 4),
    # S 17 pads to two 16-row tiles, D 16 to 16 + 8 and 16 + 4
    (17, 16, False, ((32 + 32) * 24 + 32 * 20 + 32) * 4),
    (17, 16, True, ((2 * 32 + 4 * 32) * 20 + 32 * 40 + 5 * 32) * 4),
])
def test_tf32_smem_bytes_layout(S, D, backward, nbytes):
    assert T.tf32_smem_bytes(S, D, backward) == nbytes


def test_tf32_backward_route_implies_forward_route():
    """The mma_tf32x3 backward rebuilds p from the row statistics that only
    the mma_tf32x3 forward writes, so wherever the backward takes the route
    the forward does too."""
    for S in range(1, 260, 7):
        for D in range(4, 132, 4):
            if T.attention_route(torch.float32, S, D, True) == "mma_tf32x3":
                assert T.attention_route(torch.float32, S, D) == "mma_tf32x3"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_cpu_tensors_never_consult_the_route(kernel, dtype, monkeypatch):
    """CPU tensors take the plain versions forward and backward: the route
    rule is never asked and no launch is counted, by wrapper or by route."""
    def no_route(*args, **kwargs):
        raise AssertionError("the route rule was consulted for CPU tensors")

    monkeypatch.setattr(T, "attention_route", no_route)
    td = getattr(torch, dtype)
    q, k, v, bias = _inputs(3, 2, 4, 24, 8)
    leaves = [torch.from_numpy(x).to(td).requires_grad_() for x in (q, k, v)]
    n_seeds = 2 if kernel == "per_sample" else T.blocked_seed_count(2, 4)
    seeds = torch.arange(n_seeds, dtype=torch.int32)
    before = (dict(T.LAUNCHES), dict(T.ROUTE_LAUNCHES))
    out = KERNELS[kernel][1](*leaves, torch.from_numpy(bias), 0.5, 0.1, seeds)
    out.float().sum().backward()
    assert all(leaf.grad is not None for leaf in leaves)
    assert (T.LAUNCHES, T.ROUTE_LAUNCHES) == before


def test_route_launch_counts_name_every_kernel_and_route():
    assert set(T.ROUTES) == {"mma_bf16", "mma_tf32x3", "cuda_core"}
    assert set(T.ROUTE_LAUNCHES) == {(name, route) for name in T.LAUNCHES
                                     for route in T.ROUTES}


# ------------------------------------------- bf16 at the main path's shape

MAIN = (2, 12, 160, 64)


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_plain_bf16_forward_matches_jax_at_main_path_shape(kernel):
    """The bf16 plain forward against the Pallas kernel (interpret mode) at
    S 160, D 64 with attention dropout 0.1, as training runs it: within one
    bf16 ulp of the output (both round p and the output to bf16), and the
    same dropped probabilities (one-hot v)."""
    B, H, S, D = MAIN
    q, k, v, bias = _inputs(1, *MAIN)
    scale = 1.0 / np.sqrt(D)
    n_seeds = B if kernel == "per_sample" else J.blocked_seed_count(B, H)
    seeds = np.random.RandomState(5).randint(
        0, 2 ** 31 - 1, size=n_seeds).astype(np.int32)
    jax_fn, torch_fn = KERNELS[kernel]

    def run(v_):
        ref = jax_fn(*(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v_)),
                     jnp.asarray(bias), scale, 0.1, jnp.asarray(seeds))
        out = torch_fn(*(torch.from_numpy(x).bfloat16() for x in (q, k, v_)),
                       torch.from_numpy(bias), scale, 0.1,
                       torch.from_numpy(seeds))
        assert out.dtype == torch.bfloat16
        return out.float().numpy(), np.asarray(ref, np.float32)

    out, ref = run(v)
    np.testing.assert_allclose(out, ref, atol=2e-2, rtol=0)
    eye = np.zeros_like(v)
    eye[..., np.arange(D), np.arange(D)] = 1.0
    p_out, p_ref = run(eye)
    np.testing.assert_array_equal(p_out == 0, p_ref == 0)
    assert (p_out == 0).any()


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_plain_bf16_backward_matches_jax_grad_at_main_path_shape(kernel):
    """The bf16 plain backward against jax.grad of the Pallas kernel's
    custom VJP at S 160, D 64, dropout 0.1: each gradient within BWD_TOL of
    its largest magnitude."""
    B, H, S, D = MAIN
    q, k, v, bias, do, seeds, group = _bwd_case(2, *MAIN, "bfloat16", kernel)
    scale = 1.0 / np.sqrt(D)
    ref = _jax_grads(kernel, q, k, v, bias, do, scale, 0.1, seeds,
                     "bfloat16")
    got = T.fused_attention_bwd_plain(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
        torch.from_numpy(bias), torch.from_numpy(do).bfloat16(), scale, 0.1,
        torch.from_numpy(seeds), group)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        err = np.abs(g.float().numpy() - r).max() / np.abs(r).max()
        assert err <= BWD_TOL["bfloat16"], err


# ---------------------------------------- 3×TF32 products, emulated on the CPU

def _tf32(x):
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` does (and mma_tf32.cuh's
    ``to_tf32``): the low 13 mantissa bits dropped, the magnitude rounded
    half away from zero."""
    u = x.contiguous().view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_truncated(x):
    """x as the tensor core reads an fp32 register as TF32: the low 13
    mantissa bits ignored."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm_3xtf32(a, b):
    """a·b as the mma_tf32x3 bodies take it: each operand split into
    hi = tf32(x) and lo = x − hi (read truncated), the small products summed
    before the large one, in fp32."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32_truncated(a - a_hi), _tf32_truncated(b - b_hi)
    return (a_lo @ b_hi + a_hi @ b_lo) + a_hi @ b_hi


def _mm_1xtf32(a, b):
    return _tf32(a) @ _tf32(b)


def _emulated_attention(mm, q, k, v, bias, do, scale, keep, c):
    """The mma_tf32x3 forward and one-launch backward, step for step in
    torch with the products of ``mm``: the forward keeps each row's max and
    sum of exp; the backward rebuilds pᵀ from them over keys × queries, takes
    Δ = rowsum(dout ∘ out) and does five products."""
    B, S = q.shape[0], q.shape[2]
    s = mm(q, k.transpose(-1, -2)) * scale + bias.reshape(B, 1, 1, S)
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    l = e.sum(-1, keepdim=True)
    p = e / l
    zero = torch.zeros(())
    out = mm(p if keep is None else torch.where(keep, p * c, zero), v)
    st = (mm(k, q.transpose(-1, -2)) * scale + bias.reshape(B, 1, S, 1))
    pt = torch.exp(st - m.transpose(-1, -2)) / l.transpose(-1, -2)
    dpt = mm(v, do.transpose(-1, -2))
    pdt = pt
    if keep is not None:
        kt = keep.transpose(-1, -2)
        pdt = torch.where(kt, pt * c, zero)
        dpt = torch.where(kt, dpt * c, zero)
    dst = pt * (dpt - (do * out).sum(-1)[:, :, None, :])
    dq = mm(dst.transpose(-1, -2), k) * scale
    dk = mm(dst, q) * scale
    dv = mm(pdt, do)
    return out, (dq, dk, dv)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_3xtf32_products_hold_fp32_tolerance(rate):
    """At the main path's S 160, D 64 with chip_smoke.py's inputs (normal
    q, k, v and dout; keys past a length in [20, 160] biased −10000), the
    mma_tf32x3 math with emulated 3×TF32 products is within 1e-5 of the
    plain forward (absolute) and of each plain gradient's largest
    magnitude, as chip_smoke.py holds the kernels on the card. One TF32
    product a product is not."""
    B, H, S, D = 2, 12, 160, 64
    rng = np.random.RandomState(7)
    q, k, v, do = (torch.from_numpy(rng.randn(B, H, S, D).astype(np.float32))
                   for _ in range(4))
    lens = rng.randint(20, S + 1, size=B)
    bias = torch.from_numpy(((np.arange(S)[None] >= lens[:, None])
                             * -10000.0)[:, None, None, :].astype(np.float32))
    seeds = torch.from_numpy(rng.randint(0, 2 ** 31 - 1, B).astype(np.int32))
    scale = D ** -0.5
    keep, c = None, 1.0
    if rate > 0:
        keep = T._keep_mask((H, S, S), rate,
                            seeds.to(torch.int64)).reshape(B, H, S, S)
        c = T._dropout_scale(rate)
    ref_out = T.fused_attention_plain(q, k, v, bias, scale, rate, seeds)
    ref_grads = T.fused_attention_bwd_plain(q, k, v, bias, do, scale, rate,
                                            seeds, H)

    def errors(mm):
        out, grads = _emulated_attention(mm, q, k, v, bias, do, scale, keep,
                                         c)
        rel = max(float((g - r).abs().max() / r.abs().max())
                  for g, r in zip(grads, ref_grads))
        return float((out - ref_out).abs().max()), rel

    fwd, bwd = errors(_mm_3xtf32)
    assert fwd <= 1e-5 and bwd <= 1e-5, (fwd, bwd)
    fwd, bwd = errors(_mm_1xtf32)
    assert fwd > 1e-5 and bwd > 1e-5, (fwd, bwd)
