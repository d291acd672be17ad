"""PyTorch port, ``models/ot.py`` (IPOT word-region alignment) against the
JAX package's ``models/ot.py`` in the same process: the cosine cost matrix,
the transport plan and the OT distance within 1e-5, with and without
padding, and the distance's gradient with respect to both embeddings
against ``jax.grad`` within 1e-5. (tests/test_ot.py holds the JAX package
to the reference's own code, which is not in this repository.)"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from meme_challenge_tpu.models import ot as JO
from meme_challenge_tpu_torch.models import ot as PO

TOL = 1e-5


def _inputs(padded: bool, seed: int = 0, B=3, M=9, N=11, D=16):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, M, D).astype(np.float32)
    y = rng.randn(B, N, D).astype(np.float32)
    txt_pad = np.zeros((B, M), bool)
    img_pad = np.zeros((B, N), bool)
    if padded:
        txt_pad[1, 5:] = True
        txt_pad[2, 3:] = True
        img_pad[0, 7:] = True
        img_pad[2, 4:] = True
    return x, y, txt_pad, img_pad


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def test_cost_matrix_cosine_matches_jax():
    x, y, _, _ = _inputs(False)
    x[0, 2] = 0.0  # a zero vector: the eps floor of the norm
    want = np.asarray(JO.cost_matrix_cosine(*_j(x, y)))
    got = PO.cost_matrix_cosine(*_t(x, y)).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
@pytest.mark.parametrize("beta,iteration,k", [(0.5, 50, 1), (0.1, 20, 3)])
def test_ipot_plan_matches_jax(padded, beta, iteration, k):
    x, y, tp, ip = _inputs(padded, seed=1)
    joint = tp[:, :, None] | ip[:, None, :]
    cost = np.where(joint, 0.0,
                    np.asarray(JO.cost_matrix_cosine(*_j(x, y))))
    cost = cost.astype(np.float32)
    x_len = (tp.shape[1] - tp.sum(1)).astype(np.float32)
    y_len = (ip.shape[1] - ip.sum(1)).astype(np.float32)
    want = np.asarray(JO.ipot(*_j(cost, x_len, tp, y_len, ip, joint),
                              beta, iteration, k))
    got = PO.ipot(*_t(cost, x_len, tp, y_len, ip, joint), beta, iteration,
                  k).numpy()
    assert got.shape == (3, 11, 9)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    assert (got[np.swapaxes(joint, 1, 2)] == 0).all()


@pytest.mark.parametrize("padded", [False, True], ids=["full", "padded"])
def test_ot_distance_and_gradients_match_jax(padded):
    x, y, tp, ip = _inputs(padded, seed=2)

    def jax_total(a, b):
        d = JO.optimal_transport_dist(a, b, jnp.asarray(tp), jnp.asarray(ip))
        return jnp.sum(d * jnp.arange(1.0, 4.0)), d

    (_, want), (gx, gy) = jax.value_and_grad(jax_total, argnums=(0, 1),
                                             has_aux=True)(*_j(x, y))
    xt, yt = (torch.from_numpy(a).requires_grad_() for a in (x, y))
    got = PO.optimal_transport_dist(xt, yt, *_t(tp, ip))
    (got * torch.arange(1.0, 4.0)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), atol=TOL,
                               rtol=0)
    np.testing.assert_allclose(yt.grad.numpy(), np.asarray(gy), atol=TOL,
                               rtol=0)
    # no gradient reaches padded positions
    assert (xt.grad.numpy()[tp] == 0).all()
    assert (yt.grad.numpy()[ip] == 0).all()


def test_plan_carries_no_gradient():
    """The plan is computed without autograd (JAX ``stop_gradient``): the
    distance's gradient is the cost's gradient weighted by the plan."""
    x, y, tp, ip = _inputs(True, seed=3)
    xt, yt = (torch.from_numpy(a).requires_grad_() for a in (x, y))
    joint = torch.from_numpy(tp[:, :, None] | ip[:, None, :])
    cost = torch.where(joint, 0.0, PO.cost_matrix_cosine(xt, yt))
    x_len = torch.from_numpy((9 - tp.sum(1)).astype(np.float32))
    y_len = torch.from_numpy((11 - ip.sum(1)).astype(np.float32))
    plan = PO.ipot(cost, x_len, torch.from_numpy(tp), y_len,
                   torch.from_numpy(ip), joint)
    assert not plan.requires_grad
    direct = torch.einsum("bmn,bnm->b", cost, plan).sum()
    gx, gy = torch.autograd.grad(direct, (xt, yt))
    PO.optimal_transport_dist(xt, yt, *_t(tp, ip)).sum().backward()
    torch.testing.assert_close(xt.grad, gx, atol=0, rtol=0)
    torch.testing.assert_close(yt.grad, gy, atol=0, rtol=0)
