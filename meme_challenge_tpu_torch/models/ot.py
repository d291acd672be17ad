"""IPOT optimal-transport word-region alignment distance.

Counterpart of ``meme_challenge_tpu/models/ot.py`` (reference model/ot.py):
the cosine cost matrix, the masked inexact-proximal-OT iterations and the
OT distance trace(Cᵀ·T), in fp32 as plain torch operations. The JAX
package's two ``lax.fori_loop``s become a python loop of ``iteration`` ×
``k`` steps; the transport plan is computed under ``torch.no_grad()`` (JAX
``stop_gradient``, the reference's ``@torch.no_grad()``), so gradients flow
only through the cost matrix in the final trace. One IPOT iteration at
``k = 1`` issues about fifteen kernels on a card, so a call with the
default 50 iterations launches about 740.
"""
from __future__ import annotations

import torch


def cost_matrix_cosine(x: torch.Tensor, y: torch.Tensor,
                       eps: float = 1e-5) -> torch.Tensor:
    """Pairwise cosine distance [B, M, D] × [B, N, D] → [B, M, N].

    torch F.normalize semantics: v / max(‖v‖₂, eps).
    """
    x = x.float()
    y = y.float()
    x_norm = x / torch.clamp_min(
        torch.linalg.vector_norm(x, dim=-1, keepdim=True), eps)
    y_norm = y / torch.clamp_min(
        torch.linalg.vector_norm(y, dim=-1, keepdim=True), eps)
    return 1.0 - torch.bmm(x_norm, y_norm.transpose(1, 2))


@torch.no_grad()
def ipot(C: torch.Tensor, x_len: torch.Tensor, x_pad: torch.Tensor,
         y_len: torch.Tensor, y_pad: torch.Tensor, joint_pad: torch.Tensor,
         beta: float = 0.5, iteration: int = 50, k: int = 1) -> torch.Tensor:
    """Masked IPOT solver. C [B,M,N]; pads are boolean (True = padding).

    Returns the transport plan T [B, N, M] (note the transpose, matching the
    reference's layout, ot.py:41).
    """
    b, m, n = C.shape
    C = C.float()
    x_len = x_len.float()[:, None, None]                  # [B,1,1]
    y_len = y_len.float()[:, None, None]
    sigma = torch.where(x_pad, 0.0, 1.0 / x_len[:, :, 0])  # [B,M]
    joint_pad_t = joint_pad.transpose(1, 2)               # [B,N,M]
    T = torch.where(joint_pad_t, 0.0,
                    torch.ones((b, n, m), dtype=C.dtype, device=C.device))
    A = torch.where(joint_pad_t, 0.0, torch.exp(-C.transpose(1, 2) / beta))
    x_mask = (x_pad.float() * 1e4)[:, None, :]            # [B,1,M]
    y_mask = (y_pad.float() * 1e4)[:, None, :]            # [B,1,N]
    for _ in range(iteration):
        Q = A * T                                         # [B,N,M]
        sigma_col = sigma[:, :, None]                     # [B,M,1]
        delta = torch.zeros((b, 1, n), dtype=C.dtype, device=C.device)
        for _ in range(k):
            qs = torch.bmm(Q, sigma_col)                  # [B,N,1]
            delta = 1.0 / (y_len * qs.transpose(1, 2) + y_mask)  # [B,1,N]
            dq = torch.bmm(delta, Q)                      # [B,1,M]
            sigma_col = (1.0 / (x_len * dq + x_mask)).transpose(1, 2)
        # [B,N,1] * [B,N,M] * [B,1,M]
        T = delta.transpose(1, 2) * Q * sigma_col.transpose(1, 2)
        sigma = sigma_col[:, :, 0]
    return torch.where(joint_pad_t, 0.0, T)


def optimal_transport_dist(txt_emb: torch.Tensor, img_emb: torch.Tensor,
                           txt_pad: torch.Tensor, img_pad: torch.Tensor,
                           beta: float = 0.5, iteration: int = 50,
                           k: int = 1) -> torch.Tensor:
    """OT distance per sample [B] (reference ot.py:69-85).

    txt_emb [B,M,D], img_emb [B,N,D]; pads boolean with True = padding.
    """
    cost = cost_matrix_cosine(txt_emb, img_emb)
    joint_pad = txt_pad[:, :, None] | img_pad[:, None, :]
    cost = torch.where(joint_pad, 0.0, cost)
    txt_len = (txt_pad.shape[1] - txt_pad.sum(dim=1)).float()
    img_len = (img_pad.shape[1] - img_pad.sum(dim=1)).float()
    T = ipot(cost.detach(), txt_len, txt_pad, img_len, img_pad, joint_pad,
             beta, iteration, k)
    # trace(C · T): diagonal sum of [B,M,N] @ [B,N,M]
    return torch.einsum("bmn,bnm->b", cost, T)
