"""Operations and bytes of the Moonlight cell's work, counted from shapes,
valid tokens and the rows the program's counter saw.

- :func:`dense_forward_flops`: the model FLOPs of one sample's forward
  outside the routed experts, over its ``L`` valid tokens (two a
  multiply-add): per layer MLA's projections (q, the latent and rope key,
  the latent's keys and values, the output) and causal attention
  (``L(L+1)/2`` query-key pairs of ``heads·(nope + rope)`` and of
  ``heads·v``), the dense SwiGLU of layer 0, the router and the shared
  experts of the others; the head on one token. Lookups, norms and
  elementwise work are not counted.
- :func:`expert_row_flops`: one routed row's forward through a held
  expert (``gate_up`` and ``down``: ``6·H·I``). A training step counts
  three forwards (the backward twice the forward); the program's
  recomputation of ``gate_up`` is not counted.
- :func:`expert_launch_bounds`: the least seconds of each launch of the
  grouped expert kernel in a training step (forward: ``gate_up`` and
  ``down``; backward: ``gate_up`` again, two dgrads and two wgrads), the
  larger of its operations over the float32 peak and its bytes (the held
  experts' weights, or the weight gradients a wgrad writes, plus the rows'
  inputs and outputs, each once) over the memory's bandwidth.
"""
from __future__ import annotations

from typing import Iterable, List


def dense_forward_flops(cfg: dict, L: int) -> float:
    H, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    nope, rope, vd = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                      cfg["v_head_dim"])
    lat = cfg["kv_lora_rank"]
    proj = 2.0 * L * (H * heads * (nope + rope) + H * (lat + rope)
                      + lat * heads * (nope + vd) + heads * vd * H)
    pairs = L * (L + 1) / 2.0
    attn = 2.0 * pairs * heads * (nope + rope + vd)
    dense = 6.0 * L * H * cfg["intermediate_size"]
    moe = 2.0 * L * H * cfg["n_routed_experts_published"] \
        + 6.0 * L * H * cfg["moe_intermediate_size"] * cfg["n_shared_experts"]
    n_dense = cfg["first_k_dense_replace"]
    layers = cfg["num_hidden_layers"]
    head = 2.0 * H * 512 + 2.0 * 512 * cfg.get("n_classes", 1)
    return layers * (proj + attn) + n_dense * dense \
        + (layers - n_dense) * moe + head


def expert_row_flops(cfg: dict) -> float:
    return 6.0 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def step_flops(cfg: dict, lengths: Iterable[int], expert_rows: float
               ) -> float:
    """Model FLOPs of a training step over samples of ``lengths`` valid
    tokens whose layers routed ``expert_rows`` rows to the held experts in
    all."""
    f = sum(dense_forward_flops(cfg, int(L)) for L in lengths)
    return 3.0 * (f + expert_rows * expert_row_flops(cfg))


def expert_launches(cfg: dict, rows: float) -> List[tuple]:
    """(operations, bytes) of each grouped launch of one layer's training
    pass over ``rows`` routed rows (``[rows]`` summed over the held
    experts)."""
    H, I, E = (cfg["hidden_size"], cfg["moe_intermediate_size"],
               cfg["n_routed_experts"])
    w_gu, w_down = 4.0 * E * 2 * I * H, 4.0 * E * H * I
    f_gu, f_down = 2.0 * rows * H * 2 * I, 2.0 * rows * I * H
    return [(f_gu, w_gu + 4.0 * rows * (H + 2 * I)),       # forward gate_up
            (f_down, w_down + 4.0 * rows * (I + H)),       # forward down
            (f_gu, w_gu + 4.0 * rows * (H + 2 * I)),       # recompute
            (f_down, w_down + 4.0 * rows * (H + I)),       # dgrad down
            (f_down, w_down + 4.0 * rows * (H + I)),       # wgrad down
            (f_gu, w_gu + 4.0 * rows * (2 * I + H)),       # dgrad gate_up
            (f_gu, w_gu + 4.0 * rows * (2 * I + H))]       # wgrad gate_up


def expert_launch_bounds(cfg: dict, rows_per_layer: Iterable[float],
                         peak: dict) -> List[float]:
    """The least seconds of every grouped launch of the layers whose routed
    rows are ``rows_per_layer``."""
    out = []
    for rows in rows_per_layer:
        for ops, nbytes in expert_launches(cfg, rows):
            out.append(max(ops / peak["flops"]["float32"],
                           nbytes / peak["bytes_per_s"]))
    return out
