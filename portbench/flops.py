"""Operations and bytes of the meme model's work, counted from shapes.

Every count is over a sample's valid tokens: ``L = text tokens + regions``,
never the padded ``max_txt_len + max_bb``, so that a program that stops
computing on padding reads a higher share and never one over 100 %.

- :func:`forward_flops`: the model FLOPs of one sample's forward, two a
  multiply-add: the image and box projections over the regions, per layer
  the Q, K, V and output projections and the feed-forward over L tokens
  plus attention's ``4·L²·hidden`` (scores and the weighted sum), the pooler
  and the head on one token. Table lookups and elementwise work are not
  counted. A training step costs three forwards (the backward twice the
  forward); recomputation is not counted.
- :func:`attention_bound_s`: the least time one launch of the fused
  attention over a batch of samples can take: the larger of its operations
  (``4·H·L²·D`` a sample forward, ``10·H·L²·D`` backward) over the peak of
  its dtype and its bytes (q, k, v, the fp32 key bias and the output once,
  in the backward too, which reads the output; backward also dout, dq, dk
  and dv) over the memory's bandwidth.
"""
from __future__ import annotations

import json
import os
from typing import Iterable

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "peaks.json")
ITEM_BYTES = {"float32": 4, "bfloat16": 2}


def peaks(device_name: str) -> dict:
    """The published peaks of the card named ``device_name`` (the entry
    whose key the name contains)."""
    with open(PEAKS_FILE) as f:
        table = json.load(f)
    for key, entry in table.items():
        if key in device_name:
            return entry
    raise KeyError("no peaks for %r in %s" % (device_name, PEAKS_FILE))


def forward_flops(cfg: dict, txt_len: int, n_regions: int) -> float:
    """Model FLOPs of one sample's forward at ``txt_len`` valid text tokens
    and ``n_regions`` valid regions."""
    H, inner = cfg["hidden_size"], cfg["intermediate_size"]
    L = txt_len + n_regions
    embed = 2.0 * n_regions * H * (cfg["img_dim"] + cfg["pos_dim"])
    layer = 2.0 * L * (4 * H * H + 2 * H * inner) + 4.0 * L * L * H
    head = 2.0 * H * H + 2.0 * H * cfg.get("n_classes", 1)
    return embed + cfg["num_hidden_layers"] * layer + head


def step_flops(cfg: dict, lengths: Iterable[tuple], train: bool) -> float:
    """FLOPs of a batch of ``(txt_len, n_regions)`` samples: the forward,
    and three times it for a training step."""
    f = sum(forward_flops(cfg, t, r) for t, r in lengths)
    return 3.0 * f if train else f


def attention_ops_bytes(lengths: Iterable[int], heads: int, head_dim: int,
                        dtype: str, backward: bool) -> tuple:
    """(operations, bytes) of one attention launch over samples of valid
    lengths ``lengths``."""
    ops = nbytes = 0.0
    item = ITEM_BYTES[dtype]
    for L in lengths:
        ops += (10.0 if backward else 4.0) * heads * L * L * head_dim
        tensors = 8 if backward else 4
        nbytes += tensors * heads * L * head_dim * item + 4.0 * L
    return ops, nbytes


def attention_bound_s(lengths: Iterable[int], heads: int, head_dim: int,
                      dtype: str, backward: bool, peak: dict) -> float:
    """The least seconds of one attention launch (see the module's note)."""
    ops, nbytes = attention_ops_bytes(lengths, heads, head_dim, dtype,
                                      backward)
    return max(ops / peak["flops"][dtype], nbytes / peak["bytes_per_s"])
