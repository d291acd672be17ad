"""Seed discipline.

Counterpart of ``meme_challenge_tpu/core/seeding.py``. Host stochastic
decisions (crossval splits, confounder sampler order) stay in the python and
numpy global RNGs with the reference's seed usage (utils/utils.py:100-107);
device randomness (weight init) takes an explicit ``torch.Generator`` made
from the same seed, in place of the JAX package's ``prng_key``.
"""
from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int) -> None:
    """Seed python + numpy global RNGs (reference utils/utils.py:100-107)."""
    np.random.seed(seed)
    random.seed(seed)


def fold_seed(seed: int, fold_idx: int) -> int:
    """Per-fold reseed, reference utils/crossval.py:174 (seed + fold_idx)."""
    return seed + fold_idx


def torch_generator(seed: int, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device``, seeded with ``seed``."""
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed))
