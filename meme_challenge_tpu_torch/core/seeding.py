"""Seed discipline.

Counterpart of ``meme_challenge_tpu/core/seeding.py``. Host stochastic
decisions (crossval splits, confounder sampler order) stay in the python and
numpy global RNGs with the reference's seed usage (utils/utils.py:100-107);
device randomness takes explicit ``torch.Generator``s in place of the JAX
package's ``prng_key``: weight init one made from the seed, and each
optimizer step's dropout one made from (seed, step), the counterpart of
``fold_in(root_rng, step)``, so a step's dropout does not depend on how the
steps were grouped into dispatches.
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


def dropout_generator(seed: int, step: int, device) -> torch.Generator:
    """The ``torch.Generator`` on ``device`` that optimizer step ``step`` of
    a run seeded ``seed`` draws its dropout from, seeded with 63 bits of
    numpy's SeedSequence over (seed, step)."""
    ss = np.random.SeedSequence([int(seed) & 0xFFFFFFFFFFFFFFFF, int(step)])
    return torch_generator(int(ss.generate_state(1, np.uint64)[0]) >> 1,
                           device)
