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


def fold_dropout_generators(seed: int, num_folds: int, step: int,
                            device) -> list:
    """The dropout generators of optimizer step ``step`` of every fold of a
    crossval seeded ``seed``: fold f's is the one a sequential run of that
    fold (seeded ``fold_seed(seed, f)``) draws from at that step, the
    counterpart of ``fold_in(prng_key(fold_seed(seed, f)), step)``."""
    return [dropout_generator(fold_seed(seed, f), step, device)
            for f in range(num_folds)]
