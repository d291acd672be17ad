"""Parameter initialization of ``UniterForPretraining``.

Counterpart of ``meme_challenge_tpu/train/pretrain_init.py``. The port's
modules create every parameter when they are built, so no example batch is
traced: the model is built on the meta device, moved to ``device`` empty,
and every weight (trunk and heads) is drawn by ``init_weights`` from
``generator``. It consumes no host RNG, so the pretraining batch stream
does not depend on the initialization (JAX pretrain_uniter.py:183-190).
"""
from __future__ import annotations

import torch

from meme_challenge_tpu_torch.core.config import UniterConfig
from meme_challenge_tpu_torch.core.constants import IMG_LABEL_DIM
from meme_challenge_tpu_torch.models.uniter import (
    UniterForPretraining,
    init_weights,
)


def init_pretrain_model(config: UniterConfig,
                        img_label_dim: int = IMG_LABEL_DIM, device="cpu",
                        generator: torch.Generator = None
                        ) -> UniterForPretraining:
    """A ``UniterForPretraining`` on ``device`` with random weights from
    ``generator``: normal(initializer_range) matrices and tables, zero
    biases, unit LayerNorm scales, as the JAX package initializes it."""
    with torch.device("meta"):
        model = UniterForPretraining(config, img_label_dim=img_label_dim)
    model = model.to_empty(device=torch.device(device))
    init_weights(model, generator, config.initializer_range)
    return model.eval()
