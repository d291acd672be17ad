from meme_challenge_tpu_torch.core.config import UniterConfig, TrainConfig, UNITER_BASE, UNITER_LARGE
from meme_challenge_tpu_torch.core.constants import IMG_DIM, IMG_DIM_OSCAR, IMG_LABEL_DIM, POS_DIM
from meme_challenge_tpu_torch.core.metrics import (
    standard_metrics,
    find_optimal_threshold,
    aucroc,
)
