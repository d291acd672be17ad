from meme_challenge_tpu_torch.models.uniter import (
    UniterModel,
    MemeUniter,
)
