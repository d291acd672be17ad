"""Learning-rate schedules.

Counterpart of ``meme_challenge_tpu/train/schedules.py`` (reference
train_template.py:72-82). Each schedule is a function of the optimizer-step
count → multiplicative LR factor, composed with the base lr by the
optimizer. The count lives on the host (``optim.Optimizer`` keeps it as an
int), so a schedule is evaluated in numpy float32, the precision the JAX
functions compute in, and costs no device work or host sync.

The horizons are in *iterations* (``len(train_loader) · max_epoch``) while
the schedule advances once per *optimizer* step, as in the reference, so with
gradient accumulation the cosine / linear decay never completes.
"""
from __future__ import annotations

import math

import numpy as np

_F = np.float32


def step_schedule(lr_decay_step: int, lr_decay_factor: float):
    """torch StepLR: lr · γ^⌊step/step_size⌋ (train_template.py:73-74)."""
    def fn(step):
        return float(_F(lr_decay_factor) ** _F(step // lr_decay_step))
    return fn


def multi_step_schedule(milestones=(5, 10, 15, 25, 40), lr_decay_factor=0.8):
    """torch MultiStepLR at the reference's fixed milestones
    (train_template.py:75-76)."""
    def fn(step):
        return float(_F(lr_decay_factor)
                     ** _F(sum(step >= m for m in milestones)))
    return fn


def warmup_linear_schedule(warmup_steps: int, total_steps: int):
    """transformers get_linear_schedule_with_warmup (train_template.py:77-79)."""
    def fn(step):
        step = _F(step)
        if step < warmup_steps:
            return float(step / _F(max(1.0, warmup_steps)))
        decay = (_F(total_steps) - step) / _F(max(1.0, total_steps
                                                  - warmup_steps))
        return float(max(_F(0.0), decay))
    return fn


def warmup_cosine_schedule(warmup_steps: int, total_steps: int,
                           num_cycles: float = 0.5):
    """transformers get_cosine_schedule_with_warmup (train_template.py:80-82)."""
    def fn(step):
        step = _F(step)
        if step < warmup_steps:
            return float(step / _F(max(1.0, warmup_steps)))
        progress = (step - _F(warmup_steps)) / _F(max(1.0, total_steps
                                                      - warmup_steps))
        cos = _F(0.5) * (_F(1.0) + np.cos(_F(math.pi * num_cycles * 2.0)
                                          * progress))
        return float(max(_F(0.0), cos))
    return fn


def make_schedule(name: str, *, warmup_steps: int, total_steps: int,
                  lr_decay_step: int, lr_decay_factor: float):
    """Dispatch matching reference init_scheduler (train_template.py:72-82)."""
    if name == "step":
        return step_schedule(lr_decay_step, lr_decay_factor)
    if name == "multi_step":
        return multi_step_schedule(lr_decay_factor=lr_decay_factor)
    if name == "warmup":
        return warmup_linear_schedule(warmup_steps, total_steps)
    if name == "warmup_cosine":
        return warmup_cosine_schedule(warmup_steps, total_steps)
    if name in ("none", "constant"):
        return lambda step: 1.0
    raise ValueError(f"unknown scheduler: {name}")
