"""Learning-rate schedules: pure functions of the device step tensor (the
reference's ``optim/schedules.py``), so the train step reads no step on
the host."""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import TrainConfig


def learning_rate(step: torch.Tensor, tc: TrainConfig) -> torch.Tensor:
    """Linear warmup over ``tc.warmup_steps``, then constant, linear (to
    0.1x) or cosine (to 0.1x) over the rest of ``tc.total_steps``. step: a
    0-d int tensor; returns a 0-d f32 tensor on its device."""
    s = step.float()
    warm = torch.clamp((s + 1.0) / max(1, tc.warmup_steps), max=1.0)
    if tc.schedule == "constant":
        post = 1.0
    else:
        frac = torch.clamp((s - tc.warmup_steps)
                           / max(1, tc.total_steps - tc.warmup_steps), 0.0, 1.0)
        if tc.schedule == "linear":
            post = 1.0 - 0.9 * frac
        else:  # cosine
            post = 0.1 + 0.45 * (1.0 + torch.cos(math.pi * frac))
    return tc.learning_rate * warm * post
