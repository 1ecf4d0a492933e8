"""Learning-rate schedules, step -> lr as an f32 scalar tensor (mirrors
``repro/optim/schedules.py``)."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def cosine_decay(lr: float, total_steps: int, final_frac: float = 0.1):
    def fn(step):
        t = torch.clamp(_step(step) / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return lr * (final_frac + (1 - final_frac) * cos)
    return fn


def warmup_cosine(lr: float, warmup: int, total_steps: int,
                  final_frac: float = 0.1):
    cos = cosine_decay(lr, max(total_steps - warmup, 1), final_frac)

    def fn(step):
        s = _step(step)
        wf = torch.clamp(s / max(warmup, 1), 0.0, 1.0)
        return torch.where(s < warmup, lr * wf, cos(s - warmup))
    return fn
