"""Learning-rate schedules (pure functions of the step counter).

Each returns a 0-d float32 tensor on the CPU, computed in float32 as the
JAX package's ``optim/schedules.py`` computes it; the step is an int or an
integer tensor.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(device="cpu", dtype=torch.float32)


def cosine_schedule(base_lr: float, total_steps: int, min_ratio: float = 0.1):
    def fn(step):
        t = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return base_lr * (min_ratio + (1 - min_ratio) * cos)

    return fn


def linear_warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                         min_ratio: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup_steps, 1), min_ratio)

    def fn(step):
        s = _f32(step)
        warm = base_lr * torch.clamp(s / max(warmup_steps, 1), max=1.0)
        return torch.where(s < warmup_steps, warm, cos(s - warmup_steps))

    return fn
