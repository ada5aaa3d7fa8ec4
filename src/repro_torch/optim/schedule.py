"""Learning-rate schedules (the port of `repro/optim/schedule.py`): pure
functions of the step counter, an int tensor, returning an f32 tensor."""

from __future__ import annotations

import math

import torch


def linear_warmup_cosine(peak_lr: float, warmup: int, total: int,
                         floor_frac: float = 0.1):
    def lr(step):
        step = step.float()
        warm = peak_lr * step / max(warmup, 1)
        prog = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor_frac + (1 - floor_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup, warm, cos)
    return lr


def constant(lr_value: float):
    return lambda step: torch.full((), lr_value, dtype=torch.float32,
                                   device=step.device)
