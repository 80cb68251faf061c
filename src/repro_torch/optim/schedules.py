"""Learning-rate schedules: a device step tensor -> an f32 device scalar,
with no host sync."""

from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=step.device)


def linear_warmup(lr: float, warmup_steps: int):
    def fn(step):
        frac = torch.clamp(step.float() / max(warmup_steps, 1), max=1.0)
        return lr * frac

    return fn


def cosine_warmup(lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    def fn(step):
        s = step.float()
        warm = s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return lr * torch.where(s < warmup_steps, warm, cos)

    return fn
