"""Learning-rate schedules (port of ``repro/optim/schedules.py``): pure
functions of an integer step tensor, returning an fp32 tensor on the
step's device."""
from __future__ import annotations

import math

import torch


def constant_schedule(lr: float):
    def sched(step):
        step = torch.as_tensor(step)
        return torch.full((), lr, dtype=torch.float32, device=step.device)
    return sched


def cosine_schedule(lr: float, total_steps: int, final_frac: float = 0.1):
    def sched(step):
        frac = torch.clamp(torch.as_tensor(step) / max(total_steps, 1),
                           0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
        return lr * (final_frac + (1.0 - final_frac) * cos)
    return sched


def linear_warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_schedule(lr, max(total_steps - warmup_steps, 1), final_frac)

    def sched(step):
        step = torch.as_tensor(step)
        warm = lr * (step + 1) / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm, cos(step - warmup_steps))
    return sched
