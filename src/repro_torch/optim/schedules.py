"""Learning-rate schedules as step -> lr callables on device tensors (port
of `repro.optim.schedules`); each returns a float32 scalar tensor on the
step's device."""
from __future__ import annotations

import math

import torch


def constant_schedule(lr: float):
    def f(step: torch.Tensor) -> torch.Tensor:
        return torch.full((), lr, dtype=torch.float32, device=step.device)

    return f


def cosine_schedule(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step: torch.Tensor) -> torch.Tensor:
        t = torch.clamp(step.float() / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return lr * (final_frac + (1.0 - final_frac) * cos)

    return f


def linear_warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_schedule(lr, max(total_steps - warmup_steps, 1), final_frac)

    def f(step: torch.Tensor) -> torch.Tensor:
        warm = lr * step.float() / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm,
                           cos(step - warmup_steps))

    return f
