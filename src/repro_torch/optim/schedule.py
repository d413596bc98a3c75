"""Learning-rate schedules (port of ``repro.optim.schedule``), on float32 tensors."""
from __future__ import annotations

import math

import torch

__all__ = ["warmup_cosine", "constant"]


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int, floor: float = 0.1):
    """Linear warmup to ``peak`` then cosine decay to ``floor * peak``.

    The schedule takes a step (an int or a tensor) and returns a float32
    0-d tensor on the step's device (the CPU for an int)."""

    def sched(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak * step / max(warmup_steps, 1)
        frac = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        frac = frac.clamp(0.0, 1.0)
        cos = floor * peak + (1 - floor) * peak * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(step < warmup_steps, warm, cos)

    return sched


def constant(value: float):
    return lambda step: torch.full((), value, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)
