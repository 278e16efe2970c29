"""Learning-rate schedules, ported from ``repro.optim.schedules``: each maps
the optimizer's int32 step count (a 0-d tensor) to a 0-d fp32 rate on the
count's device."""

from __future__ import annotations

import math

import torch

__all__ = ["constant", "warmup_cosine"]


def constant(lr: float):
    return lambda count: torch.tensor(lr, dtype=torch.float32, device=count.device)


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int, floor: float = 0.0):
    """Linear warmup to ``peak_lr``, then cosine decay to ``floor``."""

    def sched(count):
        c = count.to(torch.float32)
        warm = peak_lr * c / max(warmup_steps, 1)
        t = torch.clamp((c - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + 0.5 * (peak_lr - floor) * (1 + torch.cos(math.pi * t))
        return torch.where(c < warmup_steps, warm, cos)

    return sched
