"""Learning-rate schedules — a copy of :mod:`repro.optim.schedule`."""

from __future__ import annotations

import math

import torch


def warmup_cosine(
    step: torch.Tensor,
    peak_lr: float = 3e-4,
    warmup_steps: int = 200,
    total_steps: int = 10_000,
    floor: float = 0.1,
) -> torch.Tensor:
    """Linear warmup to ``peak_lr``, then a cosine decay to ``floor·peak_lr``
    at ``total_steps``. ``step`` is a tensor (the optimizer's step count
    before the update); returns a float32 tensor on its device. Step 0 of a
    warmup gives exactly 0."""
    s = step.to(torch.float32)
    warm = peak_lr * torch.clamp(s / max(warmup_steps, 1), max=1.0)
    frac = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1),
                       0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(s < warmup_steps, warm, cos)
