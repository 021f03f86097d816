"""LR schedules, pure functions of the step (port of
`repro.optim.schedule`).  The step may be an int or a tensor; the
result is a float32 scalar tensor on the step's device."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(step, *, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    step = _step(step)
    warm = peak_lr * step / max(warmup, 1)
    t = ((step - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * t)))
    return torch.where(step < warmup, warm, cos)


def constant(step, *, peak_lr: float, **_) -> torch.Tensor:
    return torch.full_like(_step(step), peak_lr)
