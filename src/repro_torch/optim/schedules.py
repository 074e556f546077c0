"""LR schedules (counterpart of ``repro.optim.schedules``): warmup, then
cosine decay to a floor; or constant.  ``step`` is a tensor; the result is
an f32 tensor on its device."""

from __future__ import annotations

import math

import torch


def warmup_cosine(step: torch.Tensor, *, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    step = step.float()
    warm = peak_lr * step / max(warmup, 1)
    frac = ((step - warmup) / max(total - warmup, 1)).clamp(0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < warmup, warm, cos)


def constant(step: torch.Tensor, *, peak_lr: float) -> torch.Tensor:
    return torch.full_like(step, peak_lr, dtype=torch.float32)
