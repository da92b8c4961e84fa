"""Learning-rate schedules, functions of the step (port of
``repro.optim.schedules``); fp32 tensors on the step's device."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    step = torch.as_tensor(step).float()
    warm = peak_lr * step / max(warmup_steps, 1)
    progress = torch.clamp((step - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (min_ratio + (1 - min_ratio)
                     * 0.5 * (1 + torch.cos(math.pi * progress)))
    return torch.where(step < warmup_steps, warm, cos)


def warmup_linear(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int) -> torch.Tensor:
    step = torch.as_tensor(step).float()
    warm = peak_lr * step / max(warmup_steps, 1)
    decay = peak_lr * torch.clamp(
        (total_steps - step) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    return torch.where(step < warmup_steps, warm, decay)
