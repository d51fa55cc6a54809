"""Learning-rate schedules, as 0-d f32 tensors (JAX's f32 arithmetic)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, min_ratio: float = 0.1) -> torch.Tensor:
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = step / max(warmup_steps, 1)
    prog = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return peak_lr * torch.where(step < warmup_steps, warm, cos)


def constant(step, *, peak_lr: float, **_) -> torch.Tensor:
    return torch.full_like(torch.as_tensor(step, dtype=torch.float32),
                           peak_lr)
