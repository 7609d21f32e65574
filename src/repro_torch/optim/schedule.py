"""LR schedules, pure functions of the step counter (port of
``repro/optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to min_ratio; a float32 scale in
    (0, 1] on the device of ``step``."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(warmup_steps, 1)
    prog = ((s - warmup_steps) / max(total_steps - warmup_steps, 1)).clamp(0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(s < warmup_steps, warm, cos)


def constant(step, *, value: float = 1.0) -> torch.Tensor:
    return torch.full((), value, dtype=torch.float32,
                      device=torch.as_tensor(step).device)
