"""Learning-rate schedules, ported from ``src/repro/optim/schedules.py``:
functions of the (1-based) step, an int32 tensor, returning an fp32 tensor."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def cosine_warmup(peak: float, warmup_steps: int, total_steps: int,
                  floor: float = 0.1):
    """Linear warmup to ``peak`` then cosine decay to ``floor*peak``."""
    def f(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor * peak + (1 - floor) * peak * 0.5 * (1 + torch.cos(
            torch.tensor(math.pi, dtype=torch.float32) * t))
        return torch.where(step < warmup_steps, warm, cos)
    return f
