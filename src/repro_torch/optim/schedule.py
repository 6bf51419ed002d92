"""Learning-rate schedules (warmup + cosine decay), pure functions of step."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup: int = 100, total: int = 10_000,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """The schedule's multiplier at ``step`` (an int, or a 0-dim tensor
    whose device the result keeps) as a 0-dim f32 tensor."""
    if isinstance(step, torch.Tensor):
        s = step.to(torch.float32)
    else:
        s = torch.tensor(float(step), dtype=torch.float32)
    warm = torch.clamp(s / max(warmup, 1), max=1.0)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
