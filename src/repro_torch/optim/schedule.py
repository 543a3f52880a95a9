"""LR schedules (the reference's ``optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak_lr, warmup_steps, total_steps,
                    min_ratio=0.1, device=None):
    """Linear warmup to ``peak_lr`` over ``warmup_steps``, then a cosine
    down to ``min_ratio`` x ``peak_lr`` at ``total_steps``: a float32 0-d
    tensor on ``device`` (the step's own when ``step`` is a tensor, else
    the CPU), computed in float32 as the reference's is."""
    if torch.is_tensor(step):
        step = step.to(torch.float32)
    else:
        step = torch.tensor(float(step), dtype=torch.float32, device=device)
    warm = peak_lr * torch.clamp((step + 1) / max(warmup_steps, 1), max=1.0)
    t = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                    0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(step < warmup_steps, warm, peak_lr * cos)
