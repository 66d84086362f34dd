"""LR schedules, following the JAX package's ``optim/schedule.py``: the
same float32 arithmetic, on a 0-dim tensor."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak_lr=3e-4, warmup=2000, total=100_000,
                    min_frac=0.1):
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to ``min_frac * peak_lr`` at ``total``. ``step``: an int or a
    0-dim tensor (the optimizer's ``count``); returns a float32 0-dim
    tensor on the step's device (the CPU for an int)."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * torch.clamp(s, max=warmup) / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (min_frac + (1 - min_frac) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup, warm, cos)
