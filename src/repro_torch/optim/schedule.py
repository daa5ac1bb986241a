"""Learning-rate schedules (the JAX package's ``optim/schedule.py``)."""
from __future__ import annotations

import math

import torch


def cosine_schedule(peak_lr: float, warmup_steps: int, total_steps: int, final_frac: float = 0.1):
    """Linear warm-up to ``peak_lr`` over ``warmup_steps``, then a cosine
    decay to ``final_frac * peak_lr`` at ``total_steps``. The returned
    function takes the step as a plain int (returns a float) or as a tensor
    (returns a 0-d float32 tensor on the step's device, so that a step on
    the card is never read on the host); either way the arithmetic is the
    reference's, in float32."""

    def schedule(step):
        s = step.float() if isinstance(step, torch.Tensor) else torch.tensor(float(step), dtype=torch.float32)
        warm = peak_lr * s / max(1, warmup_steps)
        progress = torch.clamp((s - warmup_steps) / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * progress)))
        lr = torch.where(s < warmup_steps, warm, cos)
        return lr if isinstance(step, torch.Tensor) else float(lr)

    return schedule
