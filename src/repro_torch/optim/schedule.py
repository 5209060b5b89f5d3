"""Learning-rate schedules."""
from __future__ import annotations

import math

import torch


def warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warm-up to ``peak_lr``, then cosine decay to
    ``final_frac * peak_lr``.  ``lr(step)`` takes an int or a 0-d tensor
    and returns a 0-d float32 tensor (on the step's device)."""

    def lr(step):
        step = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * (step + 1) / max(1, warmup_steps)
        prog = torch.clamp((step - warmup_steps)
                           / max(1, total_steps - warmup_steps), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)

    return lr
