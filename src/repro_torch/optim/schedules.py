"""Learning-rate schedules: float32 functions of the int32 step tensor
(the port's counterpart of :mod:`repro.optim.schedules`)."""
from __future__ import annotations

import math

import torch

__all__ = ["constant", "cosine", "warmup_cosine"]


def constant(value: float):
    """η(step) = value."""
    return lambda step: torch.tensor(value, dtype=torch.float32,
                                     device=step.device)


def cosine(peak: float, total_steps: int, final_frac: float = 0.1):
    """Cosine decay from ``peak`` to ``final_frac · peak`` over
    ``total_steps``."""
    def f(step):
        t = torch.clamp(step.float() / total_steps, 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return peak * (final_frac + (1 - final_frac) * cos)
    return f


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warm-up to ``peak`` over ``warmup_steps``, then
    :func:`cosine` over the rest."""
    def f(step):
        s = step.float()
        warm = peak * s / max(warmup_steps, 1)
        t = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps,
                                                 1), 0.0, 1.0)
        cos = peak * (final_frac + (1 - final_frac)
                      * 0.5 * (1 + torch.cos(math.pi * t)))
        return torch.where(s < warmup_steps, warm, cos)
    return f
