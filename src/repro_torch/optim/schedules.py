"""Learning-rate schedules.

The port of ``repro.optim.schedules``, computed in f32 as ``repro``'s are:
a schedule maps a Python step to a Python float and a tensor step to a
0-d f32 tensor on the step's device.
"""
from __future__ import annotations

import math

import torch


def _ratio(step, n: int) -> torch.Tensor:
    """step / n in f32: a Python step divides in Python first, as
    ``repro``'s does before ``jnp`` sees it."""
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32) / n
    return torch.tensor(step / n, dtype=torch.float32)


def _out(value: torch.Tensor, step):
    return value if isinstance(step, torch.Tensor) else float(value)


def cosine_schedule(base_lr: float, total_steps: int, min_frac: float = 0.1):
    def lr(step):
        t = torch.clamp(_ratio(step, max(total_steps, 1)), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return _out(base_lr * (min_frac + (1 - min_frac) * cos), step)
    return lr


def linear_warmup_cosine(base_lr: float, warmup_steps: int, total_steps: int,
                         min_frac: float = 0.1):
    cos = cosine_schedule(base_lr, max(total_steps - warmup_steps, 1),
                          min_frac)

    def lr(step):
        warm = base_lr * torch.clamp(_ratio(step, max(warmup_steps, 1)),
                                     max=1.0)
        out = torch.where(torch.as_tensor(step < warmup_steps), warm,
                          torch.as_tensor(cos(step - warmup_steps),
                                          dtype=torch.float32))
        return _out(out, step)
    return lr
