"""Learning-rate schedules (port of ``repro.optim.schedule``): functions
of the step counter returning a 0-dim fp32 tensor on its device."""
from __future__ import annotations

import math
from typing import Callable

import torch

Schedule = Callable


def _f32(step) -> torch.Tensor:
    step = torch.as_tensor(step)
    return step.to(torch.float32)


def constant(lr: float) -> Schedule:
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def linear_warmup(lr: float, warmup_steps: int) -> Schedule:
    def f(step):
        s = _f32(step)
        frac = torch.clamp_max(s / s.new_full((), max(warmup_steps, 1)),
                               1.0)
        return s.new_full((), lr) * frac
    return f


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1) -> Schedule:
    """Linear warmup then cosine decay to ``final_frac * lr``."""
    def f(step):
        s = _f32(step)
        warm = s / s.new_full((), max(warmup_steps, 1))
        prog = (s - warmup_steps) / s.new_full(
            (), max(total_steps - warmup_steps, 1))
        prog = torch.clamp(prog, 0.0, 1.0)
        cos = final_frac + (1 - final_frac) * 0.5 * (
            1 + torch.cos(math.pi * prog))
        return lr * torch.where(s < warmup_steps, warm, cos)
    return f


def inverse_sqrt(lr: float, warmup_steps: int) -> Schedule:
    def f(step):
        s = torch.clamp_min(_f32(step), 1.0)
        w = max(warmup_steps, 1)
        warm = torch.clamp_max(s / s.new_full((), w), 1.0)
        return lr * warm * torch.sqrt(
            s.new_full((), w) / torch.clamp_min(s, warmup_steps))
    return f
