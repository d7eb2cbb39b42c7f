"""Parameter initializers (port of ``repro.nn.module``).

Parameters are plain dicts of tensors, in the reference's layouts.  An
initializer draws from an explicit CPU ``torch.Generator`` and then
moves the tensor to ``device``, so one seed gives the same weights on
the CPU and on the card.  (torch and jax draw different numbers from
the same seed: tests that need identical weights in both packages carry
them across with ``repro_torch.checkpoint.from_numpy_tree``.)
"""
from __future__ import annotations

import math
from typing import Callable, Sequence

import torch


def _fan_in(shape: Sequence[int]) -> int:
    return shape[-2] if len(shape) >= 2 else shape[-1]


def lecun_init() -> Callable:
    def f(gen: torch.Generator, shape, dtype=torch.float32, device="cpu"):
        std = math.sqrt(1.0 / _fan_in(shape))
        x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32)
        return (x * std).to(dtype=dtype, device=device)
    return f


def he_init() -> Callable:
    def f(gen: torch.Generator, shape, dtype=torch.float32, device="cpu"):
        std = math.sqrt(2.0 / _fan_in(shape))
        x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32)
        return (x * std).to(dtype=dtype, device=device)
    return f


def normal_init(stddev: float = 0.02) -> Callable:
    def f(gen: torch.Generator, shape, dtype=torch.float32, device="cpu"):
        x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32)
        return (x * stddev).to(dtype=dtype, device=device)
    return f


def zeros_init() -> Callable:
    def f(gen: torch.Generator, shape, dtype=torch.float32, device="cpu"):
        del gen
        return torch.zeros(tuple(shape), dtype=dtype, device=device)
    return f


def ones_init() -> Callable:
    def f(gen: torch.Generator, shape, dtype=torch.float32, device="cpu"):
        del gen
        return torch.ones(tuple(shape), dtype=dtype, device=device)
    return f


def uniform(gen: torch.Generator, shape, lo: float, hi: float,
            device="cpu") -> torch.Tensor:
    """fp32 draws uniform in [lo, hi) from ``gen``, placed on ``device``
    (the reference draws its SSD decays and RG-LRU rates so)."""
    x = torch.rand(tuple(shape), generator=gen, dtype=torch.float32)
    return (x * (hi - lo) + lo).to(device)
