"""Typed observation/action spaces (port of ``repro.rl.envs.spaces``)."""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple, Union

import torch


@dataclasses.dataclass(frozen=True)
class Discrete:
    """Integers ``{0, ..., n-1}``; scalar per env instance."""

    n: int

    @property
    def shape(self) -> Tuple[int, ...]:
        return ()

    @property
    def dtype(self):
        return torch.int32

    def sample(self, gen: torch.Generator, batch: int,
               device="cpu") -> torch.Tensor:
        """``batch`` uniform actions, drawn on the CPU generator."""
        a = torch.randint(0, self.n, (batch,), generator=gen,
                          dtype=torch.int64)
        return a.to(device=device, dtype=torch.int32)


@dataclasses.dataclass(frozen=True)
class Box:
    """Float tensor with (possibly infinite) scalar bounds."""

    low: float
    high: float
    shape: Tuple[int, ...]

    @property
    def dtype(self):
        return torch.float32

    @property
    def bounded(self) -> bool:
        return math.isfinite(self.low) and math.isfinite(self.high)


Space = Union[Discrete, Box]


def head_dim(space: Space) -> int:
    """Policy-head width needed to parameterize a distribution over
    ``space``: ``n`` logits for Discrete, (mean, log_std) pairs for Box.
    """
    if isinstance(space, Discrete):
        return space.n
    if isinstance(space, Box):
        return 2 * math.prod(space.shape)
    raise TypeError(f"no policy head for space {space!r}")


def flat_dim(space: Space) -> int:
    """Number of scalars in one element of the space."""
    if isinstance(space, Discrete):
        return 1
    return int(math.prod(space.shape))
