"""Action distributions (port of ``repro.rl.dists``): the layer that
makes rollout and PPO distribution-agnostic.

The policy network emits ``dparams`` per state (``spaces.head_dim``
wide); an :class:`ActionDist` turns them into samples, log-probs and
entropy, broadcasting over leading batch axes.

Sampling is split in two so that the draws are a seam: ``noise(gen,
shape)`` draws from an explicit ``torch.Generator`` and
``sample_with(noise, dparams)`` is a pure function of the draws.
JAX's threefry and torch's Philox cannot be matched from a seed, so a
parity test draws the reference's noise with JAX and passes it in.
``Categorical`` samples by the Gumbel-max trick, as
``jax.random.categorical`` does: ``argmax(gumbel + logits)``, the
Gumbel draw ``-log(-log(u))`` with ``u`` uniform in ``[tiny, 1)``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.rl.envs.spaces import Box, Discrete, Space

Tensor = torch.Tensor

LOG_STD_MIN = -5.0
LOG_STD_MAX = 2.0
_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)
_TINY = torch.finfo(torch.float32).tiny


@dataclasses.dataclass(frozen=True)
class Categorical:
    """Discrete actions from unnormalized logits ``[..., n]``."""

    def noise_shape(self, dparams_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        return tuple(dparams_shape)

    def noise(self, gen: torch.Generator, shape, device=None) -> Tensor:
        """Gumbel draws of ``shape`` (that of the logits)."""
        u = torch.rand(shape, generator=gen, dtype=torch.float32,
                       device=device)
        u = torch.clamp_min(u * (1.0 - _TINY) + _TINY, _TINY)
        return -torch.log(-torch.log(u))

    def sample_with(self, noise: Tensor, dparams: Tensor) -> Tensor:
        return torch.argmax(noise + dparams, dim=-1).to(torch.int32)

    def sample(self, gen: torch.Generator, dparams: Tensor) -> Tensor:
        return self.sample_with(
            self.noise(gen, dparams.shape, dparams.device), dparams)

    def log_prob(self, dparams: Tensor, action: Tensor) -> Tensor:
        logp = F.log_softmax(dparams, dim=-1)
        idx = action.to(torch.int64)[..., None]
        return torch.gather(logp, -1, idx)[..., 0]

    def entropy(self, dparams: Tensor) -> Tensor:
        logp = F.log_softmax(dparams, dim=-1)
        return -torch.sum(torch.exp(logp) * logp, dim=-1)


@dataclasses.dataclass(frozen=True)
class TanhGaussian:
    """tanh-squashed diagonal Gaussian rescaled into ``[low, high]``.

    ``dparams`` is ``[..., 2*d]``: pre-squash mean, then log-std (clipped).
    Log-probs carry the tanh + affine change of variables; ``entropy`` is
    the pre-squash Gaussian's, the reference's tractable surrogate.
    """

    low: float
    high: float

    @property
    def _mid(self) -> float:
        return 0.5 * (self.high + self.low)

    @property
    def _half(self) -> float:
        return 0.5 * (self.high - self.low)

    def _split(self, dparams: Tensor):
        mu, log_std = torch.chunk(dparams, 2, dim=-1)
        return mu, torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)

    def noise_shape(self, dparams_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        return tuple(dparams_shape[:-1]) + (dparams_shape[-1] // 2,)

    def noise(self, gen: torch.Generator, shape, device=None) -> Tensor:
        """Standard normal draws of ``shape`` (that of the mean)."""
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device)

    def sample_with(self, noise: Tensor, dparams: Tensor) -> Tensor:
        mu, log_std = self._split(dparams)
        u = mu + torch.exp(log_std) * noise
        return self._mid + self._half * torch.tanh(u)

    def sample(self, gen: torch.Generator, dparams: Tensor) -> Tensor:
        shape = self.noise_shape(dparams.shape)
        return self.sample_with(self.noise(gen, shape, dparams.device),
                                dparams)

    def log_prob(self, dparams: Tensor, action: Tensor) -> Tensor:
        mu, log_std = self._split(dparams)
        half = torch.full((), self._half, dtype=dparams.dtype,
                          device=dparams.device)
        a = (action - self._mid) / half
        a = torch.clamp(a, -1.0 + 1e-6, 1.0 - 1e-6)
        u = torch.atanh(a)
        std = torch.exp(log_std)
        logp_u = (-0.5 * torch.square((u - mu) / std) - log_std
                  - _HALF_LOG_2PI)
        # |d action / d u| = half * (1 - tanh(u)^2)
        jac = torch.log(self._half * (1.0 - torch.square(a)) + 1e-9)
        return torch.sum(logp_u - jac, dim=-1)

    def entropy(self, dparams: Tensor) -> Tensor:
        _, log_std = self._split(dparams)
        return torch.sum(log_std + 0.5 + _HALF_LOG_2PI, dim=-1)


ActionDist = Union[Categorical, TanhGaussian]


def distribution_for(space: Space) -> ActionDist:
    """The canonical distribution family for an action space."""
    if isinstance(space, Discrete):
        return Categorical()
    if isinstance(space, Box):
        if not space.bounded:
            raise ValueError("TanhGaussian needs finite Box bounds")
        return TanhGaussian(space.low, space.high)
    raise TypeError(f"no distribution for space {space!r}")
