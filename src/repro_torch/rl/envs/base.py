"""The typed environment protocol (port of ``repro.rl.envs.base``).

An :class:`Environment` is an :class:`EnvSpec` plus two functions over
a *batch* of environments living on one device:

    state, obs = env.reset(keys)                 # keys: int64 [B, 2]
    state, obs, reward, done, truncated, final_obs = env.step(state, act)

The reference's functions are unbatched and vmapped; here the batch
axis is written out, leading every state leaf.  The rest of the
contract is the reference's: ``done`` is termination, ``truncated`` a
pure time limit, the two exclusive; on a boundary the returned state is
a fresh episode and ``obs`` its first observation, while ``final_obs``
is the pre-reset observation of the transition itself.

Randomness lives in the state: each env carries a ``key`` (a 32-bit
stream id and a 32-bit counter, in int64) from which its resets draw
with :func:`uniform_ints` and :func:`uniform_floats`, so reset, step and
auto-reset stay functions of their inputs and run on the device without
a host round trip.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Tuple

import torch

from repro_torch.rl.envs.spaces import Box, Discrete, Space
from repro_torch.tree import is_namedtuple

Tensor = torch.Tensor

_M32 = 0xFFFFFFFF


def _mix32(x: Tensor) -> Tensor:
    """A 32-bit integer hash on int64 tensors (every product stays
    below 2^63)."""
    x = x & _M32
    x = ((x >> 16) ^ x) * 0x45D9F3B & _M32
    x = ((x >> 16) ^ x) * 0x45D9F3B & _M32
    return (x >> 16) ^ x


def _draw_bits(key: Tensor, draw: int) -> Tensor:
    """32 random bits: draw number ``draw`` of each env's current key."""
    return _mix32(key[:, 0] ^ _mix32(key[:, 1] * 8 + draw + 0x9E3779B9))


def uniform_ints(key: Tensor, draw: int, high: Tensor) -> Tensor:
    """Draw number ``draw`` of each env's current key: ints in
    ``[0, high)`` (``key`` is int64 [B, 2]: stream id, counter)."""
    return _draw_bits(key, draw) % high


def uniform_floats(key: Tensor, draw: int, low: float,
                   high: float) -> Tensor:
    """Draw number ``draw`` of each env's current key: fp32 uniform on
    ``[low, high]`` in 2^24 steps, from the top 24 of its bits."""
    u = (_draw_bits(key, draw) >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return low + u * (high - low)


def next_key(key: Tensor) -> Tensor:
    """The key after one reset: same stream, counter + 1."""
    return torch.stack([key[:, 0], (key[:, 1] + 1) & _M32], dim=1)


def split_key(key: Tensor) -> Tensor:
    """A new reset stream derived from ``key``: a fresh 32-bit id and a
    zero counter (the wrappers' ``jax.random.split``)."""
    ids = _mix32(key[:, 0] ^ 0x9E3779B9)
    return torch.stack([ids, torch.zeros_like(ids)], dim=1)


def auto_reset(done: Tensor, fresh: Any, nxt: Any) -> Any:
    """Select ``fresh`` state leaves where ``done`` ([B]), else ``nxt``."""
    if isinstance(fresh, torch.Tensor):
        mask = done.reshape(done.shape + (1,) * (fresh.ndim - done.ndim))
        return torch.where(mask, fresh, nxt)
    if is_namedtuple(fresh):
        return type(fresh)(*(auto_reset(done, a, b)
                             for a, b in zip(fresh, nxt, strict=True)))
    if isinstance(fresh, dict):
        return {k: auto_reset(done, fresh[k], nxt[k]) for k in fresh}
    if isinstance(fresh, (list, tuple)):
        return type(fresh)(auto_reset(done, a, b)
                           for a, b in zip(fresh, nxt, strict=True))
    raise TypeError(f"cannot auto-reset a state leaf of type {type(fresh)}")


def angle_wrap(x: Tensor) -> Tensor:
    """Wrap angles to [-pi, pi): the reference's ``((x + pi) % 2pi) -
    pi`` with its floored remainder written out (``fmod`` is exact, and
    a non-zero remainder of the other sign moves up by the divisor)."""
    two_pi = 2 * math.pi
    r = torch.fmod(x + math.pi, two_pi)
    r = torch.where((r != 0) & (r < 0), r + two_pi, r)
    return r - math.pi


@dataclasses.dataclass(frozen=True)
class EnvSpec:
    """Static interface description of an environment."""

    name: str
    observation_space: Space
    action_space: Space
    max_steps: int

    @property
    def obs_shape(self) -> Tuple[int, ...]:
        return self.observation_space.shape

    @property
    def n_actions(self) -> int:
        if not isinstance(self.action_space, Discrete):
            raise TypeError(
                f"{self.name}: action space is {self.action_space!r}, "
                "not Discrete — use spec.action_space directly")
        return self.action_space.n

    @property
    def continuous(self) -> bool:
        return isinstance(self.action_space, Box)


ResetFn = Callable[[Tensor], Tuple[Any, Tensor]]
StepFn = Callable[[Any, Tensor], Tuple[Any, Tensor, Tensor, Tensor, Tensor,
                                       Tensor]]


@dataclasses.dataclass(frozen=True)
class Environment:
    """A spec plus batched reset/step functions (see module docstring)."""

    spec: EnvSpec
    reset: ResetFn
    step: StepFn

    @property
    def observation_space(self) -> Space:
        return self.spec.observation_space

    @property
    def action_space(self) -> Space:
        return self.spec.action_space

    @property
    def obs_shape(self) -> Tuple[int, ...]:
        return self.spec.obs_shape

    def replace(self, **kw) -> "Environment":
        return dataclasses.replace(self, **kw)
