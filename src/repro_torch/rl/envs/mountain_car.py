"""MountainCar-v0, batched in torch (port of
``repro.rl.envs.mountain_car``: Moore's car on a hill, Gym constants).

The observation is [position, velocity]; 3 discrete actions push left,
coast or push right; the reward is -1 a step.  ``done`` fires at the
flag (position >= 0.5), the 200-step horizon reports ``truncated``, and
both auto-reset.  A reset draws the position in [-0.6, -0.4] from each
env's key, at rest.  Every step is the reference's fp32 arithmetic in
its order; ``cos`` is the library's.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.rl.envs.base import (Environment, EnvSpec, auto_reset,
                                      next_key, uniform_floats)
from repro_torch.rl.envs.spaces import Box, Discrete

Tensor = torch.Tensor

MIN_POS = -1.2
MAX_POS = 0.6
MAX_SPEED = 0.07
GOAL_POS = 0.5
FORCE = 0.001
GRAVITY = 0.0025
MAX_STEPS = 200

N_ACTIONS = 3
OBS_DIM = 2


class EnvState(NamedTuple):
    position: Tensor    # [B] fp32
    velocity: Tensor
    t: Tensor           # [B] int32 step counter
    key: Tensor         # [B, 2] int64 reset stream (id, counter)


def _obs(s: EnvState) -> Tensor:
    return torch.stack([s.position, s.velocity], dim=-1)


def _fresh(key: Tensor) -> EnvState:
    pos = uniform_floats(key, 0, -0.6, -0.4)
    return EnvState(pos, torch.zeros_like(pos),
                    torch.zeros(key.shape[0], dtype=torch.int32,
                                device=key.device), next_key(key))


def reset(key: Tensor):
    s = _fresh(key)
    return s, _obs(s)


def step(s: EnvState, action: Tensor):
    """action in {0, 1, 2} -> force {-1, 0, +1} * FORCE, [B]."""
    velocity = (s.velocity + (action.to(torch.float32) - 1.0) * FORCE
                - torch.cos(3 * s.position) * GRAVITY)
    velocity = torch.clamp(velocity, -MAX_SPEED, MAX_SPEED)
    position = torch.clamp(s.position + velocity, MIN_POS, MAX_POS)
    # inelastic left wall
    velocity = torch.where((position <= MIN_POS) & (velocity < 0),
                           torch.zeros_like(velocity), velocity)
    t = s.t + 1

    done = position >= GOAL_POS
    truncated = (t >= MAX_STEPS) & ~done
    reward = torch.full(position.shape, -1.0, dtype=torch.float32,
                        device=position.device)

    nxt = EnvState(position, velocity, t, s.key)
    out = auto_reset(done | truncated, _fresh(s.key), nxt)
    return out, _obs(out), reward, done, truncated, _obs(nxt)


def make() -> Environment:
    spec = EnvSpec("mountain_car",
                   observation_space=Box(MIN_POS, MAX_POS, (OBS_DIM,)),
                   action_space=Discrete(N_ACTIONS),
                   max_steps=MAX_STEPS)
    return Environment(spec=spec, reset=reset, step=step)
