"""Pendulum-v1, batched in torch (port of ``repro.rl.envs.pendulum``):
the continuous-action env of the registry.

    env = make()
    state, obs = env.reset(keys)
    state, obs, reward, done, truncated, final_obs = env.step(state, act)

The action is a Box torque in [-2, 2] of shape (1,); the observation is
[cos theta, sin theta, theta_dot]; the reward is the negative quadratic
cost.  Episodes end only at the 200-step time limit: ``done`` is never
set, the horizon reports ``truncated``, and ``final_obs`` is the
pre-reset observation through which value targets bootstrap.  A reset
draws theta in [-pi, pi] and theta_dot in [-1, 1] from each env's key.

Every step is the reference's fp32 arithmetic in its order; ``cos`` and
``sin`` are the library's, which may differ from XLA's in the last bit.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.rl.envs.base import (Environment, EnvSpec, angle_wrap,
                                      auto_reset, next_key, uniform_floats)
from repro_torch.rl.envs.spaces import Box

Tensor = torch.Tensor

DT = 0.05
GRAVITY = 10.0
MASS = 1.0
LENGTH = 1.0
MAX_SPEED = 8.0
MAX_TORQUE = 2.0
MAX_STEPS = 200

OBS_DIM = 3
ACT_DIM = 1


class EnvState(NamedTuple):
    theta: Tensor       # [B] fp32
    theta_dot: Tensor
    t: Tensor           # [B] int32 step counter
    key: Tensor         # [B, 2] int64 reset stream (id, counter)


def _obs(s: EnvState) -> Tensor:
    return torch.stack([torch.cos(s.theta), torch.sin(s.theta),
                        s.theta_dot], dim=-1)


def _fresh(key: Tensor) -> EnvState:
    theta = uniform_floats(key, 0, -math.pi, math.pi)
    theta_dot = uniform_floats(key, 1, -1.0, 1.0)
    t = torch.zeros(key.shape[0], dtype=torch.int32, device=key.device)
    return EnvState(theta, theta_dot, t, next_key(key))


def reset(key: Tensor):
    s = _fresh(key)
    return s, _obs(s)


def step(s: EnvState, action: Tensor):
    """action: fp32 torque, [B, 1]."""
    u = torch.clamp(action.reshape(s.theta.shape), -MAX_TORQUE, MAX_TORQUE)
    th = angle_wrap(s.theta)
    cost = th * th + 0.1 * (s.theta_dot * s.theta_dot) + 0.001 * (u * u)

    theta_dot = s.theta_dot + DT * (
        3 * GRAVITY / (2 * LENGTH) * torch.sin(s.theta)
        + 3.0 / (MASS * LENGTH ** 2) * u)
    theta_dot = torch.clamp(theta_dot, -MAX_SPEED, MAX_SPEED)
    theta = s.theta + DT * theta_dot
    t = s.t + 1

    done = torch.zeros(theta.shape, dtype=torch.bool, device=theta.device)
    truncated = t >= MAX_STEPS
    reward = (-cost).to(torch.float32)

    nxt = EnvState(theta, theta_dot, t, s.key)
    out = auto_reset(truncated, _fresh(s.key), nxt)
    return out, _obs(out), reward, done, truncated, _obs(nxt)


def make() -> Environment:
    spec = EnvSpec("pendulum",
                   observation_space=Box(-MAX_SPEED, MAX_SPEED, (OBS_DIM,)),
                   action_space=Box(-MAX_TORQUE, MAX_TORQUE, (ACT_DIM,)),
                   max_steps=MAX_STEPS)
    return Environment(spec=spec, reset=reset, step=step)
