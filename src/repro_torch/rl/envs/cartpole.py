"""CartPole-v1, batched in torch (port of ``repro.rl.envs.cartpole``:
Barto-Sutton dynamics, OpenAI Gym constants).

    env = make()
    state, obs = env.reset(keys)
    state, obs, reward, done, truncated, final_obs = env.step(state, act)

``done`` fires only when the pole or the cart leave their limits; the
500-step horizon reports ``truncated`` instead, and ``final_obs`` is
the pre-reset observation.  Both boundaries auto-reset.  A reset draws
the four state variables uniformly in [-0.05, 0.05] from each env's key
(``repro_torch.rl.envs.base``); the reference draws with
``jax.random.uniform`` and the two cannot be matched from a seed, so
parity tests inject states.

Every step is the reference's fp32 arithmetic in its order; divisions
by a constant divide by a 0-dim tensor (``div_scalar``'s rule), since
PyTorch's CUDA division by a Python number multiplies by its reciprocal.
``cos`` and ``sin`` are the library's, which may differ from XLA's in
the last bit.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from repro_torch.rl.envs.base import (Environment, EnvSpec, auto_reset,
                                      next_key, uniform_floats)
from repro_torch.rl.envs.spaces import Box, Discrete

Tensor = torch.Tensor

# Gym CartPole-v1 constants
GRAVITY = 9.8
CART_MASS = 1.0
POLE_MASS = 0.1
TOTAL_MASS = CART_MASS + POLE_MASS
POLE_HALF_LEN = 0.5
POLEMASS_LEN = POLE_MASS * POLE_HALF_LEN
FORCE_MAG = 10.0
DT = 0.02
THETA_LIMIT = 12 * 2 * math.pi / 360
X_LIMIT = 2.4
MAX_STEPS = 500

N_ACTIONS = 2
OBS_DIM = 4


class EnvState(NamedTuple):
    x: Tensor           # [B] fp32
    x_dot: Tensor
    theta: Tensor
    theta_dot: Tensor
    t: Tensor           # [B] int32 step counter
    key: Tensor         # [B, 2] int64 reset stream (id, counter)


def _obs(s: EnvState) -> Tensor:
    return torch.stack([s.x, s.x_dot, s.theta, s.theta_dot], dim=-1)


def _fresh(key: Tensor) -> EnvState:
    vals = [uniform_floats(key, i, -0.05, 0.05) for i in range(4)]
    t = torch.zeros(key.shape[0], dtype=torch.int32, device=key.device)
    return EnvState(*vals, t, next_key(key))


def reset(key: Tensor):
    s = _fresh(key)
    return s, _obs(s)


@functools.cache
def _total_mass(device: torch.device) -> Tensor:
    """The constant divisor as a 0-dim fp32 tensor on ``device``."""
    return torch.tensor(TOTAL_MASS, dtype=torch.float32, device=device)


def step(s: EnvState, action: Tensor):
    """action in {0, 1}, [B]."""
    total_mass = _total_mass(s.x.device)
    force = torch.where(action == 1, FORCE_MAG, -FORCE_MAG).to(torch.float32)
    cos, sin = torch.cos(s.theta), torch.sin(s.theta)
    tmp = (force + POLEMASS_LEN * (s.theta_dot * s.theta_dot) * sin) \
        / total_mass
    theta_acc = (GRAVITY * sin - cos * tmp) / (
        POLE_HALF_LEN * (4.0 / 3.0 - POLE_MASS * (cos * cos) / total_mass))
    x_acc = tmp - POLEMASS_LEN * theta_acc * cos / total_mass

    x = s.x + DT * s.x_dot
    x_dot = s.x_dot + DT * x_acc
    theta = s.theta + DT * s.theta_dot
    theta_dot = s.theta_dot + DT * theta_acc
    t = s.t + 1

    done = (torch.abs(x) > X_LIMIT) | (torch.abs(theta) > THETA_LIMIT)
    truncated = (t >= MAX_STEPS) & ~done
    reward = torch.ones(x.shape, dtype=torch.float32, device=x.device)

    nxt = EnvState(x, x_dot, theta, theta_dot, t, s.key)
    out = auto_reset(done | truncated, _fresh(s.key), nxt)
    return out, _obs(out), reward, done, truncated, _obs(nxt)


def make() -> Environment:
    spec = EnvSpec("cartpole",
                   observation_space=Box(-math.inf, math.inf, (OBS_DIM,)),
                   action_space=Discrete(N_ACTIONS),
                   max_steps=MAX_STEPS)
    return Environment(spec=spec, reset=reset, step=step)
