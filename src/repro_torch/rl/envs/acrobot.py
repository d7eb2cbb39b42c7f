"""Acrobot-v1, batched in torch (port of ``repro.rl.envs.acrobot``:
Sutton's two-link underactuated swing-up, Gym constants, RK4).

The observation is [cos t1, sin t1, cos t2, sin t2, dt1, dt2]; 3
discrete actions apply torque {-1, 0, +1} at the joint between the
links.  The reward is -1 a step until the tip swings above the bar
(-cos t1 - cos(t1 + t2) > 1), which terminates; the 500-step horizon
reports ``truncated``; both auto-reset.  A reset draws the four state
variables in [-0.1, 0.1] from each env's key.

The reference integrates a stacked [4] vector; here each of its four
components is a [B] tensor, and every expression is the reference's,
term for term in its order, so the fp32 arithmetic is the same.  ``cos``
and ``sin`` are the library's.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from repro_torch.rl.envs.base import (Environment, EnvSpec, angle_wrap,
                                      auto_reset, next_key, uniform_floats)
from repro_torch.rl.envs.spaces import Box, Discrete

Tensor = torch.Tensor

DT = 0.2
LINK_LENGTH_1 = 1.0
LINK_MASS_1 = 1.0
LINK_MASS_2 = 1.0
LINK_COM_1 = 0.5
LINK_COM_2 = 0.5
LINK_MOI = 1.0
GRAVITY = 9.8
MAX_VEL_1 = 4 * math.pi
MAX_VEL_2 = 9 * math.pi
MAX_STEPS = 500

N_ACTIONS = 3           # torque -1, 0, +1
OBS_DIM = 6

Y = Tuple[Tensor, Tensor, Tensor, Tensor]


class EnvState(NamedTuple):
    theta1: Tensor      # [B] fp32
    theta2: Tensor
    dtheta1: Tensor
    dtheta2: Tensor
    t: Tensor           # [B] int32 step counter
    key: Tensor         # [B, 2] int64 reset stream (id, counter)


def _obs(s: EnvState) -> Tensor:
    return torch.stack([torch.cos(s.theta1), torch.sin(s.theta1),
                        torch.cos(s.theta2), torch.sin(s.theta2),
                        s.dtheta1, s.dtheta2], dim=-1)


def _fresh(key: Tensor) -> EnvState:
    vals = [uniform_floats(key, i, -0.1, 0.1) for i in range(4)]
    t = torch.zeros(key.shape[0], dtype=torch.int32, device=key.device)
    return EnvState(*vals, t, next_key(key))


def reset(key: Tensor):
    s = _fresh(key)
    return s, _obs(s)


def _dsdt(y: Y, torque: Tensor) -> Y:
    """Equations of motion (Sutton & Barto / Gym ``_dsdt``)."""
    m1, m2 = LINK_MASS_1, LINK_MASS_2
    l1 = LINK_LENGTH_1
    lc1, lc2 = LINK_COM_1, LINK_COM_2
    i1 = i2 = LINK_MOI
    g = GRAVITY
    theta1, theta2, dtheta1, dtheta2 = y

    d1 = (m1 * lc1 ** 2 + m2 *
          (l1 ** 2 + lc2 ** 2 + 2 * l1 * lc2 * torch.cos(theta2)) + i1
          + i2)
    d2 = m2 * (lc2 ** 2 + l1 * lc2 * torch.cos(theta2)) + i2
    phi2 = m2 * lc2 * g * torch.cos(theta1 + theta2 - math.pi / 2.0)
    phi1 = (-m2 * l1 * lc2 * (dtheta2 * dtheta2) * torch.sin(theta2)
            - 2 * m2 * l1 * lc2 * dtheta2 * dtheta1 * torch.sin(theta2)
            + (m1 * lc1 + m2 * l1) * g * torch.cos(theta1 - math.pi / 2.0)
            + phi2)
    ddtheta2 = ((torque + d2 / d1 * phi1
                 - m2 * l1 * lc2 * (dtheta1 * dtheta1) * torch.sin(theta2)
                 - phi2)
                / (m2 * lc2 ** 2 + i2 - (d2 * d2) / d1))
    ddtheta1 = -(d2 * ddtheta2 + phi1) / d1
    return dtheta1, dtheta2, ddtheta1, ddtheta2


def _rk4(y0: Y, torque: Tensor, dt: float) -> Y:
    def axpy(a, k):
        return tuple(y + a * ki for y, ki in zip(y0, k, strict=True))

    k1 = _dsdt(y0, torque)
    k2 = _dsdt(axpy(dt / 2, k1), torque)
    k3 = _dsdt(axpy(dt / 2, k2), torque)
    k4 = _dsdt(axpy(dt, k3), torque)
    return tuple(y + dt / 6.0 * (a + 2 * b + 2 * c + d)
                 for y, a, b, c, d in zip(y0, k1, k2, k3, k4, strict=True))


def step(s: EnvState, action: Tensor):
    """action in {0, 1, 2} -> torque {-1, 0, +1}, [B]."""
    torque = action.to(torch.float32) - 1.0
    y = _rk4((s.theta1, s.theta2, s.dtheta1, s.dtheta2), torque, DT)

    theta1 = angle_wrap(y[0])
    theta2 = angle_wrap(y[1])
    dtheta1 = torch.clamp(y[2], -MAX_VEL_1, MAX_VEL_1)
    dtheta2 = torch.clamp(y[3], -MAX_VEL_2, MAX_VEL_2)
    t = s.t + 1

    solved = -torch.cos(theta1) - torch.cos(theta2 + theta1) > 1.0
    done = solved
    truncated = (t >= MAX_STEPS) & ~solved
    reward = torch.where(solved, 0.0, -1.0).to(torch.float32)

    nxt = EnvState(theta1, theta2, dtheta1, dtheta2, t, s.key)
    out = auto_reset(done | truncated, _fresh(s.key), nxt)
    return out, _obs(out), reward, done, truncated, _obs(nxt)


def make() -> Environment:
    spec = EnvSpec("acrobot",
                   observation_space=Box(-float(MAX_VEL_2), float(MAX_VEL_2),
                                         (OBS_DIM,)),
                   action_space=Discrete(N_ACTIONS),
                   max_steps=MAX_STEPS)
    return Environment(spec=spec, reset=reset, step=step)
