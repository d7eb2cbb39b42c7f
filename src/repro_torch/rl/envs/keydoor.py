"""KeyDoor: a batched torch gridworld with image observations (port of
``repro.rl.envs.keydoor``).

The agent must first reach the KEY (sub-goal), then the DOOR.  Frames
are 32x32x3 images (8x8 cells, 4px each): agent=R, key=G (until picked),
door=B — the paper's 32x32x3 input size (Table V).

Rewards: +0.5 key pickup, +1.0 door-with-key (terminal), -0.01/step.

A reset places agent, key and door on three distinct cells, uniform
over ordered triples, drawn from each env's key (see
``repro_torch.rl.envs.base``); the reference draws with
``jax.random.choice`` and the two cannot be matched from a seed, so
parity tests inject the cell positions into the state.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.rl.envs.base import (Environment, EnvSpec, auto_reset,
                                      next_key, uniform_ints)
from repro_torch.rl.envs.spaces import Box, Discrete

Tensor = torch.Tensor

GRID = 8
CELL_PX = 4
IMG = GRID * CELL_PX            # 32
MAX_STEPS = 64
N_ACTIONS = 4                   # up, down, left, right


class EnvState(NamedTuple):
    agent: Tensor       # [B, 2] int32
    key_pos: Tensor     # [B, 2] int32
    door: Tensor        # [B, 2] int32
    has_key: Tensor     # [B] bool
    t: Tensor           # [B] int32
    key: Tensor         # [B, 2] int64 reset stream (id, counter)


def render(s: EnvState) -> Tensor:
    """[B, 32, 32, 3] float32 frames of a batch of states."""
    b = s.agent.shape[0]
    rows = torch.arange(b, device=s.agent.device)
    img = torch.zeros((b, GRID, GRID, 3), dtype=torch.float32,
                      device=s.agent.device)
    img[rows, s.agent[:, 0], s.agent[:, 1], 0] = 1.0
    img[rows, s.key_pos[:, 0], s.key_pos[:, 1], 1] = \
        (~s.has_key).to(torch.float32)
    img[rows, s.door[:, 0], s.door[:, 1], 2] = 1.0
    return img.repeat_interleave(CELL_PX, 1).repeat_interleave(CELL_PX, 2)


def _fresh(key: Tensor) -> EnvState:
    """A new episode per env: three distinct cells from the env's key."""
    c0 = uniform_ints(key, 0, GRID * GRID)
    c1 = uniform_ints(key, 1, GRID * GRID - 1)
    c1 = c1 + (c1 >= c0).to(c1.dtype)
    lo, hi = torch.minimum(c0, c1), torch.maximum(c0, c1)
    c2 = uniform_ints(key, 2, GRID * GRID - 2)
    c2 = c2 + (c2 >= lo).to(c2.dtype)
    c2 = c2 + (c2 >= hi).to(c2.dtype)
    cells = torch.stack([c0, c1, c2], dim=1)
    pos = torch.stack([cells // GRID, cells % GRID], dim=-1).to(torch.int32)
    b = key.shape[0]
    return EnvState(pos[:, 0], pos[:, 1], pos[:, 2],
                    torch.zeros(b, dtype=torch.bool, device=key.device),
                    torch.zeros(b, dtype=torch.int32, device=key.device),
                    next_key(key))


def reset(key: Tensor):
    s = _fresh(key)
    return s, render(s)


@functools.cache
def _moves(device: torch.device) -> Tensor:
    return torch.tensor([[-1, 0], [1, 0], [0, -1], [0, 1]],
                        dtype=torch.int32, device=device)


def step(s: EnvState, action: Tensor):
    agent = torch.clamp(s.agent + _moves(s.agent.device)[action.long()], 0,
                        GRID - 1)
    at_key = (agent == s.key_pos).all(dim=-1)
    picked = at_key & ~s.has_key
    has_key = s.has_key | at_key
    at_door = (agent == s.door).all(dim=-1)
    opened = at_door & has_key
    t = s.t + 1

    reward = (-0.01 + 0.5 * picked.to(torch.float32)
              + 1.0 * opened.to(torch.float32))
    done = opened
    truncated = (t >= MAX_STEPS) & ~opened

    nxt = EnvState(agent, s.key_pos, s.door, has_key, t, s.key)
    out = auto_reset(done | truncated, _fresh(s.key), nxt)
    return out, render(out), reward, done, truncated, render(nxt)


def subgoal_reached(s: EnvState) -> Tensor:
    """Oracle sub-goal indicator (key picked), [B]: HRL diagnostics."""
    return s.has_key


def make() -> Environment:
    spec = EnvSpec("keydoor",
                   observation_space=Box(0.0, 1.0, (IMG, IMG, 3)),
                   action_space=Discrete(N_ACTIONS),
                   max_steps=MAX_STEPS)
    return Environment(spec=spec, reset=reset, step=step)
