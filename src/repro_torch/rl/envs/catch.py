"""Catch (bsuite-style): a batched torch pixel-grid env (port of
``repro.rl.envs.catch``).

A ball falls one row per step down a ROWS x COLS board; the paddle on
the bottom row moves left/stay/right.  Reward is +1 for catching the
ball, -1 for missing, 0 otherwise; the episode ends when the ball
reaches the bottom row.  Observations are a (ROWS, COLS, 1) binary
image (ball and paddle pixels set), sized for conv stems and the
frame-stack wrapper.

A reset draws the ball's column uniformly from each env's key (see
``repro_torch.rl.envs.base``); the reference draws with
``jax.random.randint`` and the two cannot be matched from a seed, so
parity tests inject the column into the state.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.rl.envs.base import (Environment, EnvSpec, auto_reset,
                                      next_key, uniform_ints)
from repro_torch.rl.envs.spaces import Box, Discrete

Tensor = torch.Tensor

ROWS = 10
COLS = 5
MAX_STEPS = ROWS          # ball reaches the bottom in ROWS - 1 steps

N_ACTIONS = 3             # left, stay, right


class EnvState(NamedTuple):
    ball_row: Tensor    # [B] int32
    ball_col: Tensor    # [B] int32
    paddle_col: Tensor  # [B] int32
    t: Tensor           # [B] int32
    key: Tensor         # [B, 2] int64 reset stream (id, counter)


def render(s: EnvState) -> Tensor:
    """[B, ROWS, COLS, 1] float32 frames of a batch of states."""
    b = s.ball_row.shape[0]
    rows = torch.arange(b, device=s.ball_row.device)
    img = torch.zeros((b, ROWS, COLS, 1), dtype=torch.float32,
                      device=s.ball_row.device)
    img[rows, s.ball_row.long(), s.ball_col.long(), 0] = 1.0
    img[rows, ROWS - 1, s.paddle_col.long(), 0] = 1.0
    return img


def _fresh(key: Tensor) -> EnvState:
    """A new episode per env: the ball's column from the env's key."""
    b = key.shape[0]
    zeros = torch.zeros(b, dtype=torch.int32, device=key.device)
    return EnvState(zeros, uniform_ints(key, 0, COLS).to(torch.int32),
                    torch.full((b,), COLS // 2, dtype=torch.int32,
                               device=key.device), zeros, next_key(key))


def reset(key: Tensor):
    s = _fresh(key)
    return s, render(s)


def step(s: EnvState, action: Tensor):
    """action in {0, 1, 2} -> paddle move {-1, 0, +1}."""
    paddle = torch.clamp(s.paddle_col + action.to(torch.int32) - 1, 0,
                         COLS - 1)
    ball_row = s.ball_row + 1
    t = s.t + 1

    at_bottom = ball_row >= ROWS - 1
    caught = at_bottom & (paddle == s.ball_col)
    reward = torch.where(at_bottom, torch.where(caught, 1.0, -1.0),
                         0.0).to(torch.float32)
    done = at_bottom
    truncated = (t >= MAX_STEPS) & ~at_bottom

    nxt = EnvState(ball_row, s.ball_col, paddle, t, s.key)
    out = auto_reset(done | truncated, _fresh(s.key), nxt)
    return out, render(out), reward, done, truncated, render(nxt)


def make() -> Environment:
    spec = EnvSpec("catch",
                   observation_space=Box(0.0, 1.0, (ROWS, COLS, 1)),
                   action_space=Discrete(N_ACTIONS),
                   max_steps=MAX_STEPS)
    return Environment(spec=spec, reset=reset, step=step)
