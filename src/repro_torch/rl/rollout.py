"""Vectorized environment start-up (port of ``repro.rl.rollout.init_envs``;
the collection loop arrives with the PPO training slice)."""
from __future__ import annotations

from typing import Union

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.rl.envs.base import Environment


def env_keys(seed: Union[int, torch.Generator], n_envs: int,
             device: torch.device) -> torch.Tensor:
    """Per-env reset keys (int64 [n_envs, 2]: a random 32-bit stream id
    and a zero counter), drawn on the CPU so a seed gives the same keys
    on every device."""
    gen = seed if isinstance(seed, torch.Generator) \
        else torch.Generator().manual_seed(int(seed))
    ids = torch.randint(0, 2 ** 32, (n_envs,), generator=gen,
                        dtype=torch.int64)
    return torch.stack([ids, torch.zeros_like(ids)], dim=1).to(device)


def init_envs(env: Environment, seed: Union[int, torch.Generator],
              n_envs: int, device: DeviceLike = None):
    """Reset ``n_envs`` environments on ``device`` (default: the card).
    Returns the batched (state, obs)."""
    dev = resolve_device(device)
    return env.reset(env_keys(seed, n_envs, dev))
