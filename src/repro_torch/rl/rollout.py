"""Vectorized experience collection (port of ``repro.rl.rollout``).

``apply_fn(params, obs) -> (dparams, value)`` is the actor policy:
pass quantized params and an FxP8 QuantPolicy and this is the paper's
quantized actor.  The reference's ``lax.scan`` over time is a Python
loop over T here; each step runs the batched forward, samples from the
injected draws (``noise[t]``, see ``repro_torch.rl.dists``) and steps
every env at once on their device.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import shard_map
from repro_torch.rl.dists import ActionDist, distribution_for
from repro_torch.rl.envs.base import Environment

Tensor = torch.Tensor


class Trajectory(NamedTuple):
    obs: Tensor          # [T, B, ...]
    actions: Tensor      # [T, B] (Discrete) or [T, B, d] (Box)
    log_probs: Tensor    # [T, B]
    values: Tensor       # [T, B]
    rewards: Tensor      # [T, B]
    dones: Tensor        # [T, B] terminations (no bootstrap across)
    truncated: Tensor    # [T, B] pure timeouts (bootstrap through)
    next_obs: Tensor     # [T, B, ...] true successor obs (pre-reset)

    @property
    def boundary(self) -> Tensor:
        """Episode boundaries: what auto-reset and episode stats key off."""
        return self.dones | self.truncated


class RolloutResult(NamedTuple):
    traj: Trajectory
    last_value: Tensor   # [B]
    final_env: Any       # env state carry (resume collection)
    final_obs: Tensor


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
              n_envs: int, device: DeviceLike = None, mesh=None):
    """Reset ``n_envs`` environments on ``device`` (default: the card).
    Returns the batched (state, obs).  With ``mesh``, each slot resets
    its rows of the global env keys and the slots' states are gathered
    in slot order, so every rank holds the global state the unsharded
    reset gives."""
    dev = resolve_device(device)
    keys = env_keys(seed, n_envs, dev)
    if mesh is None:
        return env.reset(keys)
    return shard_map(env.reset, mesh, in_specs=(0,), out_specs=0)(keys)


def rollout(params, env: Environment, apply_fn: Callable, noise: Tensor,
            env_state, obs: Tensor, n_steps: int,
            dist: Optional[ActionDist] = None) -> RolloutResult:
    """Collect ``n_steps`` transitions from every env; ``noise`` holds
    the sampling draws, ``[n_steps, B, ...]`` (``dist.noise_shape`` of
    the head's output per step)."""
    if dist is None:
        dist = distribution_for(env.action_space)
    steps = []
    with torch.no_grad():
        for t in range(n_steps):
            dparams, value = apply_fn(params, obs)
            dparams = dparams.to(torch.float32)
            action = dist.sample_with(noise[t], dparams)
            logp = dist.log_prob(dparams, action)
            env_state, next_obs, reward, done, truncated, final_obs = \
                env.step(env_state, action)
            steps.append((obs, action, logp, value, reward, done,
                          truncated, final_obs))
            obs = next_obs
        last_value = apply_fn(params, obs)[1]
    traj = Trajectory(*(torch.stack(xs) for xs in zip(*steps, strict=True)))
    return RolloutResult(traj, last_value, env_state, obs)


def episode_returns(traj: Trajectory) -> Tuple[Tensor, Tensor]:
    """Mean undiscounted return and count of COMPLETED episodes (an
    episode completes at termination or truncation)."""
    return episode_returns_from(traj.rewards, traj.boundary)


def episode_returns_from(rewards: Tensor, boundary: Tensor
                         ) -> Tuple[Tensor, Tensor]:
    """``episode_returns`` on raw [T, B] tensors.  Each env's running
    return is summed in time order, as the reference's scan does."""
    acc = torch.zeros_like(rewards[0])
    total = torch.zeros_like(rewards[0])
    n = torch.zeros(rewards.shape[1], dtype=torch.int32,
                    device=rewards.device)
    for r, d in zip(rewards, boundary, strict=True):
        acc = acc + r
        total = total + torch.where(d, acc, torch.zeros_like(acc))
        n = n + d.to(torch.int32)
        acc = torch.where(d, torch.zeros_like(acc), acc)
    n_all = n.sum()
    return total.sum() / torch.clamp_min(n_all, 1).to(total.dtype), n_all
