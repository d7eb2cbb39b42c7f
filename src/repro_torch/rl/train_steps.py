"""The on-policy training iteration (port of
``repro.rl.train_steps.make_onpolicy_iteration``, single device).

One iteration collects a rollout with the quantized actors, prices
GAE with the learner's fp32 value head (the truncation bootstrap
included), and runs the PPO/A2C minibatch epochs with AdamW.  Its
randomness comes in through one seam, :class:`IterationDraws`: the
per-step sampling noise and the per-epoch minibatch permutations.  The
trainer draws them from a ``torch.Generator`` seeded from (seed,
global step); a parity test draws the reference's with JAX and passes
them in.  The iteration exposes its two phases, ``rollout_phase`` and
``learn_phase``, for a caller that times or profiles them apart.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.optim import adamw_update
from repro_torch.rl.actor_learner import collect, fleet_mask
from repro_torch.rl.ppo import batch_from_traj, minibatch_epochs
from repro_torch.rl.rollout import episode_returns


class IterationDraws(NamedTuple):
    noise: torch.Tensor   # [rollout_len, n_envs, ...] sampling draws
    perms: torch.Tensor   # [epochs, rollout_len * n_envs] permutations


def iteration_generator(seed: int, step: int,
                        device: torch.device) -> torch.Generator:
    """The draws' generator for global step ``step``: a pure function of
    (seed, step), as the reference's ``fold_in(key, step)``, so a
    resumed run draws the stream an uninterrupted one would."""
    x = ((int(seed) & 0xFFFFFFFF) << 32 | (int(step) & 0xFFFFFFFF))
    # splitmix64's finalizer, so nearby (seed, step) pairs seed far apart
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 31
    return torch.Generator(device=device).manual_seed(x & (2 ** 63 - 1))


def draw_iteration(gen: torch.Generator, dist, head_dim: int, *,
                   rollout_len: int, n_envs: int, epochs: int,
                   device: torch.device) -> IterationDraws:
    """One iteration's draws from ``gen`` (which lives on ``device``)."""
    noise = dist.noise(gen, dist.noise_shape((rollout_len, n_envs,
                                              head_dim)), device)
    n = rollout_len * n_envs
    perms = torch.stack([torch.randperm(n, generator=gen, device=device)
                         for _ in range(epochs)])
    return IterationDraws(noise, perms)


def make_onpolicy_iteration(env, apply_fn, a_policy, dist, pcfg, loss_fn,
                            sched, ocfg, *, rollout_len: int, n_envs: int,
                            n_slots: int = 1) -> Callable:
    """One collect + minibatch-update step (ppo / a2c):

        iteration(params, opt, est, obs, packed, draws, gmask, alive)
            -> (params, opt, est, obs, ret, n_ep)
    """
    def learner_apply(p, o):
        return apply_fn(p, o, None)

    def opt_step(p, s, g):
        p, s, _ = adamw_update(g, s, p, sched, ocfg)
        return p, s

    def rollout_phase(packed, draws, est, obs):
        return collect(packed, env, apply_fn, a_policy, draws.noise, est,
                       obs, rollout_len, dist)

    def learn_phase(params, opt, res, draws, gmask, alive):
        mask = fleet_mask(alive, n_envs // n_slots).to(res.last_value.device)
        with torch.no_grad():
            # the learner's fp32 value head prices the truncation
            # bootstrap, with the pre-update params
            batch = batch_from_traj(
                res.traj, res.last_value, pcfg, actor_mask=mask,
                value_fn=lambda o: learner_apply(params, o)[1])
        params, opt, _ = minibatch_epochs(
            draws.perms, params, opt, batch, learner_apply, pcfg, opt_step,
            loss_fn=loss_fn, grad_mask=gmask, dist=dist)
        return params, opt

    def iteration(params, opt, est, obs, packed, draws: IterationDraws,
                  gmask, alive):
        res = rollout_phase(packed, draws, est, obs)
        params, opt = learn_phase(params, opt, res, draws, gmask, alive)
        ret, n_ep = episode_returns(res.traj)
        return params, opt, res.final_env, res.final_obs, ret, n_ep

    iteration.rollout_phase = rollout_phase
    iteration.learn_phase = learn_phase
    return iteration
