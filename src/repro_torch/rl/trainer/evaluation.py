"""The greedy-evaluation head (port of
``repro.rl.trainer.evaluation``).

``greedy_eval`` runs a deterministic policy for ``n_steps`` over fresh
vectorized envs and returns the mean return of the episodes that
completed, as Python numbers.
"""
from __future__ import annotations

import torch

from repro_torch.rl.dists import ActionDist, Categorical, TanhGaussian
from repro_torch.rl.rollout import episode_returns_from, init_envs


def greedy_action(dist: ActionDist, dparams: torch.Tensor) -> torch.Tensor:
    """Deterministic action for a distribution head: the mode
    (Categorical: argmax; TanhGaussian: the squashed mean)."""
    if isinstance(dist, Categorical):
        return torch.argmax(dparams, dim=-1).to(torch.int32)
    if isinstance(dist, TanhGaussian):
        mu, _ = dist._split(dparams)
        return dist._mid + dist._half * torch.tanh(mu)
    raise TypeError(f"no greedy head for distribution {type(dist).__name__}")


def greedy_eval(env, act_fn, params, seed: int, n_envs: int, n_steps: int,
                device=None):
    """Run ``act_fn(params, obs) -> action`` greedily from envs reset
    from ``seed``; returns (mean completed-episode return, count)."""
    est, obs = init_envs(env, seed, n_envs, device)
    rews, bounds = [], []
    with torch.no_grad():
        for _ in range(n_steps):
            a = act_fn(params, obs)
            est, obs, r, d, tr, _ = env.step(est, a)
            rews.append(r)
            bounds.append(d | tr)
    ret, n_ep = episode_returns_from(torch.stack(rews), torch.stack(bounds))
    return float(ret), int(n_ep)
