"""Generalized Advantage Estimation (port of ``repro.rl.gae``; the
reverse ``lax.scan`` is a reverse loop over T)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def gae(rewards: Tensor, values: Tensor, dones: Tensor, last_value: Tensor,
        gamma: float = 0.99, lam: float = 0.95,
        truncated: Optional[Tensor] = None,
        bootstrap_values: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """rewards/dones/values: [T, B]; last_value: [B].

    Returns (advantages [T, B], returns [T, B]).  ``dones[t]`` marks a
    termination at t: no bootstrapping across it.  ``truncated[t]``
    marks a pure time-limit cut: the advantage chain breaks, but the
    one-step target bootstraps from ``bootstrap_values[t]`` =
    V(final_obs[t]).  With ``truncated=None`` every done is a full cut.
    """
    term = dones.to(torch.float32)
    next_values = torch.cat([values[1:], last_value[None]], dim=0)
    if truncated is None:
        boundary = term
    else:
        if bootstrap_values is None:
            raise ValueError(
                "gae: truncated given without bootstrap_values — the "
                "truncation rows need V(final_obs) to bootstrap from")
        boundary = (dones | truncated).to(torch.float32)
        next_values = torch.where(truncated, bootstrap_values, next_values)
    nterm, nbound = 1.0 - term, 1.0 - boundary
    adv = torch.zeros_like(last_value)
    advs = [None] * rewards.shape[0]
    for t in range(rewards.shape[0] - 1, -1, -1):
        delta = rewards[t] + gamma * next_values[t] * nterm[t] - values[t]
        adv = delta + gamma * lam * nbound[t] * adv
        advs[t] = adv
    advs = torch.stack(advs)
    return advs, advs + values


def normalize(adv: Tensor, eps: float = 1e-8) -> Tensor:
    """Zero mean, unit population std (``jnp.std`` is ddof 0)."""
    return (adv - adv.mean()) / (adv.std(correction=0) + eps)
