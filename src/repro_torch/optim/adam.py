"""AdamW, functional (port of ``repro.optim.adam``).

The state is a plain tree of tensors, ``{"mu", "nu", "count"}``, with
the reference's layout and dtypes (fp32 moments, an int32 0-dim count),
so it checkpoints into the reference's keys:

    state = adamw_init(params)
    new_params, state, stats = adamw_update(grads, state, params,
                                            schedule, cfg)

Every step is the reference's, in its order: non-finite gradients
zeroed, then the global-norm clip; the count incremented before the
schedule reads it; bias corrections ``1 - b ** count`` as fp32 powers of
the count; ``eps`` outside the square root.  Call it under
``torch.no_grad()``.  On a laid-out step it runs on this rank's blocks
of the params, the gradient and the moments (``mesh`` and ``split``:
see ``optim.clip``); only the norm and the non-finite flag span the
ranks.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.optim.clip import (clip_by_global_norm, global_norm,
                                    zero_nonfinite)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    max_grad_norm: Optional[float] = 1.0


def adamw_init(params):
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def adamw_update(grads, state, params, schedule: Callable,
                 cfg: AdamWConfig = AdamWConfig(), mesh=None, split=None):
    """One AdamW step.  Returns (new_params, new_state, stats)."""
    grads, nonfinite = zero_nonfinite(grads, mesh)
    if cfg.max_grad_norm is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.max_grad_norm, mesh,
                                           split)
    else:
        gnorm = global_norm(grads, mesh, split)

    count = state["count"] + 1
    lr = schedule(count)
    cnt = count.to(torch.float32)
    f32 = lambda v: torch.full((), v, dtype=torch.float32,  # noqa: E731
                               device=count.device)
    # 1 - b ** count: an fp32 power of the count, as the reference's
    corr1 = 1 - f32(cfg.b1) ** cnt
    corr2 = 1 - f32(cfg.b2) ** cnt
    b1, b2 = cfg.b1, cfg.b2

    def upd(g, mu, nu, p):
        g32 = g.to(torch.float32)
        mu = b1 * mu + (1 - b1) * g32
        nu = b2 * nu + (1 - b2) * torch.square(g32)
        mu_hat = mu / corr1
        nu_hat = nu / corr2
        step = mu_hat / (torch.sqrt(nu_hat) + cfg.eps)
        step = step + cfg.weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * step).to(p.dtype), mu, nu

    out = [upd(g, m, n, p) for g, m, n, p in zip(
        tree_leaves(grads), tree_leaves(state["mu"]),
        tree_leaves(state["nu"]), tree_leaves(params), strict=True)]
    new_params = tree_unflatten(params, [o[0] for o in out])
    new_state = {"mu": tree_unflatten(params, [o[1] for o in out]),
                 "nu": tree_unflatten(params, [o[2] for o in out]),
                 "count": count}
    stats = {"grad_norm": gnorm, "lr": lr,
             "nonfinite": nonfinite.to(torch.int32)}
    return new_params, new_state, stats


def optimizer_shardings(param_shardings):
    """Optimizer-state sharding tree matching ``adamw_init`` structure:
    the moments laid out as the params, the count replicated (``None``,
    resolved by the caller's mesh)."""
    return {
        "mu": param_shardings,
        "nu": param_shardings,
        "count": None,
    }
