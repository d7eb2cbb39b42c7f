"""PPO (clipped) and A2C (port of ``repro.rl.ppo``), with the paper's
two-stage freezing masks.

The reference's ``jax.value_and_grad`` is ``torch.autograd.grad`` on the
parameter leaves here: each minibatch runs its forward on leaf copies
that require grad, takes their gradients, and applies the optimizer
step under ``torch.no_grad()``.  The minibatch permutations are an
explicit input (``perms``, one row per epoch), the seam through which a
parity test injects the reference's draws.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import torch

from repro_torch.rl.dists import ActionDist, Categorical
from repro_torch.rl.gae import gae, normalize
from repro_torch.rl.rollout import Trajectory
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Tensor = torch.Tensor

_CATEGORICAL = Categorical()


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    gamma: float = 0.99
    lam: float = 0.95
    clip_eps: float = 0.2
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    epochs: int = 4
    minibatches: int = 4
    normalize_adv: bool = True


def _mean_fn(mask: Optional[Tensor]) -> Callable:
    if mask is None:
        return torch.mean
    return lambda x: (x * mask).sum() / torch.clamp_min(mask.sum(), 1)


def ppo_loss(params, apply_fn: Callable, batch: dict, cfg: PPOConfig,
             dist: Optional[ActionDist] = None) -> Tuple[Tensor, dict]:
    """batch: flat dict of [N, ...] tensors (obs, actions, log_probs,
    advantages, returns, and optionally mask)."""
    dist = dist or _CATEGORICAL
    dparams, values = apply_fn(params, batch["obs"])
    dparams = dparams.to(torch.float32)
    logp = dist.log_prob(dparams, batch["actions"])
    mean = _mean_fn(batch.get("mask"))

    ratio = torch.exp(logp - batch["log_probs"])
    adv = batch["advantages"]
    pg = -torch.minimum(
        ratio * adv,
        torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv)
    pg_loss = mean(pg)

    v_loss = 0.5 * mean(torch.square(values - batch["returns"]))
    entropy = mean(dist.entropy(dparams))

    loss = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * entropy
    stats = {"pg_loss": pg_loss, "v_loss": v_loss, "entropy": entropy,
             "approx_kl": mean(batch["log_probs"] - logp)}
    return loss, stats


def a2c_loss(params, apply_fn: Callable, batch: dict, cfg: PPOConfig,
             dist: Optional[ActionDist] = None) -> Tuple[Tensor, dict]:
    dist = dist or _CATEGORICAL
    dparams, values = apply_fn(params, batch["obs"])
    dparams = dparams.to(torch.float32)
    logp = dist.log_prob(dparams, batch["actions"])
    # the same liveness-mask contract as ppo_loss
    mean = _mean_fn(batch.get("mask"))

    pg_loss = -mean(logp * batch["advantages"])
    v_loss = 0.5 * mean(torch.square(values - batch["returns"]))
    entropy = mean(dist.entropy(dparams))
    loss = pg_loss + cfg.vf_coef * v_loss - cfg.ent_coef * entropy
    return loss, {"pg_loss": pg_loss, "v_loss": v_loss,
                  "entropy": entropy}


def batch_from_traj(traj: Trajectory, last_value: Tensor, cfg: PPOConfig,
                    actor_mask: Optional[Tensor] = None,
                    value_fn: Optional[Callable] = None) -> dict:
    """GAE over [T, B], then flatten to [T*B, ...].

    ``actor_mask`` [B] (1 = actor delivered, 0 = straggler): masked
    actors contribute zero loss and are left out of the advantage
    statistics.  ``value_fn`` (obs [N, ...] -> values [N]) prices the
    truncation bootstrap over ``traj.next_obs``; without it truncations
    are cut like terminations.
    """
    T, B = traj.rewards.shape
    if value_fn is not None:
        nobs = traj.next_obs.reshape((T * B,) + traj.next_obs.shape[2:])
        boot = value_fn(nobs).reshape(T, B)
        advs, rets = gae(traj.rewards, traj.values, traj.dones,
                         last_value, cfg.gamma, cfg.lam,
                         truncated=traj.truncated, bootstrap_values=boot)
    else:
        advs, rets = gae(traj.rewards, traj.values, traj.boundary,
                         last_value, cfg.gamma, cfg.lam)
    if cfg.normalize_adv:
        if actor_mask is not None:
            w = torch.broadcast_to(actor_mask[None].to(torch.float32),
                                   advs.shape)
            n = torch.clamp_min(w.sum(), 1.0)
            mu = (advs * w).sum() / n
            std = torch.sqrt(torch.clamp_min(
                (torch.square(advs - mu) * w).sum() / n, 0.0))
            advs = (advs - mu) / (std + 1e-8)
        else:
            advs = normalize(advs)
    flat = lambda x: x.reshape((T * B,) + x.shape[2:])  # noqa: E731
    batch = {"obs": flat(traj.obs), "actions": flat(traj.actions),
             "log_probs": flat(traj.log_probs),
             "advantages": flat(advs), "returns": flat(rets)}
    if actor_mask is not None:
        batch["mask"] = flat(torch.broadcast_to(
            actor_mask[None].to(torch.float32), (T, B)))
    return batch


# ---------------------------------------------------------------------------
# two-stage freezing
# ---------------------------------------------------------------------------

def stage_mask(params, stage: str):
    """1/0 tree: which leaves train in this stage.

    stage "action":  stem + action head + value head (sub-goal frozen)
    stage "subgoal": sub-goal module only
    stage "all":     everything (non-hierarchical nets)
    """
    if stage == "all":
        return tree_map(lambda _: 1.0, params)
    return {name: tree_map(
        lambda _, on=((name == "subgoal") == (stage == "subgoal")):
        1.0 if on else 0.0, sub) for name, sub in params.items()}


def apply_stage_mask(grads, mask):
    return tree_unflatten(grads, [g * m for g, m in zip(
        tree_leaves(grads), tree_leaves(mask), strict=True)])


def value_and_grad(loss_fn: Callable, params, *args):
    """``((loss, aux), grads)`` of ``loss_fn(params, *args)`` with
    respect to every leaf of ``params``, grads in ``params``' tree."""
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, aux = loss_fn(tree_unflatten(params, leaves), *args)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads, strict=True)]
    detach = lambda x: x.detach()  # noqa: E731
    return (loss.detach(), tree_map(detach, aux)), \
        tree_unflatten(params, grads)


def minibatch_epochs(perms: Tensor, params, opt_state, batch: dict,
                     apply_fn: Callable, cfg: PPOConfig,
                     optimizer_step: Callable, loss_fn=ppo_loss,
                     grad_mask=None, dist: Optional[ActionDist] = None):
    """The PPO epochs x minibatches loop.  ``perms`` [epochs, N] holds
    one permutation of the batch per epoch."""
    n = batch["obs"].shape[0]
    if n % cfg.minibatches != 0:
        raise ValueError(
            f"minibatch_epochs: batch of {n} samples (rollout T*B) does "
            f"not divide into cfg.minibatches={cfg.minibatches} — the "
            f"tail {n % cfg.minibatches} samples would be silently "
            "dropped every epoch. Pick n_envs*rollout_len divisible by "
            "the minibatch count, or adjust PPOConfig.minibatches.")
    if tuple(perms.shape) != (cfg.epochs, n):
        raise ValueError(f"perms has shape {tuple(perms.shape)}, want "
                         f"({cfg.epochs}, {n})")
    mb = n // cfg.minibatches
    stats = None
    # the 4-argument loss_fn contract holds when no dist is given
    extra = () if dist is None else (dist,)
    for e in range(cfg.epochs):
        for i in range(cfg.minibatches):
            idx = perms[e, i * mb:(i + 1) * mb]
            mbatch = {k: v[idx] for k, v in batch.items()}
            (_, stats), grads = value_and_grad(
                loss_fn, params, apply_fn, mbatch, cfg, *extra)
            if grad_mask is not None:
                grads = apply_stage_mask(grads, grad_mask)
            with torch.no_grad():
                params, opt_state = optimizer_step(params, opt_state, grads)
    return params, opt_state, stats
