"""Off-policy value-based RL on the quantized compute fabric (port of
``repro.rl.value``): DQN (Double-DQN), QR-DQN and DDPG with twin
critics, target-policy smoothing and TQC truncation.

Transitions carry a *discount* instead of a done flag: ``discount =
gamma^K * (1 - terminated)`` folds the n-step horizon, truncation
(bootstrap: the discount stays ``gamma^K``) and termination (0) into
one number, so every target is ``r + discount * Q(next_obs)``.

Every loss has the reference's two faces: the ``*_td`` variant returns
``(loss, |td|)``, ``|td|`` the per-sample absolute TD error that PER
writes back, and the scalar face returns the loss alone.  All of them
weigh each sample by the batch's ``"weight"`` column (PER importance
weights, or the 0/1 underfill mask).  The losses are differentiated by
autograd (``repro_torch.rl.ppo.value_and_grad``); their random draws —
the ε-greedy action and uniform, the exploration and target-smoothing
normals — are inputs, the seam through which a parity test passes the
reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.fxp import div_scalar
from repro_torch.tree import tree_leaves, tree_unflatten

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DQNConfig:
    gamma: float = 0.99
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 2_000
    target_update_every: int = 100   # hard-update period (legacy loops)
    target_tau: float = 0.01         # polyak rate (the training iteration)
    batch_size: int = 64
    double: bool = True              # Double-DQN action selection
    n_step: int = 1
    learn_start: int = 256           # min replay size before updates


@dataclasses.dataclass(frozen=True)
class QRDQNConfig(DQNConfig):
    n_quantiles: int = 32
    kappa: float = 1.0               # quantile-Huber threshold


@dataclasses.dataclass(frozen=True)
class DDPGConfig:
    """TD3-flavoured DDPG: twin critics + target-policy smoothing.
    ``critic_quantiles > 1`` switches the critics to quantile heads and
    the backup to TQC's: both target critics' quantiles pooled, sorted,
    the top ``tqc_drop`` dropped."""

    low: float = -1.0                # action bounds (Box envs)
    high: float = 1.0
    gamma: float = 0.99
    tau: float = 0.005               # polyak rate for both targets
    batch_size: int = 128
    n_step: int = 1
    learn_start: int = 256
    explore_noise: float = 0.1       # behaviour noise, x half-range
    policy_noise: float = 0.2        # target smoothing noise, x half-range
    noise_clip: float = 0.5          # smoothing clip, x half-range
    critic_quantiles: int = 1        # >1: TQC quantile critics
    tqc_drop: int = 0                # pooled target quantiles dropped
    kappa: float = 1.0               # quantile-Huber threshold (TQC)

    def __post_init__(self):
        if self.critic_quantiles < 1:
            raise ValueError(f"critic_quantiles must be >= 1, got "
                             f"{self.critic_quantiles}")
        if self.tqc_drop < 0 or self.tqc_drop >= 2 * self.critic_quantiles:
            raise ValueError(
                f"tqc_drop={self.tqc_drop} must leave at least one of "
                f"the {2 * self.critic_quantiles} pooled target "
                "quantiles")
        if self.tqc_drop > 0 and self.critic_quantiles == 1:
            raise ValueError(
                "tqc_drop prunes pooled target *quantiles* — scalar "
                "twin critics (critic_quantiles=1) keep the TD3 "
                "min-backup; set critic_quantiles > 1 (e.g. 25) to "
                "enable TQC truncation")

    @property
    def half_range(self) -> float:
        return 0.5 * (self.high - self.low)


# ---------------------------------------------------------------------------
# n-step targets from a rollout chunk (truncation-aware)
# ---------------------------------------------------------------------------

def _shift(x: Tensor, k: int, fill) -> Tensor:
    pad = torch.full((k,) + tuple(x.shape[1:]), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x[k:], pad], dim=0)


def nstep_targets(rewards: Tensor, dones: Tensor, truncated: Tensor,
                  next_obs: Tensor, gamma: float, n: int):
    """Fold a fresh [T, B] chunk into n-step transitions: for each start
    row t the window runs ``K = min(n, steps to the first episode
    boundary, T - t)`` steps.  Returns ``returns`` [T, B] (sum_{k<K}
    gamma^k r_{t+k}), ``next_obs`` [T, B, ...] (the window's true
    successor, pre-reset at boundaries) and ``discount`` [T, B]
    (gamma^K * (1 - terminated at the end))."""
    if n < 1:
        raise ValueError(f"nstep_targets needs n >= 1, got {n}")
    T = rewards.shape[0]
    f32 = torch.float32
    boundary = dones | truncated
    rew = rewards.to(f32)

    returns = rew
    nxt = next_obs
    term_end = dones
    gpow = torch.full(rewards.shape, gamma, dtype=f32,
                      device=rewards.device)
    open_ = ~boundary

    for k in range(1, min(n, T)):
        in_range = _shift(torch.ones_like(boundary), k, False)
        ext = open_ & in_range
        extm = ext.reshape(ext.shape + (1,) * (nxt.ndim - ext.ndim))
        returns = returns + torch.where(
            ext, gamma ** k * _shift(rew, k, 0.0),
            torch.zeros((), dtype=f32, device=rew.device))
        nxt = torch.where(extm, _shift(next_obs, k, 0.0), nxt)
        term_end = torch.where(ext, _shift(dones, k, False), term_end)
        gpow = torch.where(ext, torch.full((), gamma ** (k + 1), dtype=f32,
                                           device=rew.device), gpow)
        open_ = ext & ~_shift(boundary, k, True)

    discount = gpow * (1.0 - term_end.to(f32))
    return returns, nxt, discount


# ---------------------------------------------------------------------------
# behaviour policy pieces
# ---------------------------------------------------------------------------

def fma32(a, b, c) -> float:
    """``a * b + c`` on fp32 values rounded once to fp32, as the
    reference's compiled iteration fuses it (the double product of two
    fp32 values is exact, and so is its sum with ``c`` here)."""
    f32 = np.float32
    return float(f32(float(f32(a)) * float(f32(b)) + float(f32(c))))


def epsilon(step: int, cfg: DQNConfig) -> float:
    """The ε-greedy rate at rollout step ``step``, as the reference's
    compiled iteration computes it in fp32 (the returned Python float is
    an fp32 value)."""
    f32 = np.float32
    frac = np.clip(f32(step) / f32(cfg.eps_decay_steps), f32(0), f32(1))
    return fma32(frac, cfg.eps_end - cfg.eps_start, cfg.eps_start)


def egreedy(qvals: Tensor, eps: float, rand_actions: Tensor,
            uniforms: Tensor) -> Tensor:
    """ε-greedy over ``qvals`` [B, A]: the draw ``rand_actions`` [B]
    (uniform in [0, A)) where ``uniforms`` [B] < ``eps``, else the
    argmax (the first maximum, as the reference's)."""
    greedy = torch.argmax(qvals, dim=-1).to(torch.int32)
    return torch.where(uniforms.to(qvals.device) < eps,
                       rand_actions.to(device=qvals.device,
                                       dtype=torch.int32), greedy)


def polyak(target, online, tau: float):
    """Soft target-network update: target + tau * (online - target)."""
    with torch.no_grad():
        return tree_unflatten(target, [
            t + tau * (o - t) for t, o in zip(tree_leaves(target),
                                             tree_leaves(online),
                                             strict=True)])


def _weighted_mean(x: Tensor, weight: Optional[Tensor]) -> Tensor:
    """Batch mean of per-sample losses scaled by per-sample weights,
    over the BATCH SIZE, not ``sum(weight)``: PER importance weights
    rescale each sample (``(1/B) sum_i w_i delta_i``), and the all-zero
    underfill mask zeroes the loss."""
    if weight is None:
        return torch.mean(x)
    return (x * weight).sum() / x.shape[0]


def _batch_discount(batch: dict, cfg) -> Tensor:
    """Discount column; legacy batches carry ``dones`` instead."""
    if "discounts" in batch:
        return batch["discounts"]
    return cfg.gamma * (1.0 - batch["dones"].to(torch.float32))


def _rows(x: Tensor, cols: Tensor) -> Tensor:
    """``x[arange(B), cols]``."""
    return x[torch.arange(x.shape[0], device=x.device),
             cols.to(device=x.device, dtype=torch.int64)]


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def dqn_loss_td(params, target_params, apply_fn: Callable, batch: dict,
                cfg: DQNConfig):
    """(Double-)DQN TD error, ``apply_fn(params, obs) -> [B, A]``.
    Returns ``(loss, |td| per sample)``."""
    q = apply_fn(params, batch["obs"])
    q_sel = _rows(q, batch["actions"])
    with torch.no_grad():
        q_next_t = apply_fn(target_params, batch["next_obs"])
        if cfg.double:
            a_star = torch.argmax(apply_fn(params, batch["next_obs"]),
                                  dim=-1)
            q_next = _rows(q_next_t, a_star)
        else:
            q_next = q_next_t.max(-1).values
        target = batch["rewards"] + _batch_discount(batch, cfg) * q_next
    td = q_sel - target
    loss = _weighted_mean(torch.square(td), batch.get("weight"))
    return loss, torch.abs(td).detach()


def dqn_loss(params, target_params, apply_fn: Callable, batch: dict,
             cfg: DQNConfig) -> Tensor:
    return dqn_loss_td(params, target_params, apply_fn, batch, cfg)[0]


def quantile_taus(n: int, device="cpu") -> Tensor:
    """Quantile midpoints tau_i = (2i + 1) / 2n."""
    return div_scalar(torch.arange(n, dtype=torch.float32, device=device)
                      + 0.5, float(n))


def quantile_huber(theta: Tensor, target: Tensor, kappa: float) -> Tensor:
    """Per-sample quantile-Huber loss between predicted quantiles
    ``theta`` [B, N] and target atoms ``target`` [B, M] (Dabney et
    al.): u[b, i, j] = target_j - theta_i, weighted by |tau_i - 1{u <
    0}|.  Returns [B]."""
    N = theta.shape[-1]
    u = target[:, None, :] - theta[:, :, None]        # [B, N, M]
    absu = torch.abs(u)
    huber = torch.where(absu <= kappa, 0.5 * torch.square(u),
                        kappa * (absu - 0.5 * kappa))
    taus = quantile_taus(N, theta.device)[None, :, None]
    rho = torch.abs(taus - (u < 0).to(torch.float32)) * huber / kappa
    return rho.mean(dim=2).sum(dim=1)                 # [B]


def qrdqn_loss_td(params, target_params, apply_fn: Callable, batch: dict,
                  cfg: QRDQNConfig):
    """Quantile-regression DQN with Double-DQN action selection,
    ``apply_fn(params, obs) -> [B, A, n_quantiles]``.  Returns ``(loss,
    |td|)``, the TD error between the quantile means."""
    theta = apply_fn(params, batch["obs"])            # [B, A, N]
    theta_a = _rows(theta, batch["actions"])          # [B, N]
    with torch.no_grad():
        next_t = apply_fn(target_params, batch["next_obs"])
        if cfg.double:
            a_star = torch.argmax(
                apply_fn(params, batch["next_obs"]).mean(-1), dim=-1)
        else:
            a_star = torch.argmax(next_t.mean(-1), dim=-1)
        next_q = _rows(next_t, a_star)                # [B, N]
        target = (batch["rewards"][:, None]
                  + _batch_discount(batch, cfg)[:, None] * next_q)
    per_sample = quantile_huber(theta_a, target, cfg.kappa)
    loss = _weighted_mean(per_sample, batch.get("weight"))
    td = torch.abs(target.mean(-1) - theta_a.mean(-1))
    return loss, td.detach()


def qrdqn_loss(params, target_params, apply_fn: Callable, batch: dict,
               cfg: QRDQNConfig) -> Tensor:
    return qrdqn_loss_td(params, target_params, apply_fn, batch, cfg)[0]


def truncated_target_quantiles(z1_t: Tensor, z2_t: Tensor,
                               drop: int) -> Tensor:
    """TQC's truncation: pool both target critics' quantiles [B, N] +
    [B, N], sort ascending, drop the top ``drop``.  Returns
    [B, 2N - drop]."""
    pooled = torch.sort(torch.cat([z1_t, z2_t], dim=-1), dim=-1).values
    n_keep = pooled.shape[-1] - drop
    if n_keep < 1:
        raise ValueError(f"tqc drop={drop} leaves no target quantiles "
                         f"out of {pooled.shape[-1]}")
    return pooled[..., :n_keep]


def ddpg_critic_loss_td(critic_params, target_critic, target_actor,
                        critic_apply: Callable, actor_apply: Callable,
                        batch: dict, cfg: DDPGConfig, normals: Tensor):
    """Twin-critic TD error with target-policy smoothing (TD3 eq. 14),
    or with ``cfg.critic_quantiles > 1`` the TQC backup.  ``normals``
    [B, d] are the smoothing draws (standard normal).  Returns ``(loss,
    |td|)``."""
    with torch.no_grad():
        na = actor_apply(target_actor, batch["next_obs"])
        noise = torch.clamp(normals.to(na.device) * cfg.policy_noise,
                            -cfg.noise_clip, cfg.noise_clip) \
            * cfg.half_range
        na = torch.clamp(na + noise, cfg.low, cfg.high)
        q1_t, q2_t = critic_apply(target_critic, batch["next_obs"], na)
    q1, q2 = critic_apply(critic_params, batch["obs"], batch["actions"])
    disc = _batch_discount(batch, cfg)
    if cfg.critic_quantiles == 1:
        target = (batch["rewards"] + disc * torch.minimum(q1_t, q2_t))
        err = torch.square(q1 - target) + torch.square(q2 - target)
        loss = _weighted_mean(err, batch.get("weight"))
        td = 0.5 * (torch.abs(q1 - target) + torch.abs(q2 - target))
        return loss, td.detach()
    kept = truncated_target_quantiles(q1_t, q2_t, cfg.tqc_drop)
    target = batch["rewards"][:, None] + disc[:, None] * kept
    per_sample = (quantile_huber(q1, target, cfg.kappa)
                  + quantile_huber(q2, target, cfg.kappa))
    loss = _weighted_mean(per_sample, batch.get("weight"))
    td = torch.abs(target.mean(-1) - 0.5 * (q1.mean(-1) + q2.mean(-1)))
    return loss, td.detach()


def ddpg_critic_loss(critic_params, target_critic, target_actor,
                     critic_apply: Callable, actor_apply: Callable,
                     batch: dict, cfg: DDPGConfig, normals: Tensor) -> Tensor:
    return ddpg_critic_loss_td(critic_params, target_critic, target_actor,
                               critic_apply, actor_apply, batch, cfg,
                               normals)[0]


def ddpg_actor_loss(actor_params, critic_params, critic_apply: Callable,
                    actor_apply: Callable, batch: dict) -> Tensor:
    """Deterministic policy gradient: maximize Q1(s, pi(s)) (scalar
    critics), or the mean over both critics' quantiles (TQC: the actor
    sees the untruncated mixture)."""
    a = actor_apply(actor_params, batch["obs"])
    q1, q2 = critic_apply(critic_params, batch["obs"], a)
    if q1.ndim == 2:                                  # quantile heads
        q = 0.5 * (q1.mean(-1) + q2.mean(-1))
        return -_weighted_mean(q, batch.get("weight"))
    return -_weighted_mean(q1, batch.get("weight"))
