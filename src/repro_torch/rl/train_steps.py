"""The training iterations of both families (port of
``repro.rl.train_steps``, single device).

On-policy (``make_onpolicy_iteration``): one iteration collects a
rollout with the quantized actors, prices GAE with the learner's fp32
value head (the truncation bootstrap included), and runs the PPO/A2C
minibatch epochs with AdamW.  Value family (``make_value_iteration``):
one iteration collects with the quantized behaviour actors, folds the
chunk into n-step transitions, adds them to replay, and runs the
sampled fp32 updates with AdamW (and PER's priority write-back).

The randomness of an iteration comes in through one seam,
:class:`IterationDraws` or :class:`ValueDraws`.  The trainer draws them
from a ``torch.Generator`` seeded from (seed, global step); a parity
test draws the reference's with JAX and passes them in.  Each iteration
exposes its two phases, ``rollout_phase`` and ``learn_phase``, for a
caller that times or profiles them apart.  Neither reads a value back
to the host.

Telemetry: each iteration's ``record(mbuf, ...)`` makes the reference's
writes into a :mod:`repro_torch.obs.metrics` buffer and returns it.  The
writes consume values the iteration already computed (the return, the
episode count, ε, the replay's size and PER's max priority), take no
draw, read nothing back to the host and feed nothing back, so a run
that records computes bitwise what one that does not does.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.obs.metrics import counter_add, gauge_max, gauge_set
from repro_torch.optim import adamw_update
from repro_torch.rl.actor_learner import collect, collect_value, fleet_mask
from repro_torch.rl.envs.spaces import Discrete
from repro_torch.rl.ppo import batch_from_traj, minibatch_epochs, \
    value_and_grad
from repro_torch.rl.replay import replay_size
from repro_torch.rl.rollout import episode_returns, episode_returns_from
from repro_torch.rl.value import (ddpg_actor_loss, ddpg_critic_loss_td,
                                  epsilon, fma32, nstep_targets, polyak)


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

    def record(mbuf, ret, n_ep, alive):
        """The iteration's metric writes (the reference's)."""
        mbuf = counter_add(mbuf, "env_steps", rollout_len * n_envs)
        mbuf = counter_add(mbuf, "episodes", n_ep)
        mbuf = gauge_set(mbuf, "return_mean", ret)
        return gauge_set(mbuf, "alive_frac",
                         alive.to(torch.float32).mean())

    iteration.rollout_phase = rollout_phase
    iteration.learn_phase = learn_phase
    iteration.record = record
    return iteration


# ---------------------------------------------------------------------------
# the value family
# ---------------------------------------------------------------------------

class ValueDraws(NamedTuple):
    """One value iteration's random numbers."""

    actions: Optional[torch.Tensor]    # [T, B] ε-greedy random actions
    uniforms: Optional[torch.Tensor]   # [T, B] ε-greedy uniforms
    noise: Optional[torch.Tensor]      # [T, B, d] ddpg exploration normals
    replay: torch.Tensor               # [U, batch] slots (uniform) or
    #                                    stratification uniforms (per)
    smoothing: Optional[torch.Tensor]  # [U, batch, d] ddpg target normals

    def step(self, t: int):
        """Step ``t``'s exploration draws, as ``ValueAgent.behave``
        takes them."""
        if self.noise is not None:
            return self.noise[t]
        return self.actions[t], self.uniforms[t]


def draw_value_iteration(gen: torch.Generator, action_space, rb, *,
                         batch_size: int, rollout_len: int, n_envs: int,
                         updates_per_iter: int, replay_size: int,
                         device: torch.device) -> ValueDraws:
    """One value iteration's draws from ``gen`` (on ``device``).
    ``replay_size`` is the buffer's size after this iteration's add,
    which the host knows: every iteration adds ``rollout_len * n_envs``
    transitions."""
    T, B, U, n = rollout_len, n_envs, updates_per_iter, batch_size
    actions = uniforms = noise = smoothing = None
    if isinstance(action_space, Discrete):
        actions = torch.randint(0, action_space.n, (T, B), generator=gen,
                                device=device, dtype=torch.int32)
        uniforms = torch.rand((T, B), generator=gen, device=device)
    else:
        d = action_space.shape[0]
        noise = torch.randn((T, B, d), generator=gen, device=device)
        smoothing = torch.randn((U, n, d), generator=gen, device=device)
    replay = rb.draw(gen, (U, n), replay_size, device)
    return ValueDraws(actions, uniforms, noise, replay, smoothing)


def beta_at(it: int, per_beta0: float, beta_iters: int) -> float:
    """PER's importance-correction exponent at iteration ``it``, annealed
    from ``per_beta0`` to 1, as the reference's compiled iteration
    computes it in fp32."""
    f32 = np.float32
    frac = np.clip(f32(it) / f32(beta_iters), f32(0), f32(1))
    return fma32(1.0 - per_beta0, frac, per_beta0)


def make_value_iteration(env, agent, rb, a_policy, sched, ocfg, *,
                         algo: str, rollout_len: int, updates_per_iter: int,
                         per_beta0: float, beta_iters: int) -> Callable:
    """One collect-into-replay + sampled-updates step (dqn / qrdqn /
    ddpg):

        iteration(params, target, opt, buf, packed, est, obs, draws, it)
            -> (params, target, opt, buf, est, obs, ret, n_ep)

    ``it`` is the global step (a Python int), from which ε and PER's β
    follow.  The replay buffer is written in place (donated).  Below
    ``learn_start`` the updates still run, with every weight 0: the Adam
    count advances, the targets move and PER rewrites the sampled
    priorities, as the reference's jitted iteration does.  Its
    ``learn_phase`` is ``add_rollout`` then ``update`` for each of the
    iteration's updates, at PER's ``beta(it)``."""
    cfg = agent.cfg
    discrete = agent.discrete

    def opt_step(p, s, g):
        with torch.no_grad():
            p, s, _ = adamw_update(g, s, p, sched, ocfg)
        return p, s

    def q_learner(p, o):
        return agent.q_apply(p, o, None)

    def eps_at(it: int) -> float:
        return epsilon(it * rollout_len, cfg) if discrete else 0.0

    def rollout_phase(packed, draws: ValueDraws, est, obs, it: int):
        eps = eps_at(it)
        return collect_value(packed, env, agent.behave, a_policy, draws.step,
                             est, obs, rollout_len, eps)

    def add_rollout(buf, traj):
        """The rollout's n-step transitions written into the replay."""
        O, A, R, D, Tr, FO = traj
        with torch.no_grad():
            rets, nxt, disc = nstep_targets(R, D, Tr, FO, cfg.gamma,
                                            cfg.n_step)
        T, B = R.shape

        def flat(x):
            return x.reshape((T * B,) + tuple(x.shape[2:]))

        return rb.add(buf, flat(O), flat(A), flat(rets), flat(nxt),
                      flat(disc))

    def beta(it: int) -> float:
        return (beta_at(it, per_beta0, beta_iters) if rb.prioritized
                else 1.0)

    def grad_step(name, loss_fn, p, s, args):
        """One gradient of ``loss_fn(p, *args) -> (loss, aux)`` and one
        AdamW step of the subtree ``p`` (``name``: q, critic or actor):
        (p, s, aux)."""
        (_, aux), g = value_and_grad(loss_fn, p, *args)
        p, s = opt_step(p, s, g)
        return p, s, aux

    def actor_loss(p, *args):
        return ddpg_actor_loss(p, *args), {}

    def update(params, target, opt, buf, draws: ValueDraws, u: int,
               beta: float, step: Callable = grad_step):
        """Update ``u`` of an iteration: the replay sample, each
        gradient and AdamW ``step``, polyak and the priority
        write-back."""
        with torch.no_grad():
            batch = rb.sample(buf, draws.replay[u], min_size=cfg.learn_start,
                              beta=beta, masked=True)
        if algo == "ddpg":
            # the actor's loss reads the critic after its update
            c_p, c_s, td = step(
                "critic", ddpg_critic_loss_td, params["critic"],
                opt["critic"], (target["critic"], target["actor"],
                                agent.critic_apply, agent.act, batch, cfg,
                                draws.smoothing[u]))
            a_p, a_s, _ = step("actor", actor_loss, params["actor"],
                               opt["actor"], (c_p, agent.critic_apply,
                                              agent.act, batch))
            params = {"actor": a_p, "critic": c_p}
            opt = {"actor": a_s, "critic": c_s}
            target = polyak(target, params, cfg.tau)
        else:
            params, opt, td = step("q", agent.loss_fn, params, opt,
                                   (target, q_learner, batch, cfg))
            target = polyak(target, params, cfg.target_tau)
        # priority refresh from the fresh TD errors (uniform: no-op)
        with torch.no_grad():
            buf = rb.update(buf, batch["indices"], td)
        return params, target, opt, buf

    def learn_phase(params, target, opt, buf, traj, draws: ValueDraws,
                    it: int):
        buf = add_rollout(buf, traj)
        b = beta(it)
        for u in range(updates_per_iter):
            params, target, opt, buf = update(params, target, opt, buf,
                                              draws, u, b)
        return params, target, opt, buf

    def iteration(params, target, opt, buf, packed, est, obs,
                  draws: ValueDraws, it: int):
        (est, obs), traj = rollout_phase(packed, draws, est, obs, it)
        params, target, opt, buf = learn_phase(params, target, opt, buf,
                                               traj, draws, it)
        _, _, R, D, Tr, _ = traj
        ret, n_ep = episode_returns_from(R, D | Tr)
        return params, target, opt, buf, est, obs, ret, n_ep

    def record(mbuf, it: int, buf, ret, n_ep, n_envs: int):
        """The iteration's metric writes (the reference's
        ``_value_metric_updates``): ε at the compiled fp32 value."""
        mbuf = counter_add(mbuf, "env_steps", rollout_len * n_envs)
        mbuf = counter_add(mbuf, "episodes", n_ep)
        mbuf = gauge_set(mbuf, "return_mean", ret)
        mbuf = gauge_set(mbuf, "epsilon", eps_at(it))
        mbuf = gauge_set(mbuf, "replay_size", replay_size(buf))
        if rb.prioritized:
            mbuf = gauge_max(mbuf, "replay_max_priority", buf.max_p)
        return mbuf

    iteration.rollout_phase = rollout_phase
    iteration.learn_phase = learn_phase
    iteration.add_rollout, iteration.beta = add_rollout, beta
    iteration.update = update
    iteration.record = record
    return iteration
