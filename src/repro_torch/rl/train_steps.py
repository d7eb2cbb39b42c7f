"""The training iterations of both families (port of
``repro.rl.train_steps``).

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

On a mesh (``--mesh host``) the on-policy iteration collects with the
sharded fleet (``collect_sharded``) and runs the learner replicated on
every rank over the gathered global trajectory, so every rank computes
the reference's global-view program and N ranks end with the same
params bit for bit.  ``make_sharded_value_iteration`` gives each rank
one replay slot: the rank adds its own transitions, samples its share
of the batch, and the gradients are the mean over the live slots, a
slot-ordered sum over the mesh divided by ``max(sum(alive), 1)``.  At
one slot both are the unsharded iterations bit for bit.

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

from repro_torch.distributed.sharding import (data_axes, data_axis_size,
                                              local_rows, pmax, psum,
                                              psum_tree, slot_index)
from repro_torch.obs.metrics import counter_add, gauge_max, gauge_set
from repro_torch.optim import adamw_update
from repro_torch.rl.actor_learner import (collect, collect_sharded,
                                          collect_value,
                                          collect_value_sharded, fleet_mask,
                                          slot_key)
from repro_torch.rl.envs.spaces import Discrete
from repro_torch.rl.ppo import batch_from_traj, minibatch_epochs, \
    value_and_grad
from repro_torch.rl.replay import (normalize_weights, per_global_weights,
                                   replay_size)
from repro_torch.rl.rollout import episode_returns, episode_returns_from
from repro_torch.rl.value import (ddpg_actor_loss, ddpg_critic_loss_td,
                                  epsilon, fma32, nstep_targets, polyak)
from repro_torch.tree import tree_map


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
                            n_slots: int = 1, mesh=None) -> Callable:
    """One collect + minibatch-update step (ppo / a2c):

        iteration(params, opt, est, obs, packed, draws, gmask, alive)
            -> (params, opt, est, obs, ret, n_ep)

    With ``mesh`` the rollout is the sharded fleet's over its data axes
    (``n_slots`` of them); without, the one-device ``collect``.
    """
    def learner_apply(p, o):
        return apply_fn(p, o, None)

    def opt_step(p, s, g):
        p, s, _ = adamw_update(g, s, p, sched, ocfg)
        return p, s

    def rollout_phase(packed, draws, est, obs):
        if mesh is None:
            return collect(packed, env, apply_fn, a_policy, draws.noise,
                           est, obs, rollout_len, dist)
        return collect_sharded(packed, env, apply_fn, a_policy, draws.noise,
                               est, obs, rollout_len, mesh, dist)

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
    return _value_iteration(env, agent, rb, a_policy, sched, ocfg, None,
                            algo=algo, rollout_len=rollout_len,
                            updates_per_iter=updates_per_iter,
                            per_beta0=per_beta0, beta_iters=beta_iters)


def make_sharded_value_iteration(env, agent, rb, a_policy, sched, ocfg,
                                 mesh, *, algo: str, rollout_len: int,
                                 updates_per_iter: int, per_beta0: float,
                                 beta_iters: int) -> Callable:
    """The value-family step over the mesh's data axes, on each rank of
    the mesh:

        iteration(params, target, opt, buf, packed, est, obs, draws, it,
                  alive) -> (params, target, opt, buf, est, obs, ret, n_ep)

    ``rb`` is the per-slot replay backend (capacity ``capacity //
    n_slots``) and ``buf`` this rank's slot of it; ``est``,
    ``obs`` and the draws are global.  Slot ``d`` collects its envs with
    its rows of the draws, writes its transitions into its slot, samples
    its ``batch_size / n_slots`` with its columns of the replay draws,
    and contributes a local gradient; the learner applies the mean over
    the live slots (the slot-ordered sum over the mesh divided by
    ``max(sum(alive), 1)``), so every rank takes the same optimizer step
    and the params stay replicated.  The underfill gate reads the global
    size, and PER's weights use the global size and the global max of
    the slots' maxima (:func:`per_global_weights`,
    :func:`normalize_weights`).  A slot with ``alive[d]`` False still
    runs but its batch weights are 0 and the mean counts only live
    slots.  At one slot the step is :func:`make_value_iteration`'s bit
    for bit."""
    if not data_axes(mesh):
        raise ValueError(f"mesh {mesh.mesh_dim_names} has no data axes to "
                         "shard the value fleet over")
    n_slots = data_axis_size(mesh)
    if agent.cfg.batch_size % n_slots != 0:
        raise ValueError(
            f"batch size {agent.cfg.batch_size} does not divide evenly over "
            f"{n_slots} replay slot(s) (--batch-size)")
    return _value_iteration(env, agent, rb, a_policy, sched, ocfg, mesh,
                            algo=algo, rollout_len=rollout_len,
                            updates_per_iter=updates_per_iter,
                            per_beta0=per_beta0, beta_iters=beta_iters,
                            n_slots=n_slots)


class _SlotView(NamedTuple):
    """A sharded value iteration's cross-slot state for its updates."""

    size_g: torch.Tensor    # 0-dim int32: the global replay size
    ok: torch.Tensor        # 0-dim fp32: size_g >= learn_start
    a_live: torch.Tensor    # 0-dim fp32: this slot's liveness
    n_alive: torch.Tensor   # 0-dim fp32: live slots, at least 1


def _value_iteration(env, agent, rb, a_policy, sched, ocfg, mesh, *,
                     algo: str, rollout_len: int, updates_per_iter: int,
                     per_beta0: float, beta_iters: int,
                     n_slots: int = 1) -> Callable:
    """Both value iterations: ``mesh`` None is the one-device step, a
    mesh the sharded one (``rb`` then the per-slot backend)."""
    cfg = agent.cfg
    discrete = agent.discrete
    slot = slot_index(mesh) if mesh is not None else 0
    learn_min = max(int(cfg.learn_start), 1)

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
        if mesh is None:
            return collect_value(packed, env, agent.behave, a_policy,
                                 draws.step, est, obs, rollout_len, eps)
        return collect_value_sharded(packed, env, agent.behave, a_policy,
                                     draws.step, est, obs, rollout_len, eps,
                                     mesh)

    def add_rollout(buf, traj):
        """The rollout's n-step transitions written into the replay (on
        a mesh: this slot's columns of the global rollout, into its
        slot)."""
        if mesh is not None:
            traj = local_rows(traj, mesh, dim=1)
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

    def mean_grad_step(n_alive, on_grad: Optional[Callable] = None):
        """``grad_step`` with the gradient the mean over the live slots
        (handed to ``on_grad(name, grads)`` first, when given)."""
        def step(name, loss_fn, p, s, args):
            (_, aux), g = value_and_grad(loss_fn, p, *args)
            with torch.no_grad():
                g = tree_map(lambda x: x / n_alive, psum_tree(g, mesh))
            if on_grad is not None:
                on_grad(name, g)
            p, s = opt_step(p, s, g)
            return p, s, aux
        return step

    def actor_loss(p, *args):
        return ddpg_actor_loss(p, *args), {}

    def slot_view(buf, alive) -> _SlotView:
        """What an iteration's updates share across the mesh, gathered
        once after the replay add (as the reference's ``update_shard``
        does): the global size, the underfill gate, this slot's 0/1
        liveness and the live-slot count (at least 1)."""
        size_g = psum(replay_size(buf), mesh)
        if alive is None:
            a_live = torch.ones((), device=size_g.device)
        else:
            a_live = alive[slot].to(device=size_g.device,
                                    dtype=torch.float32)
        return _SlotView(size_g, (size_g >= learn_min).to(torch.float32),
                         a_live, torch.clamp_min(psum(a_live, mesh), 1.0))

    def sample(buf, draws: ValueDraws, u: int, beta: float,
               view: Optional[_SlotView]):
        """Update ``u``'s replay batch: the buffer's own (one device), or
        this slot's share with globally corrected weights."""
        if mesh is None:
            return rb.sample(buf, draws.replay[u], min_size=cfg.learn_start,
                             beta=beta, masked=True)
        batch = rb.sample(buf, slot_key(draws.replay[u], slot, n_slots),
                          min_size=1, beta=beta, masked=True)
        gate = view.ok * view.a_live
        if rb.prioritized:
            w = per_global_weights(batch["probs"], view.size_g, beta,
                                   n_slots)
            w = normalize_weights(w, pmax(w.max(), mesh))
            batch["weight"] = w * gate
        else:
            batch["weight"] = gate.expand(batch["weight"].shape)
        return batch

    def update(params, target, opt, buf, draws: ValueDraws, u: int,
               beta: float, step: Optional[Callable] = None,
               view: Optional[_SlotView] = None):
        """Update ``u`` of an iteration: the replay sample, each
        gradient and AdamW ``step`` (default: the family's; on a mesh
        the mean over the live slots), polyak and the priority
        write-back.  On a mesh ``view`` is the iteration's
        ``slot_view``."""
        if mesh is not None:
            step = step or mean_grad_step(view.n_alive)
        step = step or grad_step
        with torch.no_grad():
            batch = sample(buf, draws, u, beta, view)
        if algo == "ddpg":
            smoothing = draws.smoothing[u]
            if mesh is not None:
                smoothing = slot_key(smoothing, slot, n_slots)
            # the actor's loss reads the critic after its update
            c_p, c_s, td = step(
                "critic", ddpg_critic_loss_td, params["critic"],
                opt["critic"], (target["critic"], target["actor"],
                                agent.critic_apply, agent.act, batch, cfg,
                                smoothing))
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
                    it: int, alive=None):
        buf = add_rollout(buf, traj)
        b = beta(it)
        view = slot_view(buf, alive) if mesh is not None else None
        for u in range(updates_per_iter):
            params, target, opt, buf = update(params, target, opt, buf,
                                              draws, u, b, view=view)
        return params, target, opt, buf

    def iteration(params, target, opt, buf, packed, est, obs,
                  draws: ValueDraws, it: int, alive=None):
        (est, obs), traj = rollout_phase(packed, draws, est, obs, it)
        params, target, opt, buf = learn_phase(params, target, opt, buf,
                                               traj, draws, it, alive)
        _, _, R, D, Tr, _ = traj
        ret, n_ep = episode_returns_from(R, D | Tr)
        return params, target, opt, buf, est, obs, ret, n_ep

    def record(mbuf, it: int, buf, ret, n_ep, n_envs: int, alive=None):
        """The iteration's metric writes (the reference's
        ``_value_metric_updates``): ε at the compiled fp32 value; on a
        mesh the global replay size and max priority, and
        ``alive_frac``."""
        size, max_p = replay_size(buf), getattr(buf, "max_p", None)
        if mesh is not None:
            size = psum(size, mesh)
            max_p = pmax(max_p, mesh) if max_p is not None else None
        mbuf = counter_add(mbuf, "env_steps", rollout_len * n_envs)
        mbuf = counter_add(mbuf, "episodes", n_ep)
        mbuf = gauge_set(mbuf, "return_mean", ret)
        mbuf = gauge_set(mbuf, "epsilon", eps_at(it))
        mbuf = gauge_set(mbuf, "replay_size", size)
        if rb.prioritized:
            mbuf = gauge_max(mbuf, "replay_max_priority", max_p)
        if mesh is not None:
            frac = (torch.ones(()) if alive is None
                    else alive.to(torch.float32).mean())
            mbuf = gauge_set(mbuf, "alive_frac", frac)
        return mbuf

    iteration.rollout_phase = rollout_phase
    iteration.learn_phase = learn_phase
    iteration.add_rollout, iteration.beta = add_rollout, beta
    iteration.update = update
    iteration.slot_view, iteration.mean_grad_step = slot_view, mean_grad_step
    iteration.record = record
    return iteration
