"""Bodies of the sharded fleet's multi-rank checks.

Each function here runs on every rank of a group (``ranks.run_ranks``
spawns them on the CPU; ``chip_smoke.py`` calls them in-process on the
card) and returns what its rank computed, as numpy, for a caller to hold
against a reference: the sharded collects, the compressed gradient
mean, and one sharded value update.  Inputs come in as numpy or as the
port's tensors on the CPU; the mesh is the host mesh over every rank.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import from_numpy_tree
from repro_torch.core.policy import FXP8
from repro_torch.distributed.ranks import to_host as as_numpy
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import AdamWConfig, adamw_init, constant
from repro_torch.optim.compression import compressed_psum_mean, shared_codes
from repro_torch.rl.actor_learner import collect_sharded, collect_value_sharded
from repro_torch.rl.envs import make
from repro_torch.rl.inference import build_env, make_value_agent
from repro_torch.rl.nets import mlp_ac_apply
from repro_torch.rl.replay import make_replay
from repro_torch.rl.rollout import init_envs
from repro_torch.rl.train_steps import ValueDraws, make_sharded_value_iteration


def fleet_collects(packed, est, obs, noise, value_packed, value_est,
                   value_obs, actions, uniforms, eps: float, n_steps: int,
                   reset_seed: int) -> dict:
    """The cartpole fleets over the host mesh: ``collect_sharded`` of
    the fxp8 mlp actor-critic with the global Gumbel draws ``noise``,
    ``collect_value_sharded`` of the fxp8 DQN behaviour with the global
    ε-greedy draws (``actions``, ``uniforms`` [T, B]), and
    ``init_envs(..., mesh)`` of ``len(obs)`` envs from ``reset_seed``:
    the global results every rank holds."""
    mesh = make_host_mesh(device="cpu")
    env = make("cartpole")
    res = collect_sharded(packed, env, mlp_ac_apply, FXP8, noise, est, obs,
                          n_steps, mesh)
    venv = build_env("cartpole", "mlp")
    agent = make_value_agent("dqn", venv.spec, device="cpu")
    value = collect_value_sharded(
        value_packed, venv, agent.behave, FXP8,
        lambda t: (actions[t], uniforms[t]), value_est, value_obs, n_steps,
        eps, mesh)
    reset = init_envs(env, reset_seed, obs.shape[0], "cpu", mesh=mesh)
    return as_numpy({"onpolicy": tuple(res), "value": value,
                     "reset": reset})


def compressed_means(gs: np.ndarray, cases: Sequence, steps: int) -> dict:
    """``compressed_psum_mean`` over the host mesh: rank ``r`` holds
    ``gs[step, r]`` at each of ``steps`` steps, the error buffer carried
    from step to step.  For each ``(bits, strategy)`` case, every step's
    shared scale, this rank's codes, the mean and the new error."""
    mesh = make_host_mesh(device="cpu")
    rank = torch.distributed.get_rank()
    out = {}
    for bits, strategy in cases:
        err, rows = None, []
        for k in range(steps):
            g = torch.from_numpy(gs[k, rank])
            row = {}
            if bits < 32:
                corr = g + (err if err is not None else torch.zeros_like(g))
                row["codes"], row["scale"] = shared_codes(corr, mesh, bits)
            row["mean"], err = compressed_psum_mean(g, mesh, bits, err,
                                                    strategy)
            row["error"] = err
            rows.append(as_numpy(row))
        out[f"{bits}-{strategy}"] = rows
    return out


def value_update(algo: str, env_name: str, params, target,
                 batches: List[Dict[str, np.ndarray]], alive: Sequence[bool],
                 smoothing: np.ndarray, lr: float, learn_start: int) -> dict:
    """One update of the sharded value iteration over the host mesh,
    slot ``d`` learning from ``batches[d]``: its replay slot holds that
    batch and samples it in order.  Returns each gradient the learner
    applied (the mean over the live slots, by name), and the params and
    AdamW state after the update."""
    mesh = make_host_mesh(device="cpu")
    env = build_env(env_name, "mlp")
    agent = make_value_agent(algo, env.spec, learn_start=learn_start,
                             device="cpu")
    n_slots = len(batches)
    n_local = len(batches[0]["rewards"])
    act = batches[0]["actions"]
    rb = make_replay("uniform", n_local, env.spec.obs_shape, act.shape[1:],
                     torch.float32 if algo == "ddpg" else torch.int32)
    ocfg = AdamWConfig(weight_decay=0.0, max_grad_norm=10.0)
    it = make_sharded_value_iteration(
        env, agent, rb, None, constant(lr), ocfg, mesh, algo=algo,
        rollout_len=1, updates_per_iter=1, per_beta0=0.4, beta_iters=1)
    b = {k: torch.from_numpy(v)
         for k, v in batches[torch.distributed.get_rank()].items()}
    buf = rb.add(rb.init(), b["obs"], b["actions"], b["rewards"],
                 b["next_obs"], b["discounts"])
    params = from_numpy_tree(params, "cpu")
    target = from_numpy_tree(target, "cpu")
    opt = ({k: adamw_init(v) for k, v in params.items()} if algo == "ddpg"
           else adamw_init(params))
    slots = torch.arange(n_local).repeat(n_slots)[None]
    draws = ValueDraws(None, None, None, slots,
                       torch.from_numpy(smoothing)[None]
                       if algo == "ddpg" else None)
    grads = {}
    view = it.slot_view(buf, torch.tensor(list(alive)))
    step = it.mean_grad_step(view.n_alive, grads.__setitem__)
    params, _, opt, _ = it.update(params, target, opt, buf, draws, 0, 1.0,
                                  step=step, view=view)
    return as_numpy({"grads": grads, "params": params, "opt": opt})


def suite(jobs: dict) -> dict:
    """Several of the checks above in one launch: ``jobs`` maps a name
    to ``(function name, kwargs)``."""
    return {name: globals()[fn](**kw) for name, (fn, kw) in jobs.items()}
