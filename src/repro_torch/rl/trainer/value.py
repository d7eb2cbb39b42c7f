"""The off-policy value-based trainer (port of
``repro.rl.trainer.value``: dqn / qrdqn / ddpg on one device).

The paper's Fig. 2 split with replay: quantized (fxp8) behaviour actors
roll the envs from an int8 weight sync — ε-greedy over the Q net, or
the DDPG actor plus exploration noise — and the fp32 learner samples
uniform or prioritized replay for ``updates_per_iter`` AdamW updates an
iteration (``weight_decay=0``, gradients clipped to norm 10), with
polyak targets.  On a CUDA device each actor product is the Q-MAC
kernel and each actor conv the Q-Conv kernel; the learner is fp32
PyTorch, as the reference's runs no quantized op.  ε anneals over the
first half of the rollout steps (``iters * rollout_len // 2``); PER's
β anneals to 1 over ``per_beta_iters`` (default: the whole run).

The replay buffer and the PER tree are part of the checkpoint, with the
reference's metadata, so a resume restores bitwise; a checkpoint's
flags are validated before its tree is read.

``metrics_dir`` writes the ``obs/v1`` telemetry (``env_steps``,
``episodes``, ``return_mean``, ``epsilon``, ``replay_size`` and, under
PER, ``replay_max_priority`` from the iteration, the loop's host metrics
and spans), ``profile_dir`` a ``torch.profiler`` trace of
``profile_steps`` steps from ``profile_start``; neither changes the run.
Several devices (``--mesh``/``--sync``) raise ``NotImplementedError``
naming the sharded slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.policy import get_policy
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.obs import MetricSpec
from repro_torch.optim import AdamWConfig, adamw_init, constant
from repro_torch.rl.actor_learner import pack_weights
from repro_torch.rl.envs import make
from repro_torch.rl.envs.wrappers import (NormStats, init_norm_stats,
                                          merge_norm_stats)
from repro_torch.rl.inference import (ON_POLICY_ALGOS, VALUE_ALGOS,
                                      build_env, make_value_agent,
                                      not_in_slice)
from repro_torch.rl.replay import make_replay, replay_size
from repro_torch.rl.rollout import init_envs
from repro_torch.rl.train_steps import (draw_value_iteration,
                                        make_value_iteration)
from repro_torch.rl.trainer.base import Trainer, flag_mismatch
from repro_torch.rl.trainer.evaluation import greedy_eval
from repro_torch.rl.trainer.state import TrainState, value_state
from repro_torch.tree import tree_map

def value_eval(algo: str, env_name: str, params, n_envs: int = 16,
               n_steps: Optional[int] = None,
               actor_policy: Optional[str] = None, seed: int = 0,
               net: str = "mlp", frame_stack_k: int = 1,
               norm_stats: Optional[NormStats] = None,
               device: DeviceLike = None):
    """Greedy-policy evaluation on ``device`` (default: the card):
    (mean completed-episode return, episode count).  ``net="conv"``
    evaluates over the pixel pipeline with the normalizer frozen at
    ``norm_stats`` (the training run's merged statistics; None: the
    identity)."""
    dev = resolve_device(device)
    if net == "conv":
        frozen = norm_stats
        if frozen is None:
            frozen = merge_norm_stats(init_norm_stats(
                1, make(env_name).obs_shape, dev))
        frozen = tree_map(lambda t: t.to(dev), frozen)
        env = build_env(env_name, net, frame_stack_k, norm_stats=frozen)
    else:
        env = build_env(env_name, net, frame_stack_k)
    spec = env.spec
    agent = make_value_agent(algo, spec, net=net)  # heads only, no init
    policy = get_policy(actor_policy) if actor_policy else None
    n_steps = n_steps or spec.max_steps + spec.max_steps // 4
    return greedy_eval(env, lambda p, o: agent.greedy(p, o, policy),
                       params, seed + 17, n_envs, n_steps, dev)


class ValueTrainer(Trainer):
    family = "value"

    def __init__(self, algo: str = "dqn", env_name: str = "cartpole",
                 iters: int = 300, n_envs: int = 32, rollout_len: int = 8,
                 actor_policy: Optional[str] = "fxp8", lr: float = 1e-3,
                 comm_bits: int = 8, seed: int = 0,
                 ckpt_dir: Optional[str] = None, save_every: int = 50,
                 replay_capacity: int = 50_000, n_step: int = 3,
                 updates_per_iter: int = 4, log_every: int = 20,
                 verbose: bool = True, learn_start: Optional[int] = None,
                 net: str = "mlp", frame_stack_k: int = 1,
                 replay: str = "uniform", per_alpha: float = 0.6,
                 per_beta0: float = 0.4,
                 per_beta_iters: Optional[int] = None, tqc_drop: int = 0,
                 mesh_kind: Optional[str] = None,
                 mesh_devices: Optional[int] = None,
                 max_lag: int = 1, metrics_dir: Optional[str] = None,
                 profile_dir: Optional[str] = None, profile_start: int = 0,
                 profile_steps: int = 1, device: DeviceLike = None):
        if algo not in VALUE_ALGOS:
            raise ValueError(f"value_train drives {VALUE_ALGOS}, got "
                             f"{algo!r}; use rl_train for "
                             f"{ON_POLICY_ALGOS}")
        if mesh_kind is None and mesh_devices is not None:
            raise ValueError("--mesh-devices restricts a device mesh; "
                             "the value loop is single-device without "
                             "--mesh host")
        if mesh_kind is not None:
            raise not_in_slice(f"--algo {algo} --mesh {mesh_kind}",
                               "sharded paths")
        dev = resolve_device(device)
        super().__init__(iters=iters, seed=seed, ckpt_dir=ckpt_dir,
                         save_every=save_every, log_every=log_every,
                         verbose=verbose, device=dev, max_lag=max_lag,
                         metrics_dir=metrics_dir, profile_dir=profile_dir,
                         profile_start=profile_start,
                         profile_steps=profile_steps)
        self.algo, self.env_name, self.net = algo, env_name, net
        self.n_envs, self.rollout_len = n_envs, rollout_len
        self.frame_stack_k = frame_stack_k
        self.replay, self.per_alpha = replay, per_alpha
        self.per_beta0, self.tqc_drop = per_beta0, tqc_drop
        self.actor_policy_name = actor_policy
        self.env = build_env(env_name, net, frame_stack_k)
        spec = self.env.spec
        self.a_policy = get_policy(actor_policy) if actor_policy else None
        self.comm = comm_bits if self.a_policy else 32
        # epsilon anneals over the first half of the rollout steps
        decay = max((iters * rollout_len) // 2, 1)
        self.agent = make_value_agent(
            algo, spec, torch.Generator().manual_seed(seed), n_step=n_step,
            eps_decay_steps=decay, learn_start=learn_start, net=net,
            tqc_drop=tqc_drop, device=dev)
        act = ((spec.action_space.shape, torch.float32)
               if algo == "ddpg" else ((), torch.int32))
        self.rb = make_replay(replay, replay_capacity, spec.obs_shape,
                              act[0], act[1], alpha=per_alpha, device=dev)
        self.capacity = replay_capacity
        self.beta_iters = max(per_beta_iters if per_beta_iters is not None
                              else iters, 1)
        self.n_step = n_step
        self.updates_per_iter = updates_per_iter
        self.ocfg = AdamWConfig(weight_decay=0.0, max_grad_norm=10.0)
        self.sched = constant(lr)

    # ---- trainer seams ---------------------------------------------------
    def init_state(self) -> TrainState:
        params = self.agent.params
        target = tree_map(torch.clone, params)
        if self.algo == "ddpg":
            opt = {"actor": adamw_init(params["actor"]),
                   "critic": adamw_init(params["critic"])}
        else:
            opt = adamw_init(params)
        est, obs = init_envs(self.env, self.seed + 1, self.n_envs,
                             self.device)
        return value_state(params, target, opt, self.rb.init(), est, obs)

    def build_iteration(self):
        return make_value_iteration(
            self.env, self.agent, self.rb, self.a_policy, self.sched,
            self.ocfg, algo=self.algo, rollout_len=self.rollout_len,
            updates_per_iter=self.updates_per_iter,
            per_beta0=self.per_beta0, beta_iters=self.beta_iters)

    def metric_spec(self) -> MetricSpec:
        gauges = ["return_mean", "epsilon", "replay_size"]
        if self.rb.prioritized:
            gauges.append("replay_max_priority")
        return MetricSpec(counters=("env_steps", "episodes"),
                          gauges=tuple(gauges))

    def run_meta(self) -> dict:
        meta = super().run_meta()
        meta.update(algo=self.algo, env=self.env_name, net=self.net,
                    n_envs=self.n_envs, rollout_len=self.rollout_len,
                    replay=self.replay, sync="lockstep")
        return meta

    def size_after(self, g: int) -> int:
        """The replay size after step ``g``'s add: every iteration adds
        ``rollout_len * n_envs`` transitions (known on the host)."""
        return min((g + 1) * self.rollout_len * self.n_envs, self.capacity)

    def draws(self, gen: torch.Generator, g: int):
        """Step ``g``'s exploration, replay and smoothing draws."""
        return draw_value_iteration(
            gen, self.env.action_space, self.rb,
            batch_size=self.agent.cfg.batch_size,
            rollout_len=self.rollout_len, n_envs=self.n_envs,
            updates_per_iter=self.updates_per_iter,
            replay_size=self.size_after(g), device=self.device)

    def pack(self, state):
        # only the behaviour net ships to the fleet (ddpg: the actor)
        return pack_weights(self.agent.behaviour_subtree(state.params),
                            self.comm)

    def step(self, iteration, state, packed, gen, g, stage_ctx, alive):
        p, t, o, b, est, obs, ret, n_ep = iteration(
            state.params, state.target, state.opt, state.replay, packed,
            state.est, state.obs, self.draws(gen, g), g)
        return value_state(p, t, o, b, est, obs), ret, n_ep

    def record(self, iteration, mbuf, state, ret, n_ep, g, alive):
        return iteration.record(mbuf, g, state.replay, ret, n_ep,
                                self.n_envs)

    def eval_policy(self, params, n_envs: int = 16,
                    n_steps: Optional[int] = None,
                    actor_policy: Optional[str] = None, seed: int = 0,
                    norm_stats: Optional[NormStats] = None):
        return value_eval(self.algo, self.env_name, params, n_envs=n_envs,
                          n_steps=n_steps, actor_policy=actor_policy,
                          seed=seed, net=self.net,
                          frame_stack_k=self.frame_stack_k,
                          norm_stats=norm_stats, device=self.device)

    # ---- checkpoint seams ------------------------------------------------
    def validate_metadata(self, md: dict) -> None:
        d = self.ckpt_dir
        md_net = str(md.get("net", self.net))
        if md_net != self.net:
            raise flag_mismatch(d, "net", repr(md_net), repr(self.net),
                                "the torso family (and the obs "
                                "pipeline) differs")
        md_env = str(md.get("env", self.env_name))
        if md_env != self.env_name:
            raise flag_mismatch(d, "env", repr(md_env), repr(self.env_name))
        md_algo = str(md.get("algo", ""))
        if md_algo != self.algo:
            raise flag_mismatch(d, "algo", repr(md_algo), repr(self.algo))
        md_replay = str(md.get("replay", "uniform"))
        if md_replay != self.replay:
            raise flag_mismatch(d, "replay", repr(md_replay),
                                repr(self.replay),
                                "the sampling stream (and the PER tree "
                                "state) is part of the run")
        md_tqc = int(md.get("tqc_drop", 0))
        if md_tqc != self.tqc_drop:
            raise flag_mismatch(d, "tqc-drop", md_tqc, self.tqc_drop,
                                "the critic head shape differs "
                                "(restore does not shape-check)")
        md_slots = int(md.get("replay_slots", 1))
        if md_slots != self.n_slots:
            raise ValueError(
                f"checkpoint in {d} was saved with {md_slots} replay "
                f"slot(s), but this run's mesh shards {self.n_slots} — "
                "the sharded buffer layout differs; relaunch with the "
                "original --mesh/--mesh-devices flags")
        # one device fetches in lockstep; the sharded slice adds doublebuf
        md_sync = str(md.get("sync", "lockstep"))
        if md_sync != "lockstep":
            raise flag_mismatch(d, "sync", repr(md_sync), repr("lockstep"),
                                "the weight-sync fetch stream differs",
                                verb="saved with")
        if self.replay == "per":
            for flag, have in (("per_alpha", self.per_alpha),
                               ("per_beta0", self.per_beta0),
                               ("per_beta_iters", self.beta_iters)):
                saved = md.get(flag)
                if saved is not None and float(saved) != float(have):
                    raise flag_mismatch(
                        d, flag.replace("_", "-"), saved, have,
                        "the prioritized sampling stream depends on it",
                        verb="saved with")

    def metadata(self, it: int, stage) -> dict:
        md = {"algo": self.algo, "it": it, "replay": self.replay,
              "tqc_drop": self.tqc_drop, "env": self.env_name,
              "net": self.net, "frame_stack": self.frame_stack_k,
              "n_envs": self.n_envs, "n_step": self.n_step,
              "actor_policy": self.actor_policy_name or "fp32",
              "replay_slots": self.n_slots, "sync": "lockstep"}
        if self.rb.prioritized:
            md.update(per_alpha=self.per_alpha, per_beta0=self.per_beta0,
                      per_beta_iters=self.beta_iters)
        return md

    def resume_start(self, md: dict) -> int:
        return int(md.get("it", md.get("step", 0))) + 1

    def resume_message(self, md, state, start: int) -> str:
        return (f"resumed at iter {start} "
                f"(replay size {int(replay_size(state.replay))})")

    def host_metrics(self, metrics: dict, g: int) -> dict:
        # without the buffer the window record still carries the replay
        # fill, which the host knows
        if "replay_size" in metrics:
            return {}
        return {"replay_size": self.size_after(g)}

    def log_line(self, it, ret, n_ep, metrics: dict, stage) -> str:
        return (f"iter {it:4d}  return {float(ret):8.2f}  "
                f"episodes {int(n_ep):4d}  "
                f"replay {int(metrics['replay_size']):6d}")

    def export_state(self, state, state_out) -> None:
        if state_out is not None:
            state_out.update(env_state=state.est, obs=state.obs,
                             replay=state.replay)


def value_train(algo: str = "dqn", env_name: str = "cartpole",
                iters: int = 300, n_envs: int = 32, rollout_len: int = 8,
                actor_policy: Optional[str] = "fxp8", lr: float = 1e-3,
                comm_bits: int = 8, seed: int = 0,
                ckpt_dir: Optional[str] = None, save_every: int = 50,
                replay_capacity: int = 50_000, n_step: int = 3,
                updates_per_iter: int = 4, log_every: int = 20,
                verbose: bool = True, learn_start: Optional[int] = None,
                net: str = "mlp", frame_stack_k: int = 1,
                replay: str = "uniform", per_alpha: float = 0.6,
                per_beta0: float = 0.4,
                per_beta_iters: Optional[int] = None, tqc_drop: int = 0,
                state_out: Optional[dict] = None,
                mesh_kind: Optional[str] = None,
                mesh_devices: Optional[int] = None,
                max_lag: int = 1, metrics_dir: Optional[str] = None,
                profile_dir: Optional[str] = None, profile_start: int = 0,
                profile_steps: int = 1, device: DeviceLike = None):
    """Off-policy value-based training on ``device`` (default: the
    card) — see :class:`ValueTrainer`.  Returns (params, history);
    ``state_out`` receives the final ``env_state``/``obs``/``replay``."""
    trainer = ValueTrainer(
        algo, env_name, iters=iters, n_envs=n_envs,
        rollout_len=rollout_len, actor_policy=actor_policy, lr=lr,
        comm_bits=comm_bits, seed=seed, ckpt_dir=ckpt_dir,
        save_every=save_every, replay_capacity=replay_capacity,
        n_step=n_step, updates_per_iter=updates_per_iter,
        log_every=log_every, verbose=verbose, learn_start=learn_start,
        net=net, frame_stack_k=frame_stack_k, replay=replay,
        per_alpha=per_alpha, per_beta0=per_beta0,
        per_beta_iters=per_beta_iters, tqc_drop=tqc_drop,
        mesh_kind=mesh_kind, mesh_devices=mesh_devices, max_lag=max_lag,
        metrics_dir=metrics_dir, profile_dir=profile_dir,
        profile_start=profile_start, profile_steps=profile_steps,
        device=device)
    state, history = trainer.train(state_out=state_out)
    return state.params, history
