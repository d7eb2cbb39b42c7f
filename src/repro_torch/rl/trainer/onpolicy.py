"""The on-policy trainer (port of ``repro.rl.trainer.onpolicy``: ppo and
a2c with the mlp agent, on one device).

The paper's Fig. 2 system: quantized (fxp8) actors roll the envs from
an int8 weight sync, and the fp32 learner runs PPO (or A2C) on their
trajectories.  On a CUDA device each actor product is the Q-MAC kernel;
the learner's products are fp32 ``torch.matmul``, as the reference's
learner runs no quantized product.  Truncated episodes bootstrap
through the timeout.

Not in this slice, each raising ``NotImplementedError`` that names its
slice: ``--agent hrl`` and ``--two-stage`` (HRL training), ``--net
conv`` (the pixel slice), several devices (the sharded slice),
``--metrics-dir``/``--profile-dir`` (observability).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.policy import get_policy
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.optim import AdamWConfig, adamw_init, constant
from repro_torch.rl.actor_learner import pack_weights
from repro_torch.rl.dists import distribution_for
from repro_torch.rl.envs import Environment
from repro_torch.rl.envs.spaces import head_dim
from repro_torch.rl.inference import (ON_POLICY_ALGOS, VALUE_ALGOS,
                                      build_env, not_in_slice)
from repro_torch.rl.nets import mlp_ac_apply, mlp_ac_init
from repro_torch.rl.ppo import PPOConfig, a2c_loss, ppo_loss
from repro_torch.rl.rollout import init_envs
from repro_torch.rl.train_steps import (draw_iteration,
                                        make_onpolicy_iteration)
from repro_torch.rl.trainer.base import Trainer, resolve_mesh
from repro_torch.rl.trainer.evaluation import greedy_action, greedy_eval
from repro_torch.rl.trainer.state import TrainState, onpolicy_state


def make_agent(agent: str, env: Environment, gen: torch.Generator,
               net: str = "mlp", device: DeviceLike = None):
    """(params, apply_fn) of the agent; the weights are drawn from the
    CPU generator ``gen`` and placed on ``device``."""
    spec = env.spec
    if agent != "mlp":
        raise not_in_slice(f"--agent {agent}", "HRL training")
    if net == "conv":
        raise not_in_slice("--net conv for ppo/a2c", "pixel")
    if len(spec.obs_shape) != 1:
        raise ValueError(
            f"{spec.name} has obs shape {spec.obs_shape}; use --net conv "
            "for the Q-Conv pixel stem, wrap with "
            "envs.wrappers.flatten_observation for the mlp agent, or use "
            "--agent hrl")
    params = mlp_ac_init(gen, spec.obs_shape[0], head_dim(spec.action_space),
                         device=resolve_device(device))
    return params, mlp_ac_apply


class OnPolicyTrainer(Trainer):
    family = "onpolicy"

    def __init__(self, env_name: str = "cartpole", agent: str = "mlp",
                 iters: int = 40, n_envs: int = 32, rollout_len: int = 128,
                 actor_policy: Optional[str] = "fxp8", lr: float = 3e-3,
                 comm_bits: int = 8, max_lag: int = 1, seed: int = 0,
                 two_stage: bool = False, ckpt_dir: Optional[str] = None,
                 save_every: int = 10, mesh_kind: str = "host",
                 mesh_devices: Optional[int] = None, log_every: int = 5,
                 verbose: bool = True, algo: str = "ppo", net: str = "mlp",
                 frame_stack_k: int = 1, metrics_dir: Optional[str] = None,
                 profile_dir: Optional[str] = None,
                 device: DeviceLike = None):
        if algo not in ON_POLICY_ALGOS:
            if algo in VALUE_ALGOS:
                raise not_in_slice(f"--algo {algo}", "value family")
            raise ValueError(f"rl_train drives the on-policy family "
                             f"{ON_POLICY_ALGOS}; got --algo {algo!r}")
        if net == "conv":
            raise not_in_slice("--net conv for ppo/a2c", "pixel")
        if two_stage:
            if agent != "hrl":
                raise ValueError("--two-stage trains the HRL sub-goal "
                                 "curriculum and requires --agent hrl")
            raise not_in_slice("--two-stage", "HRL training")
        if metrics_dir or profile_dir:
            raise not_in_slice("--metrics-dir/--profile-dir",
                               "observability")
        if net == "mlp" and frame_stack_k > 1:
            raise ValueError("--frame-stack is a pixel-pipeline knob and "
                             "requires --net conv")
        dev = resolve_device(device)
        n_slots = resolve_mesh(mesh_kind, mesh_devices, n_envs, verbose)
        # actors run (max_lag - 1) versions behind the freshest push:
        # lock-step at the default lag 1
        super().__init__(iters=iters, seed=seed, ckpt_dir=ckpt_dir,
                         save_every=save_every, log_every=log_every,
                         verbose=verbose, device=dev, n_slots=n_slots,
                         max_lag=max_lag, fetch_lag=max_lag - 1)
        self.env = build_env(env_name, net, frame_stack_k)
        self.env_name, self.n_envs = env_name, n_envs
        self.algo = algo
        self.rollout_len = rollout_len
        self.dist = distribution_for(self.env.action_space)
        self.head_dim = head_dim(self.env.action_space)
        self._init_params, self.apply_fn = make_agent(
            agent, self.env, torch.Generator().manual_seed(seed), net, dev)
        self.a_policy = get_policy(actor_policy) if actor_policy else None
        self.comm = comm_bits
        self.ocfg = AdamWConfig(weight_decay=0.0, max_grad_norm=0.5)
        # a2c: one pass over the whole batch, no clipping surrogate
        self.pcfg = (PPOConfig() if algo == "ppo"
                     else PPOConfig(epochs=1, minibatches=1))
        self.loss_fn = ppo_loss if algo == "ppo" else a2c_loss
        self.sched = constant(lr)

    # ---- trainer seams ---------------------------------------------------
    def init_state(self) -> TrainState:
        est, obs = init_envs(self.env, self.seed + 1, self.n_envs,
                             self.device)
        return onpolicy_state(self._init_params,
                              adamw_init(self._init_params), est, obs)

    def build_iteration(self):
        return make_onpolicy_iteration(
            self.env, self.apply_fn, self.a_policy, self.dist, self.pcfg,
            self.loss_fn, self.sched, self.ocfg,
            rollout_len=self.rollout_len, n_envs=self.n_envs,
            n_slots=self.n_slots)

    def draws(self, gen: torch.Generator):
        """One iteration's sampling noise and permutations from ``gen``."""
        return draw_iteration(gen, self.dist, self.head_dim,
                              rollout_len=self.rollout_len,
                              n_envs=self.n_envs, epochs=self.pcfg.epochs,
                              device=self.device)

    def pack(self, state):
        return pack_weights(state.params, self.comm)

    def step(self, iteration, state, packed, gen, g, alive):
        params, opt, est, obs, ret, n_ep = iteration(
            state.params, state.opt, state.est, state.obs, packed,
            self.draws(gen), None, alive)
        return onpolicy_state(params, opt, est, obs), ret, n_ep

    def eval_policy(self, params, n_envs: int = 16,
                    n_steps: Optional[int] = None, seed: int = 0):
        """Greedy fp32 evaluation (the reference's: 16 envs for 1.25x
        the horizon)."""
        spec = self.env.spec
        n_steps = n_steps or spec.max_steps + spec.max_steps // 4

        def act(p, o):
            dparams, _ = self.apply_fn(p, o, None)
            return greedy_action(self.dist, dparams)

        return greedy_eval(self.env, act, params, seed + 17, n_envs,
                           n_steps, self.device)

    # ---- checkpoint seams ------------------------------------------------
    def validate_metadata(self, md: dict) -> None:
        md_stage = str(md.get("stage", "all"))
        if md_stage != "all":
            raise ValueError(
                f"checkpoint in {self.ckpt_dir} was saved in stage "
                f"{md_stage!r} but this run's stages are ['all'] — "
                "relaunch with the original --two-stage/--agent flags")

    def metadata(self, it: int) -> dict:
        return {"stage": "all", "stage_iter": it}

    def resume_start(self, md: dict) -> int:
        # the checkpoint holds post-update state for its step: training
        # continues at the next step (re-running the saved one would
        # apply its optimizer update twice)
        it = int(md.get("stage_iter", md.get("step", 0)))
        return min(it + 1, self.iters)

    def resume_message(self, md, state, start: int) -> str:
        it = int(md.get("stage_iter", md.get("step", 0)))
        return f"resumed at global iter {start} (stage all, iter {it} done)"

    def log_line(self, it, ret, n_ep, metrics: dict) -> str:
        return (f"iter {it:4d}  return {float(ret):8.2f}  "
                f"episodes {int(n_ep):4d}  "
                f"sync {metrics['sync_payload_bytes'] / 2**20:.2f} MiB "
                f"(fp32 {metrics['sync_fp32_bytes'] / 2**20:.2f})")


def rl_train(env_name: str = "cartpole", agent: str = "mlp",
             iters: int = 40, n_envs: int = 32, rollout_len: int = 128,
             actor_policy: Optional[str] = "fxp8", lr: float = 3e-3,
             comm_bits: int = 8, max_lag: int = 1, seed: int = 0,
             two_stage: bool = False, ckpt_dir: Optional[str] = None,
             save_every: int = 10, mesh_kind: str = "host",
             mesh_devices: Optional[int] = None, log_every: int = 5,
             verbose: bool = True, algo: str = "ppo", net: str = "mlp",
             frame_stack_k: int = 1, metrics_dir: Optional[str] = None,
             profile_dir: Optional[str] = None, device: DeviceLike = None):
    """On-policy training (the paper's Fig. 2 system) on ``device``
    (default: the card) — see :class:`OnPolicyTrainer`.  Returns
    (params, history)."""
    trainer = OnPolicyTrainer(
        env_name, agent, iters=iters, n_envs=n_envs,
        rollout_len=rollout_len, actor_policy=actor_policy, lr=lr,
        comm_bits=comm_bits, max_lag=max_lag, seed=seed,
        two_stage=two_stage, ckpt_dir=ckpt_dir, save_every=save_every,
        mesh_kind=mesh_kind, mesh_devices=mesh_devices,
        log_every=log_every, verbose=verbose, algo=algo, net=net,
        frame_stack_k=frame_stack_k, metrics_dir=metrics_dir,
        profile_dir=profile_dir, device=device)
    state, history = trainer.train()
    return state.params, history
