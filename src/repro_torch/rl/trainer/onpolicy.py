"""The on-policy trainer (port of ``repro.rl.trainer.onpolicy``: ppo and
a2c with the mlp, conv and hrl agents).

The paper's Fig. 2 system: quantized (fxp8) actors roll the envs from
an int8 weight sync, and the fp32 learner runs PPO (or A2C) on their
trajectories.  On a CUDA device each actor product is the Q-MAC kernel
and each actor conv the Q-Conv kernel; the learner's products and
convolutions are fp32 PyTorch, as the reference's learner runs no
quantized op.  Truncated episodes bootstrap through the timeout.

``--agent hrl`` trains the paper's E2HRL agent (FC-HRL) on the raw
image env; ``--two-stage`` runs its two stages in turn (paper Sec.
III): "action" trains stem, action and value heads with the sub-goal
module's gradients masked to zero, then "subgoal" trains the sub-goal
module alone.  The optimizer state carries across the boundary, as the
reference's does, so in stage "subgoal" the masked subtrees still move
on the Adam moments left from stage "action".  ``--net conv`` trains
the conv actor-critic over the pixel pipeline (running normalization,
then ``--frame-stack``).

``metrics_dir`` writes the ``obs/v1`` telemetry (``env_steps``,
``episodes``, ``return_mean``, ``alive_frac`` from the iteration, the
loop's host metrics and spans), ``profile_dir`` a ``torch.profiler``
trace of ``profile_steps`` steps from ``profile_start``; neither changes
the run.

The actor fleet runs over a device mesh, ``--mesh host`` by default as
in the reference (``mesh_kind``/``mesh_devices``): each rank of the
mesh rolls its slot's envs and the learner runs replicated on every
rank over the gathered trajectory (``train_steps``).  One rank is one
slot; under ``torchrun`` every rank is a slot of the host mesh.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.e2hrl import HRLConfig
from repro_torch.core.policy import get_policy
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import hrl
from repro_torch.obs import MetricSpec
from repro_torch.optim import AdamWConfig, adamw_init, constant
from repro_torch.rl.actor_learner import pack_weights
from repro_torch.rl.dists import distribution_for
from repro_torch.rl.envs import Environment, make
from repro_torch.rl.envs.spaces import head_dim
from repro_torch.rl.inference import (ON_POLICY_ALGOS, VALUE_ALGOS,
                                      build_env)
from repro_torch.rl.nets import (conv_ac_apply, conv_ac_init, mlp_ac_apply,
                                 mlp_ac_init)
from repro_torch.rl.ppo import PPOConfig, a2c_loss, ppo_loss, stage_mask
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
    dev = resolve_device(device)
    if agent == "mlp":
        if net == "conv":
            if len(spec.obs_shape) != 3:
                raise ValueError(
                    f"{spec.name} has obs shape {spec.obs_shape}; "
                    "--net conv needs image (H, W, C) observations")
            return conv_ac_init(gen, spec.obs_shape,
                                head_dim(spec.action_space),
                                device=dev), conv_ac_apply
        if len(spec.obs_shape) != 1:
            raise ValueError(
                f"{spec.name} has obs shape {spec.obs_shape}; use --net "
                "conv for the Q-Conv pixel stem, wrap with "
                "envs.wrappers.flatten_observation for the mlp agent, or "
                "use --agent hrl")
        return mlp_ac_init(gen, spec.obs_shape[0],
                           head_dim(spec.action_space),
                           device=dev), mlp_ac_apply
    if net != "mlp":
        raise ValueError("--net conv selects the standalone conv "
                         "actor-critic; the hrl agent has its own conv "
                         "stem — drop --net")
    if len(spec.obs_shape) != 3:
        raise ValueError(
            f"{spec.name} has obs shape {spec.obs_shape}; the hrl agent "
            "needs image (H, W, C) observations — use --agent mlp")
    cfg = HRLConfig(obs_shape=spec.obs_shape, n_actions=spec.n_actions)

    def apply_fn(p, obs, policy=None):
        logits, value, _ = hrl.apply(p, obs, cfg, policy)
        return logits, value

    return hrl.init(gen, cfg, device=dev), apply_fn


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
                 profile_dir: Optional[str] = None, profile_start: int = 0,
                 profile_steps: int = 1, device: DeviceLike = None):
        if algo not in ON_POLICY_ALGOS:
            raise ValueError(f"rl_train drives the on-policy family "
                             f"{ON_POLICY_ALGOS}; use value_train for "
                             f"{VALUE_ALGOS} (or the --algo CLI "
                             "dispatch)")
        if two_stage and agent != "hrl":
            raise ValueError("--two-stage trains the HRL sub-goal "
                             "curriculum and requires --agent hrl")
        dev = resolve_device(device)
        mesh, n_slots = resolve_mesh(mesh_kind, mesh_devices, n_envs,
                                     verbose, dev)
        # actors run (max_lag - 1) versions behind the freshest push:
        # lock-step at the default lag 1
        super().__init__(iters=iters, seed=seed, ckpt_dir=ckpt_dir,
                         save_every=save_every, log_every=log_every,
                         verbose=verbose, device=dev, mesh=mesh,
                         n_slots=n_slots,
                         max_lag=max_lag, fetch_lag=max_lag - 1,
                         metrics_dir=metrics_dir, profile_dir=profile_dir,
                         profile_start=profile_start,
                         profile_steps=profile_steps)
        if net == "conv":
            self.env = build_env(env_name, net, frame_stack_k)
        else:
            # the mlp/hrl agents keep the raw env view (make_agent
            # validates the obs shape)
            if frame_stack_k > 1:
                raise ValueError("--frame-stack is a pixel-pipeline knob "
                                 "and requires --net conv")
            self.env = make(env_name)
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
        self.stage_list = ["action", "subgoal"] if two_stage else [None]
        self.stage_names = [s or "all" for s in self.stage_list]

    # ---- trainer seams ---------------------------------------------------
    def init_state(self) -> TrainState:
        est, obs = init_envs(self.env, self.seed + 1, self.n_envs,
                             self.device, mesh=self.mesh)
        return onpolicy_state(self._init_params,
                              adamw_init(self._init_params), est, obs)

    def build_iteration(self):
        return make_onpolicy_iteration(
            self.env, self.apply_fn, self.a_policy, self.dist, self.pcfg,
            self.loss_fn, self.sched, self.ocfg,
            rollout_len=self.rollout_len, n_envs=self.n_envs,
            n_slots=self.n_slots, mesh=self.mesh)

    def metric_spec(self) -> MetricSpec:
        return MetricSpec(counters=("env_steps", "episodes"),
                          gauges=("return_mean", "alive_frac"))

    def run_meta(self) -> dict:
        meta = super().run_meta()
        meta.update(algo=self.algo, env=self.env_name, n_envs=self.n_envs,
                    rollout_len=self.rollout_len)
        return meta

    def draws(self, gen: torch.Generator):
        """One iteration's sampling noise and permutations from ``gen``."""
        return draw_iteration(gen, self.dist, self.head_dim,
                              rollout_len=self.rollout_len,
                              n_envs=self.n_envs, epochs=self.pcfg.epochs,
                              device=self.device)

    def pack(self, state):
        return pack_weights(state.params, self.comm)

    def step(self, iteration, state, packed, gen, g, stage_ctx, alive):
        params, opt, est, obs, ret, n_ep = iteration(
            state.params, state.opt, state.est, state.obs, packed,
            self.draws(gen), stage_ctx, alive)
        return onpolicy_state(params, opt, est, obs), ret, n_ep

    def record(self, iteration, mbuf, state, ret, n_ep, g, alive):
        return iteration.record(mbuf, ret, n_ep, alive)

    def stage_setup(self, state, stage):
        # the stage's grad mask; a subtree masked from the first step
        # keeps zero Adam moments and so stays bitwise frozen
        return stage_mask(state.params, stage) if stage else None

    def eval_policy(self, params, n_envs: int = 16,
                    n_steps: Optional[int] = None, seed: int = 0):
        """Greedy fp32 evaluation (the reference's: 16 envs for 1.25x
        the horizon, on the training env stack)."""
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
        if md_stage not in self.stage_names:
            raise ValueError(
                f"checkpoint in {self.ckpt_dir} was saved in stage "
                f"{md_stage!r} but this run's stages are "
                f"{self.stage_names} — relaunch with the original "
                "--two-stage/--agent flags")

    def metadata(self, it: int, stage) -> dict:
        return {"stage": stage or "all", "stage_iter": it}

    def resume_start(self, md: dict) -> int:
        # the checkpoint holds post-update state for its step: training
        # continues at the next step (re-running the saved one would
        # apply its optimizer update twice); the global step is rebuilt
        # from the recorded (stage, stage_iter), so a changed --iters
        # cannot land the resume in the wrong stage, and the clamp moves
        # a stage that already met a shrunken --iters on to the next
        md_stage = str(md.get("stage", "all"))
        it = int(md.get("stage_iter", md.get("step", 0)))
        return (self.stage_names.index(md_stage) * self.iters
                + min(it + 1, self.iters))

    def resume_message(self, md, state, start: int) -> str:
        md_stage = str(md.get("stage", "all"))
        it = int(md.get("stage_iter", md.get("step", 0)))
        return (f"resumed at global iter {start} "
                f"(stage {md_stage}, iter {it} done)")

    def log_line(self, it, ret, n_ep, metrics: dict, stage) -> str:
        sfx = f" [stage={stage}]" if stage else ""
        return (f"iter {it:4d}  return {float(ret):8.2f}  "
                f"episodes {int(n_ep):4d}  "
                f"sync {metrics['sync_payload_bytes'] / 2**20:.2f} MiB "
                f"(fp32 {metrics['sync_fp32_bytes'] / 2**20:.2f}){sfx}")

    def export_state(self, state, state_out) -> None:
        if state_out is not None:
            state_out.update(env_state=state.est, obs=state.obs)


def rl_train(env_name: str = "cartpole", agent: str = "mlp",
             iters: int = 40, n_envs: int = 32, rollout_len: int = 128,
             actor_policy: Optional[str] = "fxp8", lr: float = 3e-3,
             comm_bits: int = 8, max_lag: int = 1, seed: int = 0,
             two_stage: bool = False, ckpt_dir: Optional[str] = None,
             save_every: int = 10, mesh_kind: str = "host",
             mesh_devices: Optional[int] = None, log_every: int = 5,
             verbose: bool = True, algo: str = "ppo", net: str = "mlp",
             frame_stack_k: int = 1, metrics_dir: Optional[str] = None,
             profile_dir: Optional[str] = None, profile_start: int = 0,
             profile_steps: int = 1, device: DeviceLike = None,
             state_out: Optional[dict] = None):
    """On-policy training (the paper's Fig. 2 system) on ``device``
    (default: the card) — see :class:`OnPolicyTrainer`.  Returns
    (params, history); ``state_out`` receives the final env state and
    observations (``env_state``, ``obs``), from which an evaluation can
    freeze the pixel pipeline's normalizer.  A rank the mesh leaves out
    returns (None, [])."""
    trainer = OnPolicyTrainer(
        env_name, agent, iters=iters, n_envs=n_envs,
        rollout_len=rollout_len, actor_policy=actor_policy, lr=lr,
        comm_bits=comm_bits, max_lag=max_lag, seed=seed,
        two_stage=two_stage, ckpt_dir=ckpt_dir, save_every=save_every,
        mesh_kind=mesh_kind, mesh_devices=mesh_devices,
        log_every=log_every, verbose=verbose, algo=algo, net=net,
        frame_stack_k=frame_stack_k, metrics_dir=metrics_dir,
        profile_dir=profile_dir, profile_start=profile_start,
        profile_steps=profile_steps, device=device)
    state, history = trainer.train(state_out=state_out)
    return (None if state is None else state.params), history
