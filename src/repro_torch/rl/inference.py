"""The shared policy-inference path: env stack, net reconstruction and
action heads (port of ``repro.rl.inference``).

Training (``value_train``), evaluation (``value_eval``) and the batched
server act through the same objects here — :func:`build_env` for the
observation stack, :func:`make_value_agent` for the nets,
``ValueAgent.behave``/``greedy``/``sampled`` for the heads — so a
served policy cannot drift from what evaluation measures: the server
calls the one greedy forward with packed ``QTensor`` weights, evaluation
with fp32 weights under the same quant policy.

The port trains ppo/a2c and dqn/qrdqn/ddpg on one device, with
telemetry, and serves every value checkpoint; several devices, still to
port, raise ``NotImplementedError`` naming the slice that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.rl.envs import Discrete, Environment, make
from repro_torch.rl.envs.wrappers import (NormStats, ensure_vector_obs,
                                          pixel_pipeline)
from repro_torch.rl.nets import (conv_q_apply, conv_q_init, conv_qr_apply,
                                 conv_qr_init, mlp_pi_apply, mlp_pi_init,
                                 mlp_q_apply, mlp_q_init, mlp_qr_apply,
                                 mlp_qr_init, mlp_twin_q_apply,
                                 mlp_twin_q_init, mlp_twin_qr_apply,
                                 mlp_twin_qr_init)
from repro_torch.rl.value import (DDPGConfig, DQNConfig, QRDQNConfig,
                                  dqn_loss_td, egreedy, qrdqn_loss_td)

ON_POLICY_ALGOS = ("ppo", "a2c")
VALUE_ALGOS = ("dqn", "qrdqn", "ddpg")
NETS = ("mlp", "conv")


def not_in_slice(what: str, slice_name: str) -> NotImplementedError:
    """The error an unported option raises, naming the slice that
    brings it."""
    return NotImplementedError(
        f"{what} is not ported yet: it arrives with the {slice_name} "
        "slice of the PyTorch port (the port trains ppo/a2c — the mlp "
        "agent, the E2HRL agent with --two-stage, --net conv on the "
        "pixel envs — and dqn/qrdqn/ddpg with uniform or prioritized "
        "replay on one device, over every env, with telemetry and "
        "profiler windows, and serves every value checkpoint)")


def build_env(env_name: str, net: str = "mlp", frame_stack_k: int = 1,
              norm_stats: Optional[NormStats] = None) -> Environment:
    """The launch-path env stack: for ``net="conv"`` the pixel pipeline
    (running, or with ``norm_stats`` frozen, normalization of raw frames,
    then ``frame_stack``); ``net="mlp"`` keeps the vector view (images
    are flattened) and ``--frame-stack`` is a conv-net knob."""
    if net not in NETS:
        raise ValueError(f"unknown net {net!r} (expected one of {NETS})")
    env = make(env_name)
    if net == "conv":
        if len(env.obs_shape) != 3:
            raise ValueError(
                f"--net conv needs image (H, W, C) observations; "
                f"{env_name} has shape {env.obs_shape} — use --net mlp")
        return pixel_pipeline(env, frame_stack_k, stats=norm_stats)
    if frame_stack_k > 1:
        raise ValueError("--frame-stack is a pixel-pipeline knob and "
                         "requires --net conv")
    return ensure_vector_obs(env)


@dataclasses.dataclass
class ValueAgent:
    """Nets + behaviour/greedy/sampled heads for one value-based algo.

    ``behave`` is the quantized exploration policy the actor fleet runs
    (ε-greedy over Q, or the deterministic actor plus Gaussian noise),
    its draws an input; ``greedy`` is the same policy with exploration
    off (evaluation and greedy serving); ``sampled`` is the stochastic
    serving head (Boltzmann over Q for Discrete, bounded Gaussian noise
    for Box).
    """

    algo: str
    cfg: object
    params: object
    discrete: bool
    qvals: Optional[Callable] = None      # (p, obs, policy) -> [B, A]
    act: Optional[Callable] = None        # (p, obs, policy) -> [B, d]
    q_apply: Optional[Callable] = None    # raw apply for the loss
    critic_apply: Optional[Callable] = None
    loss_fn: Optional[Callable] = None

    def behave(self, behaviour_params, obs: torch.Tensor, draws, eps: float,
               policy) -> torch.Tensor:
        """``behaviour_params`` is the synced subtree only: the Q net, or
        the bare actor (ddpg).  ``draws`` is one step's: ``(random
        actions [B], uniforms [B])`` for ε-greedy, standard normals
        [B, d] for the actor's exploration noise."""
        if self.discrete:
            rand, u = draws
            return egreedy(self.qvals(behaviour_params, obs, policy), eps,
                           rand, u)
        a = self.act(behaviour_params, obs, policy)
        noise = (draws.to(a.device) * self.cfg.explore_noise
                 * self.cfg.half_range)
        return torch.clamp(a + noise, self.cfg.low, self.cfg.high)

    def behaviour_subtree(self, params):
        """The weights the learner syncs to the fleet, and exactly the
        subtree a deployment serves (ddpg: the actor alone)."""
        return params["actor"] if self.algo == "ddpg" else params

    def from_behaviour(self, behaviour_params):
        """Inverse of :meth:`behaviour_subtree`."""
        if self.algo == "ddpg":
            return {"actor": behaviour_params}
        return behaviour_params

    def greedy(self, params, obs: torch.Tensor, policy=None) -> torch.Tensor:
        if self.discrete:
            return torch.argmax(self.qvals(params, obs, policy), dim=-1)
        return self.act(params["actor"], obs, policy)

    def sampled(self, params, obs: torch.Tensor, gen: torch.Generator,
                temperature: float = 1.0, policy=None) -> torch.Tensor:
        """Boltzmann exploration over the Q values (Discrete) or the
        greedy action plus Gaussian noise of ``temperature`` x the half
        range, clipped to the bounds (Box); ``gen`` lives on the
        observations' device.  ``temperature -> 0`` is greedy."""
        t = max(float(temperature), 1e-6)
        if self.discrete:
            probs = torch.softmax(
                self.qvals(params, obs, policy).to(torch.float32) / t,
                dim=-1)
            return torch.multinomial(probs, 1, generator=gen).squeeze(-1)
        a = self.act(params["actor"], obs, policy)
        noise = torch.randn(a.shape, generator=gen, device=a.device) \
            * t * self.cfg.half_range
        return torch.clamp(a + noise, self.cfg.low, self.cfg.high)


def make_value_agent(algo: str, spec, gen: Optional[torch.Generator] = None,
                     n_step: int = 3, eps_decay_steps: int = 2_000,
                     learn_start: Optional[int] = None, net: str = "mlp",
                     tqc_drop: int = 0,
                     device: DeviceLike = None) -> ValueAgent:
    """Build the nets and heads for one value algo.  ``gen=None`` skips
    the parameter init (``agent.params`` is None); otherwise the weights
    are drawn from the CPU generator ``gen`` and placed on ``device``
    (default: the card).  ``net="conv"`` selects the Q-Conv pixel nets
    (dqn/qrdqn).  ``tqc_drop > 0`` (ddpg) switches the twin critics to
    25-quantile heads and truncates the top ``tqc_drop`` pooled target
    quantiles; otherwise the critics are scalar."""
    def tune(cfg):
        if learn_start is None:
            return cfg
        return dataclasses.replace(cfg, learn_start=learn_start)

    if net not in NETS:
        raise ValueError(f"unknown net {net!r} (expected one of {NETS})")
    conv = net == "conv"
    if conv and len(spec.obs_shape) != 3:
        raise ValueError(f"--net conv needs image (H, W, C) "
                         f"observations; {spec.name} has shape "
                         f"{spec.obs_shape}")
    if not conv and len(spec.obs_shape) != 1:
        raise ValueError(
            f"{spec.name} has obs shape {spec.obs_shape}; use "
            "--net conv for pixel envs (the mlp value nets need flat "
            "observations)")
    obs_dim = spec.obs_shape[0] if not conv else None
    discrete = isinstance(spec.action_space, Discrete)
    if algo in ("dqn", "qrdqn") and not discrete:
        raise ValueError(f"--algo {algo} needs a Discrete action space; "
                         f"{spec.name} is continuous — use --algo ddpg")
    if algo == "ddpg" and discrete:
        raise ValueError(f"--algo ddpg needs a Box action space; "
                         f"{spec.name} is discrete — use dqn/qrdqn")
    if algo == "ddpg" and conv:
        raise ValueError("--net conv drives the discrete Q family "
                         "(dqn/qrdqn); ddpg has no pixel actor-critic")
    if tqc_drop and algo != "ddpg":
        raise ValueError("--tqc-drop truncates the DDPG critic targets; "
                         f"--algo {algo} has no twin critics")
    dev = resolve_device(device) if gen is not None else None

    if algo == "qrdqn":
        cfg = tune(QRDQNConfig(n_step=n_step,
                               eps_decay_steps=eps_decay_steps))
        params = None
        if gen is not None and conv:
            params = conv_qr_init(gen, spec.obs_shape, spec.n_actions,
                                  cfg.n_quantiles, device=dev)
        elif gen is not None:
            params = mlp_qr_init(gen, obs_dim, spec.n_actions,
                                 cfg.n_quantiles, device=dev)
        qr_apply = conv_qr_apply if conv else mlp_qr_apply

        def q_apply(p, o, pol=None):
            return qr_apply(p, o, spec.n_actions, cfg.n_quantiles, pol)

        return ValueAgent(algo, cfg, params, True,
                          qvals=lambda p, o, pol=None:
                              q_apply(p, o, pol).mean(-1),
                          q_apply=q_apply, loss_fn=qrdqn_loss_td)
    if algo == "dqn":
        cfg = tune(DQNConfig(n_step=n_step,
                             eps_decay_steps=eps_decay_steps))
        params = None
        if gen is not None and conv:
            params = conv_q_init(gen, spec.obs_shape, spec.n_actions,
                                 device=dev)
        elif gen is not None:
            params = mlp_q_init(gen, obs_dim, spec.n_actions, device=dev)
        q_fn = conv_q_apply if conv else mlp_q_apply
        return ValueAgent(algo, cfg, params, True, qvals=q_fn,
                          q_apply=q_fn, loss_fn=dqn_loss_td)
    if algo != "ddpg":
        raise ValueError(f"unknown value algo {algo!r} "
                         f"(expected one of {VALUE_ALGOS})")
    space = spec.action_space
    if not space.bounded:
        raise ValueError("ddpg needs finite Box action bounds")
    act_dim = space.shape[0]
    # truncation needs a return distribution to prune; the default
    # stays the scalar TD3 min-backup
    critic_quantiles = 25 if tqc_drop > 0 else 1
    cfg = tune(DDPGConfig(low=space.low, high=space.high, n_step=n_step,
                          critic_quantiles=critic_quantiles,
                          tqc_drop=tqc_drop))
    quantile = cfg.critic_quantiles > 1
    params = None
    if gen is not None:
        actor = mlp_pi_init(gen, obs_dim, act_dim, device=dev)
        critic = (mlp_twin_qr_init(gen, obs_dim, act_dim,
                                   cfg.critic_quantiles, device=dev)
                  if quantile else
                  mlp_twin_q_init(gen, obs_dim, act_dim, device=dev))
        params = {"actor": actor, "critic": critic}
    twin_apply = mlp_twin_qr_apply if quantile else mlp_twin_q_apply
    return ValueAgent(
        algo, cfg, params, False,
        act=lambda p, o, pol=None: mlp_pi_apply(p, o, cfg.low, cfg.high,
                                                pol),
        critic_apply=lambda p, o, a, pol=None: twin_apply(p, o, a, pol))
