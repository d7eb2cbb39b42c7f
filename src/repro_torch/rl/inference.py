"""The shared policy-inference path: env stack, net reconstruction and
action heads (port of ``repro.rl.inference``).

Evaluation and the batched server act through the same objects here —
:func:`build_env` for the observation stack, :func:`make_value_agent`
for the net, ``ValueAgent.greedy``/``sampled`` for the heads — so a
served policy cannot drift from what evaluation measures: the server
calls the one greedy forward with packed ``QTensor`` weights, evaluation
with fp32 weights under the same quant policy.

The port serves ``dqn`` over ``--net conv`` and trains ``ppo``/``a2c``
(``rl/trainer``); the value algos' training and serving of other nets,
and the envs still to port, raise ``NotImplementedError`` naming the
slice that brings them.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.rl.envs import Discrete, Environment, make
from repro_torch.rl.envs.wrappers import (NormStats, ensure_vector_obs,
                                          pixel_pipeline)
from repro_torch.rl.nets import conv_q_apply, conv_q_init

ON_POLICY_ALGOS = ("ppo", "a2c")
VALUE_ALGOS = ("dqn", "qrdqn", "ddpg")
NETS = ("mlp", "conv")
# the reference's envs the port does not have yet, by the slice that
# brings them
LATER_ENVS = {"acrobot": "classic-control envs",
              "mountain_car": "classic-control envs",
              "pendulum": "classic-control envs"}


def not_in_slice(what: str, slice_name: str) -> NotImplementedError:
    """The error an unported option raises, naming the slice that
    brings it."""
    return NotImplementedError(
        f"{what} is not ported yet: it arrives with the {slice_name} "
        "slice of the PyTorch port (the port serves dqn over --net conv "
        "and trains ppo/a2c: the mlp agent on cartpole, the E2HRL agent "
        "with --two-stage on keydoor/catch, --net conv on the pixel "
        "envs)")


def make_env(env_name: str) -> Environment:
    """The raw registered env; an env still to port raises naming the
    slice that brings it."""
    if env_name in LATER_ENVS:
        raise not_in_slice(f"--env {env_name}", LATER_ENVS[env_name])
    return make(env_name)


def build_env(env_name: str, net: str = "mlp", frame_stack_k: int = 1,
              norm_stats: Optional[NormStats] = None) -> Environment:
    """The launch-path env stack: for ``net="conv"`` the pixel pipeline
    (running, or with ``norm_stats`` frozen, normalization of raw frames,
    then ``frame_stack``); ``net="mlp"`` keeps the vector view (images
    are flattened) and ``--frame-stack`` is a conv-net knob."""
    if net not in NETS:
        raise ValueError(f"unknown net {net!r} (expected one of {NETS})")
    env = make_env(env_name)
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


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    """The fields of the reference's ``repro.rl.value.DQNConfig`` that
    ``make_value_agent`` sets, with the reference's defaults."""

    eps_decay_steps: int = 2_000
    n_step: int = 1
    learn_start: int = 256           # min replay size before updates


@dataclasses.dataclass
class ValueAgent:
    """Nets + greedy/sampled action heads for one value-based algo."""

    algo: str
    cfg: object
    params: object
    qvals: Callable                       # (p, obs, policy) -> [B, A]

    def behaviour_subtree(self, params):
        """The weights a deployment serves (the whole Q net for dqn)."""
        return params

    def from_behaviour(self, behaviour_params):
        """Inverse of :meth:`behaviour_subtree`."""
        return behaviour_params

    def greedy(self, params, obs: torch.Tensor, policy=None) -> torch.Tensor:
        return torch.argmax(self.qvals(params, obs, policy), dim=-1)

    def sampled(self, params, obs: torch.Tensor, gen: torch.Generator,
                temperature: float = 1.0, policy=None) -> torch.Tensor:
        """Boltzmann exploration over the Q values; ``gen`` must live on
        the observations' device.  ``temperature -> 0`` is greedy."""
        t = max(float(temperature), 1e-6)
        probs = torch.softmax(
            self.qvals(params, obs, policy).to(torch.float32) / t, dim=-1)
        return torch.multinomial(probs, 1, generator=gen).squeeze(-1)


def make_value_agent(algo: str, spec, gen: Optional[torch.Generator] = None,
                     n_step: int = 3, eps_decay_steps: int = 2_000,
                     learn_start: Optional[int] = None, net: str = "mlp",
                     device: DeviceLike = None) -> ValueAgent:
    """Build the net and heads for one value algo.  ``gen=None`` skips
    the parameter init (``agent.params`` is None); otherwise the weights
    are drawn from the CPU generator ``gen`` and placed on ``device``
    (default: the card)."""
    if net not in NETS:
        raise ValueError(f"unknown net {net!r} (expected one of {NETS})")
    if algo not in VALUE_ALGOS:
        raise ValueError(f"unknown value algo {algo!r} "
                         f"(expected one of {VALUE_ALGOS})")
    if algo != "dqn":
        raise not_in_slice(f"--algo {algo}", "value family")
    if net != "conv":
        raise not_in_slice(f"--algo {algo} --net mlp", "value family")
    if len(spec.obs_shape) != 3:
        raise ValueError(f"--net conv needs image (H, W, C) "
                         f"observations; {spec.name} has shape "
                         f"{spec.obs_shape}")
    if not isinstance(spec.action_space, Discrete):
        raise ValueError(f"--algo {algo} needs a Discrete action space; "
                         f"{spec.name} is continuous — use --algo ddpg")
    cfg = DQNConfig(n_step=n_step, eps_decay_steps=eps_decay_steps)
    if learn_start is not None:
        cfg = dataclasses.replace(cfg, learn_start=learn_start)
    params = None
    if gen is not None:
        params = conv_q_init(gen, spec.obs_shape, spec.n_actions,
                             device=resolve_device(device))
    return ValueAgent(algo, cfg, params, qvals=conv_q_apply)
