"""Checkpoint -> servable policy, with no training machinery (port of
``repro.serve.loader``).

``load_policy`` reads a value-RL checkpoint (from either package) of
any algo and net ``value_train`` writes (dqn, qrdqn, ddpg with or
without TQC's quantile critics; mlp and conv), validates the run flags
against the sidecar metadata before any array is read (a mismatch names
the flag), rebuilds the net through
:func:`repro_torch.rl.inference.make_value_agent` (``tqc_drop`` from the
metadata, so a TQC checkpoint's critics have their shapes), and
restores only the params (position 0 of the saved ``(params, target,
opt, replay, env_state, obs)`` tuple) and, for conv, the env state at
position 4, whose Welford carry is merged and frozen for serving.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.policy import QuantPolicy, get_policy
from repro_torch.core.quantizer import quantize_params
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.rl.envs.wrappers import (NormStats, merge_norm_stats,
                                          norm_stats_of)
from repro_torch.rl.inference import (NETS, VALUE_ALGOS, ValueAgent,
                                      build_env, make_value_agent)
from repro_torch.rl.rollout import init_envs
from repro_torch.tree import tree_leaves

# serving precision points: (weight pack bits, apply-policy preset).
# "w8" matches evaluation's fxp8 grid bit for bit; "w4" is the int4 sweep
PRECISIONS = {
    "fp32": (None, None),
    "w8": (8, "fxp8"),
    "w4": (4, "w4a8"),
}


def _mismatch(ckpt_dir: str, flag: str, saved, asked) -> ValueError:
    return ValueError(
        f"checkpoint in {ckpt_dir} was saved by --{flag} {saved!r}, "
        f"not {asked!r} — serve with the checkpoint's own flags "
        f"(or omit --{flag} to take it from the metadata)")


@dataclasses.dataclass
class ServedPolicy:
    """Everything serving needs: the restored fp32 params, the net's
    heads and the frozen evaluation env."""

    algo: str
    net: str
    env_name: str
    frame_stack: int
    step: int
    metadata: Dict
    agent: ValueAgent
    params: object
    env: object
    device: torch.device
    norm_stats: Optional[NormStats] = None

    @classmethod
    def from_agent(cls, agent: ValueAgent, env_name: str, net: str = "mlp",
                   frame_stack: int = 1,
                   norm_stats: Optional[NormStats] = None) -> "ServedPolicy":
        """Wrap an in-process agent (``agent.params`` initialized) as a
        servable policy on its params' device, for code that measures
        the serving machinery where no checkpoint exists."""
        if agent.params is None:
            raise ValueError("from_agent needs initialized params "
                             "(make_value_agent with a generator)")
        env = build_env(env_name, net, frame_stack, norm_stats=norm_stats)
        return cls(algo=agent.algo, net=net, env_name=env_name,
                   frame_stack=frame_stack, step=0, metadata={},
                   agent=agent, params=agent.params, env=env,
                   device=tree_leaves(agent.params)[0].device,
                   norm_stats=norm_stats)

    def behaviour_params(self):
        """The served subtree: the Q net, or the bare ddpg actor."""
        return self.agent.behaviour_subtree(self.params)

    def pack(self, precision: str = "w8"):
        """(packed behaviour subtree, apply QuantPolicy | None): ``w8``/
        ``w4`` replace the weights with per-channel QTensors and pick the
        apply policy whose activation grid matches evaluation."""
        if precision not in PRECISIONS:
            raise ValueError(f"unknown serving precision {precision!r} "
                             f"(expected one of {sorted(PRECISIONS)})")
        bits, pol_name = PRECISIONS[precision]
        bp = self.behaviour_params()
        if bits is None:
            return bp, None
        packed = quantize_params(
            bp, QuantPolicy(name=f"w{bits}", w_bits=bits, per_channel=True))
        return packed, get_policy(pol_name)


def load_policy(ckpt_dir: str, algo: Optional[str] = None,
                net: Optional[str] = None, env_name: Optional[str] = None,
                step: Optional[int] = None,
                device: DeviceLike = None) -> ServedPolicy:
    """Rebuild a servable policy from a value-RL checkpoint on ``device``
    (default: the card).  ``algo``/``net``/``env_name`` are cross-checks
    against the metadata; a disagreement raises naming the flag."""
    dev = resolve_device(device)
    mgr = CheckpointManager(ckpt_dir)
    step = step if step is not None else mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    md = mgr.metadata(step)

    def pick(flag: str, asked, default=None):
        saved = md.get(flag, None)
        if saved is None:
            if asked is None and default is None:
                raise ValueError(
                    f"checkpoint in {ckpt_dir} predates '{flag}' "
                    f"metadata — pass --{flag} explicitly")
            return asked if asked is not None else default
        saved = str(saved)
        if asked is not None and str(asked) != saved:
            raise _mismatch(ckpt_dir, flag, saved, asked)
        return saved

    algo = pick("algo", algo)
    net = pick("net", net, default="mlp")
    env_name = pick("env", env_name)
    if algo not in VALUE_ALGOS:
        raise ValueError(f"checkpoint in {ckpt_dir} holds --algo "
                         f"{algo!r}; serving drives the value family "
                         f"{VALUE_ALGOS}")
    if net not in NETS:
        raise ValueError(f"checkpoint in {ckpt_dir} holds --net "
                         f"{net!r} (expected one of {NETS})")
    frame_stack = int(md.get("frame_stack", 1))
    tqc_drop = int(md.get("tqc_drop", 0))

    # template: the same net and env stack as training, so the template's
    # paths name the saved leaves (shapes come from the file)
    train_env = build_env(env_name, net, frame_stack)
    agent = make_value_agent(algo, train_env.spec,
                             gen=torch.Generator().manual_seed(0), net=net,
                             tqc_drop=tqc_drop, device=dev)
    # conv checkpoints carry the Welford normalizer in the env state:
    # restored beside the params, its merged stats frozen for serving (a
    # None in the template is a subtree left in the file)
    est = None
    if net == "conv":
        est, _ = init_envs(train_env, 0, int(md.get("n_envs", 1)), dev)
    (params, _, _, _, est, _), md = mgr.restore(
        (agent.params, None, None, None, est, None), step=step, device=dev)
    norm_stats = (merge_norm_stats(norm_stats_of(est)) if net == "conv"
                  else None)
    env = build_env(env_name, net, frame_stack, norm_stats=norm_stats)
    agent.params = params
    return ServedPolicy(algo=algo, net=net, env_name=env_name,
                        frame_stack=frame_stack, step=int(step),
                        metadata=dict(md), agent=agent, params=params,
                        env=env, device=dev, norm_stats=norm_stats)
