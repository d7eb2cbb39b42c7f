"""Q-Actor actor-learner pieces (port of the single-device parts of
``repro.rl.actor_learner``; the paper's Fig. 2).

Learner: full-precision PPO updates.  Actors: rollouts under a quantized
copy of the policy (FxP8 by default).  The learner sends an int8
payload plus fp32 scales (``pack_weights``), a ~4x cut in wire bytes
measured by ``sync_bytes``.  ``FleetSync`` is the versioned mailbox of
packed weights: the learner pushes, slots fetch at a chosen lag, and
per-slot staleness gives the ``alive`` straggler mask that
``fleet_mask`` turns into the PPO loss's mask.

``collect`` rolls the on-policy fleet, ``collect_value`` the value
family's behaviour actors.  The sharded collection over several cards
(``collect_sharded``) waits for the sharded slice.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quantizer import (dequantize_params, quantize_params,
                                        quantized_nbytes)
from repro_torch.rl.dists import ActionDist
from repro_torch.rl.envs.base import Environment
from repro_torch.rl.rollout import RolloutResult, rollout

Tensor = torch.Tensor


# -- weight sync ------------------------------------------------------------

def pack_weights(params, comm_bits: int):
    """Quantize the param tree for the wire (QTensor leaves)."""
    if comm_bits >= 32:
        return params
    return quantize_params(params, QuantPolicy(w_bits=comm_bits,
                                               per_channel=True))


def unpack_weights(packed):
    return dequantize_params(packed)


def sync_bytes(packed) -> Tuple[int, int]:
    """(payload_bytes, fp32_equivalent_bytes) for one sync."""
    return quantized_nbytes(packed)


# -- the actor fleet ---------------------------------------------------------

class FleetSync:
    """Versioned weight mailbox between the learner and the fleet.

    The learner ``push``es each packed version; slots ``fetch`` with a
    lag (0 = lock-step, 1 = double-buffered).  Each fetch is recorded per
    slot, so ``staleness``/``alive`` come from what the fleet read: a
    slot that stops fetching drops out of ``alive()`` once it is more
    than ``max_lag`` versions behind.  Both are CPU tensors.
    """

    def __init__(self, n_slots: int, max_lag: int = 1, depth: int = 2):
        self.n_slots = max(n_slots, 1)
        self.max_lag = max(max_lag, 1)
        self.depth = max(depth, max_lag + 1, 2)
        self._buf: List = []                      # [(version, packed)]
        self._version = -1
        self._seen = [-1] * self.n_slots

    @property
    def version(self) -> int:
        """Latest published version id (-1 before the first push)."""
        return self._version

    def push(self, packed) -> int:
        self._version += 1
        self._buf.append((self._version, packed))
        if len(self._buf) > self.depth:
            self._buf.pop(0)
        return self._version

    def fetch(self, lag: int = 0, slots: Optional[List[int]] = None):
        """Read the version ``lag`` behind the newest (clamped to the
        oldest retained) and record the read for ``slots`` (default:
        the whole fleet)."""
        idx = max(len(self._buf) - 1 - max(lag, 0), 0)
        version, packed = self._buf[idx]
        for s in (range(self.n_slots) if slots is None else slots):
            self._seen[s] = version
        return packed

    def staleness(self) -> Tensor:
        """Versions behind the newest, per slot: [n_slots] int32."""
        return torch.tensor([self._version - s for s in self._seen],
                            dtype=torch.int32)

    def alive(self) -> Tensor:
        """[n_slots] bool: slots within the staleness budget."""
        return self.staleness() <= self.max_lag


def collect(packed, env: Environment, apply_fn: Callable,
            actor_policy: Optional[QuantPolicy], noise: Tensor, env_state,
            obs: Tensor, n_steps: int,
            dist: Optional[ActionDist] = None) -> RolloutResult:
    """One actor's contribution: dequantize the synced weights, roll
    ``n_steps`` with the sampling draws ``noise``."""
    params = unpack_weights(packed)
    fn = (lambda p, o: apply_fn(p, o, actor_policy))  # noqa: E731
    return rollout(params, env, fn, noise, env_state, obs, n_steps, dist)


def collect_value(packed, env: Environment, behave_fn: Callable,
                  actor_policy: Optional[QuantPolicy], step_draws: Callable,
                  env_state, obs: Tensor, n_steps: int, eps: float):
    """One value-family actor's contribution: dequantize the synced
    weights once, run ``n_steps`` behaviour-policy env steps.
    ``step_draws(t)`` is step ``t``'s exploration draws (what
    ``behave_fn`` takes).  Returns ``((est, obs), (O, A, R, D, Tr,
    FO))`` with time-major [T, B, ...] trajectory leaves."""
    actor_params = unpack_weights(packed)
    steps = []
    with torch.no_grad():
        for t in range(n_steps):
            a = behave_fn(actor_params, obs, step_draws(t), eps,
                          actor_policy)
            env_state, nxt, r, d, tr, fo = env.step(env_state, a)
            steps.append((obs, a, r, d, tr, fo))
            obs = nxt
    traj = tuple(torch.stack(xs) for xs in zip(*steps, strict=True))
    return (env_state, obs), traj


def fleet_mask(alive: Tensor, envs_per_slot: int) -> Tensor:
    """Env-level float mask [n_slots * envs_per_slot] from a per-slot
    liveness vector."""
    return torch.repeat_interleave(alive.to(torch.float32), envs_per_slot)
