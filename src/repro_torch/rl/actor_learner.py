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
family's behaviour actors.  On a mesh, ``collect_sharded`` and
``collect_value_sharded`` run the fleet over the mesh's data slots: the
packed weights are broadcast (every rank holds them), each slot
dequantizes them and rolls its rows of the global envs with its rows of
the iteration's global draws, and the trajectories come back gathered
in slot order, so every rank holds the global trajectory.  The draws
are global (every rank draws them from the same generator) and sliced
by slot (``slot_keys``/``slot_key``), so a collect at N slots is bitwise
the collect at one.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import torch

from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quantizer import (dequantize_params, quantize_params,
                                        quantized_nbytes)
from repro_torch.distributed.sharding import (data_axes, data_axis_size,
                                              shard_map, slot_index)
from repro_torch.rl.dists import ActionDist, distribution_for
from repro_torch.rl.envs.base import Environment
from repro_torch.rl.rollout import RolloutResult, rollout
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class ActorLearnerConfig:
    n_actors: int = 4
    envs_per_actor: int = 16
    rollout_len: int = 64
    comm_bits: int = 8           # learner->actor payload precision
    max_lag: int = 1             # staleness window (versions)


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


def merge_results(results: List[RolloutResult],
                  alive: Tensor) -> Tuple[RolloutResult, Tensor]:
    """Stack per-actor results along the env axis: (merged, env-level
    mask [n_actors * B]) for the masked PPO loss.  ``alive`` [n_actors]
    bool marks a straggler False: its batch is present but masked to
    zero weight.  The env-state leaves concatenate along the env axis,
    so the merged ``final_env``/``final_obs`` resume collection."""
    def cat(dim):
        return lambda *xs: torch.cat(xs, dim=dim)

    traj = _zip_map(cat(1), [r.traj for r in results])
    last_value = torch.cat([r.last_value for r in results])
    final_env = _zip_map(cat(0), [r.final_env for r in results])
    n_envs = results[0].last_value.shape[0]
    mask = fleet_mask(alive, n_envs)
    merged = RolloutResult(traj, last_value, final_env,
                           torch.cat([r.final_obs for r in results]))
    return merged, mask


def _zip_map(fn: Callable, trees: list):
    """``fn`` over the matching leaves of trees of one structure."""
    columns = zip(*(tree_leaves(t) for t in trees), strict=True)
    return tree_unflatten(trees[0], [fn(*c) for c in columns])


# -- sharded execution on a device mesh --------------------------------------

def _check_fleet(mesh, n_envs: int) -> int:
    """The fleet's slot count; the reference's errors for a mesh without
    data axes and for envs that do not divide over the slots."""
    if not data_axes(mesh):
        raise ValueError(f"mesh {mesh.mesh_dim_names} has no data axes to "
                         "shard the actor fleet over")
    n_slots = data_axis_size(mesh)
    if n_envs % n_slots != 0:
        shape = dict(zip(mesh.mesh_dim_names, tuple(mesh.mesh.shape),
                         strict=True))
        raise ValueError(
            f"n_envs={n_envs} does not divide evenly over the mesh's "
            f"{n_slots} data slot(s) ({shape})")
    return n_slots


def slot_keys(draws, n_slots: int, dim: int = 0) -> list:
    """Every slot's share of the iteration's global draws: the rows of
    each leaf along ``dim`` (the env or batch axis), split evenly over
    ``n_slots`` in slot order.  At one slot the share is the whole."""
    return [slot_key(draws, d, n_slots, dim) for d in range(n_slots)]


def slot_key(draws, idx: int, n_slots: int, dim: int = 0):
    """Slot ``idx``'s share of the global draws (``slot_keys(...)[idx]``)."""
    def take(t):
        per = t.shape[dim] // n_slots
        return t.narrow(dim, idx * per, per)

    return tree_map(take, draws)


def collect_sharded(packed, env: Environment, apply_fn: Callable,
                    actor_policy: Optional[QuantPolicy], noise: Tensor,
                    env_state, obs: Tensor, n_steps: int, mesh,
                    dist: Optional[ActionDist] = None) -> RolloutResult:
    """The actor fleet over the mesh's data axes.  Global [B, ...]
    ``env_state``/``obs`` and the global draws ``noise`` [T, B, ...] in;
    slot ``d`` rolls envs ``[d*B/n, (d+1)*B/n)`` with its columns of
    ``noise``; one global ``RolloutResult`` out, gathered in slot order
    on every rank."""
    _check_fleet(mesh, obs.shape[0])
    if dist is None:
        dist = distribution_for(env.action_space)

    def body(noise, est, obs):
        return collect(packed, env, apply_fn, actor_policy, noise, est,
                       obs, n_steps, dist)

    fn = shard_map(body, mesh, in_specs=(1, 0, 0),
                   out_specs=RolloutResult(traj=1, last_value=0,
                                           final_env=0, final_obs=0))
    return fn(noise, env_state, obs)


def collect_value_sharded(packed, env: Environment, behave_fn: Callable,
                          actor_policy: Optional[QuantPolicy],
                          step_draws: Callable, env_state, obs: Tensor,
                          n_steps: int, eps: float, mesh):
    """The value-family fleet over the mesh's data axes: slot ``d``
    rolls its envs with its rows of each step's global draws
    (``step_draws(t)``); the ``((est, obs), (O, A, R, D, Tr, FO))`` out
    are global, gathered in slot order on every rank."""
    n_slots = _check_fleet(mesh, obs.shape[0])
    d = slot_index(mesh)

    def body(est, obs):
        return collect_value(packed, env, behave_fn, actor_policy,
                             lambda t: slot_key(step_draws(t), d, n_slots),
                             est, obs, n_steps, eps)

    fn = shard_map(body, mesh, in_specs=(0, 0),
                   out_specs=((0, 0), (1,) * 6))
    return fn(env_state, obs)
