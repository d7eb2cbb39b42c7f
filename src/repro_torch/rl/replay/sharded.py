"""Sharded replay: per-slot local buffers, stratified global sampling
(port of ``repro.rl.replay.sharded``).

Every leaf of the one-device state gains a leading ``[n_slots]`` axis:
slot ``d`` is device ``d``'s local circular buffer (and, under PER, its
local sum tree) of capacity ``capacity // n_slots``.  Collection writes
each slot's transitions into its own buffer; sampling is stratified by
slot: each slot draws ``n // n_slots`` transitions from its own buffer,
and together they form the global batch.

The importance weights are where the global view re-enters: a draw
lands on slot ``d``'s item ``i`` with probability ``p_local(i) /
n_slots``, so the PER correction uses that probability with the global
size ``N = sum_d size_d`` and normalizes by the global batch max.
:func:`per_global_weights` and :func:`normalize_weights` are shared by
this host-side facade and by the sharded learner
(:func:`repro_torch.rl.train_steps.make_sharded_value_iteration`), where
each rank holds one slot and the slot-ordered gathers give the global
size and max.

The facade is slot-major and runs every slot in one process, so it
needs no ranks.  Its draws come in as the global ``[n]`` draws, which
:func:`~repro_torch.rl.actor_learner.slot_keys` splits in slot order:
slot indices in each slot's ``[0, size_d)`` (uniform) or stratification
uniforms (PER).  At ``n_slots=1`` every formula is the one-device
backend's exactly (``x / 1.0`` is exact), so a one-slot run reproduces
the unsharded one bit for bit.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.fxp import div_scalar
from repro_torch.rl.actor_learner import slot_keys
from repro_torch.rl.replay.base import ReplayBuffer, make_replay, replay_size
from repro_torch.rl.replay.uniform import check_min_size
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Tensor = torch.Tensor


def per_global_weights(probs_local: Tensor, size_global, beta,
                       n_slots: int) -> Tensor:
    """Unnormalized IS weights for stratified-by-slot PER sampling:
    ``(N * probs_local / n_slots) ** -beta`` with ``N`` the global size;
    the caller normalizes by the global batch max
    (:func:`normalize_weights`)."""
    N = torch.clamp_min(torch.as_tensor(size_global), 1).to(
        device=probs_local.device, dtype=torch.float32)
    return torch.pow(N * div_scalar(probs_local, float(n_slots)), -beta)


def normalize_weights(w: Tensor, w_max: Tensor) -> Tensor:
    """Max-normalize, so the effective learning rate only ever shrinks."""
    return w / torch.clamp_min(w_max, 1e-12)


def _stack(trees):
    columns = zip(*(tree_leaves(t) for t in trees), strict=True)
    return tree_unflatten(trees[0], [torch.stack(c) for c in columns])


def _slot(state, d: int):
    return tree_map(lambda x: x[d], state)


def slot_capacity(capacity: int, n_slots: int) -> int:
    """Each of ``n_slots`` local buffers' capacity, ``capacity //
    n_slots``; raises unless ``capacity`` divides evenly over them."""
    if n_slots < 1:
        raise ValueError(f"n_slots must be >= 1, got {n_slots}")
    if capacity % n_slots != 0:
        raise ValueError(
            f"replay capacity {capacity} does not divide evenly over "
            f"{n_slots} slot(s); round it to a multiple of the mesh "
            "size (--replay-capacity)")
    return capacity // n_slots


def make_sharded_replay(kind: str, n_slots: int, capacity: int, obs_shape,
                        action_shape: Tuple[int, ...] = (),
                        action_dtype=torch.int32, *, alpha: float = 0.6,
                        device="cpu") -> ReplayBuffer:
    """The sharded facade: ``n_slots`` local buffers of capacity
    ``capacity // n_slots`` behind the ``ReplayBuffer`` protocol, with
    slot-major [n_slots, ...] state and batches.  ``add`` takes
    slot-major transitions [n_slots, B_local, ...]; ``sample`` takes the
    global draws ``[n]`` and returns slot-major [n_slots, n // n_slots]
    columns with globally corrected weights; ``update`` writes the
    priorities back slot by slot."""
    local = make_replay(kind, slot_capacity(capacity, n_slots), obs_shape,
                        action_shape, action_dtype, alpha=alpha,
                        device=device)

    def init():
        return _stack([local.init() for _ in range(n_slots)])

    def add(state, obs, action, reward, next_obs, discount):
        return _stack([local.add(_slot(state, d), obs[d], action[d],
                                 reward[d], next_obs[d], discount[d])
                       for d in range(n_slots)])

    def sample(state, draws: Tensor, min_size: int = 1, beta=1.0,
               masked: bool = False):
        n = draws.shape[0]
        if n % n_slots != 0:
            raise ValueError(
                f"batch size {n} does not divide evenly over "
                f"{n_slots} replay slot(s)")
        size_g = replay_size(state)
        # global underfill semantics: learn_start counts total
        # collected transitions, not per-slot fill
        ok = check_min_size(size_g, max(int(min_size), 1), masked)
        batch = _stack([local.sample(_slot(state, d), k, min_size=1,
                                     beta=beta, masked=True)
                        for d, k in enumerate(slot_keys(draws, n_slots))])
        if local.prioritized:
            w = per_global_weights(batch["probs"], size_g, beta, n_slots)
            w = normalize_weights(w, w.max())
            batch["weight"] = w * ok
        else:
            batch["weight"] = ok.expand(batch["weight"].shape)
        return batch

    def update(state, indices, td_abs):
        return _stack([local.update(_slot(state, d), indices[d], td_abs[d])
                       for d in range(n_slots)])

    return ReplayBuffer(kind, capacity, init=init, add=add, sample=sample,
                        update=update)
