"""Proportional prioritized experience replay (Schaul et al., 2016; port
of ``repro.rl.replay.per``) on the sum tree.

The state is the uniform circular storage, a sum tree over its slots
and the running max priority:

* insertion writes new transitions at the current max priority;
* sampling is stratified inverse-CDF descent over the tree, so slot
  ``i`` is drawn with probability ``p_i / sum_j p_j``, ``p_i = (|td_i| +
  eps) ** alpha``;
* importance weights ``w_i = (N * P(i)) ** -beta``, normalized by the
  batch max, correct the sampling bias;
* after each TD update the sampled slots' priorities are rewritten from
  the fresh TD errors (:func:`per_update`).

Priorities live in the tree already exponentiated.  The stratified
draws are an input (``uniforms``, one per sample in ``[0, 1)``).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.rl.replay import sum_tree
from repro_torch.rl.replay.uniform import (Replay, check_min_size, gather,
                                           replay_add, replay_init,
                                           write_slots)

Tensor = torch.Tensor

# floor added to |td| before the alpha exponent: keeps every visited
# transition revisitable (zero TD error must not mean zero mass)
PRIORITY_EPS = 1e-3


class PERState(NamedTuple):
    store: Replay       # the uniform circular storage
    tree: Tensor        # [2 * L] sum tree over the slots (mass = p^alpha)
    max_p: Tensor       # 0-dim fp32: running max of the tree leaf mass


def per_init(capacity: int, obs_shape,
             action_shape: Tuple[int, ...] = (),
             action_dtype=torch.int32, device="cpu") -> PERState:
    return PERState(
        replay_init(capacity, obs_shape, action_shape, action_dtype, device),
        sum_tree.init(capacity, device),
        torch.ones((), dtype=torch.float32, device=device))


def per_add(state: PERState, obs, action, reward, next_obs,
            discount) -> PERState:
    """Circular write + max-priority insertion for the new slots."""
    B = obs.shape[0]
    cap = state.store.obs.shape[0]
    # the storage's own write plan, so tree and storage slots agree
    _, idx, _ = write_slots(state.store.ptr, cap, B)
    store = replay_add(state.store, obs, action, reward, next_obs,
                       discount)
    tree = sum_tree.update(state.tree, idx, state.max_p.expand(idx.shape))
    return PERState(store, tree, state.max_p)


def per_sample(state: PERState, uniforms: Tensor, min_size: int = 1,
               beta: float = 1.0, masked: bool = False) -> dict:
    """Stratified proportional sample with importance weights.

    Returns the storage columns plus ``"indices"``, ``"probs"`` and
    ``"weight"``: the max-normalized importance weights, zeroed under
    ``masked`` when the buffer is below ``min_size`` (a direct call
    raises there, as the uniform backend's does).  ``beta`` is an fp32
    value (a Python float that fp32 holds exactly)."""
    size = state.store.size
    ok = check_min_size(size, max(int(min_size), 1), masked)
    idx, _ = sum_tree.stratified_sample(state.tree, uniforms)
    # an empty tree, or a sub-ulp rounding in the descent, can land on a
    # zero-mass padded leaf past the valid prefix: clamp to it and price
    # the weight at the clamped leaf
    idx = torch.minimum(idx, torch.clamp_min(size - 1, 0).to(torch.int64))
    mass = sum_tree.get(state.tree, idx)
    t = sum_tree.total(state.tree)
    probs = torch.clamp_min(mass, 1e-12) / torch.clamp_min(t, 1e-12)
    N = torch.clamp_min(size, 1).to(torch.float32)
    w = torch.pow(N * probs, -beta)
    w = w / torch.clamp_min(w.max(), 1e-12)
    batch = gather(state.store, idx)
    batch["weight"] = w * ok
    batch["indices"] = idx
    batch["probs"] = probs
    return batch


def per_update(state: PERState, idx: Tensor, td_abs: Tensor,
               alpha: float = 0.6) -> PERState:
    """Priority refresh from fresh per-sample TD errors: ``mass =
    (|td| + eps) ** alpha``; a slot sampled twice keeps its last
    occurrence's mass (``sum_tree.update``)."""
    mass = torch.pow(torch.abs(td_abs) + PRIORITY_EPS, alpha)
    tree = sum_tree.update(state.tree, idx, mass.to(torch.float32))
    max_p = torch.maximum(state.max_p, mass.max())
    return PERState(state.store, tree, max_p)
