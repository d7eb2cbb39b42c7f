"""Uniform circular replay (port of ``repro.rl.replay.uniform``).

Transitions are discount-encoded: ``discounts = gamma^K *
(1 - terminated)`` folds the n-step horizon, truncation and termination
into one number (see :func:`repro_torch.rl.value.nstep_targets`), so
every TD target downstream is ``rewards + discounts * Q(next_obs)``.

The buffer lives on one device, with the reference's fields, dtypes and
checkpoint keys.  :func:`replay_add` writes into the buffer's tensors in
place and returns the state with the new pointer and size: the buffer is
donated, as the reference's jitted iteration donates it, so a capacity
of frames is never copied to add a batch.  The sampled slots are an
input (``slots``, drawn by the caller), the seam through which a parity
test passes the reference's draws.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

Tensor = torch.Tensor


class Replay(NamedTuple):
    obs: Tensor          # [N, ...]
    actions: Tensor      # [N] (Discrete) or [N, d] (Box)
    rewards: Tensor      # [N] (n-step accumulated)
    next_obs: Tensor     # [N, ...] true successor (pre-reset at bounds)
    discounts: Tensor    # [N] gamma^K * (1 - terminated)
    ptr: Tensor          # 0-dim int32: next write slot
    size: Tensor         # 0-dim int32: valid entries


def replay_init(capacity: int, obs_shape,
                action_shape: Tuple[int, ...] = (),
                action_dtype=torch.int32, device="cpu") -> Replay:
    def z(shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return Replay(z((capacity,) + tuple(obs_shape)),
                  z((capacity,) + tuple(action_shape), action_dtype),
                  z((capacity,)),
                  z((capacity,) + tuple(obs_shape)),
                  z((capacity,)),
                  z((), torch.int32), z((), torch.int32))


def write_slots(ptr: Tensor, capacity: int, batch: int):
    """The circular-write plan shared by every backend: for ``batch``
    incoming transitions, ``(drop, idx, new_ptr)`` — drop the first
    ``drop`` rows (a Python int, non-zero only when the batch is at
    least the capacity, where a raw write would scatter to duplicate
    slots in no defined order), then write the survivors at slots
    ``idx`` (int64) and move the pointer to ``new_ptr``."""
    drop = 0
    if batch >= capacity:
        drop = batch - capacity
        ptr = ptr + drop        # slots the dropped prefix would have used
        batch = capacity
    idx = (ptr.to(torch.int64)
           + torch.arange(batch, device=ptr.device)) % capacity
    return drop, idx, ((ptr + batch) % capacity).to(torch.int32)


def replay_add(buf: Replay, obs, action, reward, next_obs,
               discount) -> Replay:
    """Add a batch of B transitions (contiguous circular write, in
    place).  ``B >= capacity`` keeps exactly the last ``capacity``."""
    B = obs.shape[0]
    cap = buf.obs.shape[0]
    drop, idx, new_ptr = write_slots(buf.ptr, cap, B)
    if drop:
        obs, action, reward, next_obs, discount = (
            x[drop:] for x in (obs, action, reward, next_obs, discount))
        B = cap
    for dst, src in ((buf.obs, obs), (buf.actions, action),
                     (buf.rewards, reward), (buf.next_obs, next_obs),
                     (buf.discounts, discount)):
        dst[idx] = src.to(dst.dtype)
    return buf._replace(ptr=new_ptr,
                        size=torch.clamp_max(buf.size + B, cap))


def gather(buf: Replay, idx: Tensor) -> dict:
    """The batch columns at slots ``idx`` (no weight: backends attach
    their own)."""
    return {"obs": buf.obs[idx], "actions": buf.actions[idx],
            "rewards": buf.rewards[idx], "next_obs": buf.next_obs[idx],
            "discounts": buf.discounts[idx]}


def check_min_size(size: Tensor, min_size: int,
                   masked: bool = False) -> Tensor:
    """The underfill guard shared by every backend: a buffer below
    ``min_size`` (the trainer's ``learn_start``) must not train.  A
    direct call raises, as the reference's eager call does (one host
    read); inside the training iteration (``masked=True``, the
    reference's jitted semantics) the returned 0/1 mask multiplies the
    batch weights, so the whole batch is masked and nothing is read
    back to the host."""
    if not masked and int(size) < min_size:
        raise ValueError(
            f"replay sample: buffer holds {int(size)} transitions "
            f"but min_size={min_size} — sampling would return "
            "uninitialized (all-zero) transitions; collect more steps "
            "first (learn_start)")
    return (size >= min_size).to(torch.float32)


def replay_sample(buf: Replay, slots: Tensor, min_size: int = 1,
                  masked: bool = False) -> dict:
    """The transitions at ``slots`` ([n] ints drawn uniformly from
    ``[0, size)``).  The ``"weight"`` column is 1, or 0 under
    ``masked`` when the buffer is below ``min_size``; ``"indices"``
    carries the slots for the priority write-back (a no-op here)."""
    ok = check_min_size(buf.size, max(int(min_size), 1), masked)
    idx = slots.to(device=buf.obs.device, dtype=torch.int64)
    batch = gather(buf, idx)
    batch["weight"] = ok.expand(idx.shape[0])
    batch["indices"] = idx
    return batch
