"""The replay protocol (port of ``repro.rl.replay.base``): one typed
facade over the two backends.

A :class:`ReplayBuffer` bundles ``init``/``add``/``sample``/``update``
for one backend and one static configuration; the state they thread
(``Replay`` or ``PERState``) is a tree of tensors on one device that
checkpoints under the reference's keys.  The batch contract::

    sample(state, draws, min_size=1, beta=1.0, masked=False) -> {
        "obs", "actions", "rewards", "next_obs", "discounts",
        "weight",    # IS weights under PER; the 0/1 underfill mask
        "indices",   # sampled slots, for update()
        ...          # PER: "probs"
    }
    update(state, indices, td_abs) -> state   # identity for uniform

``draws`` is what the backend consumes: ``[n]`` slots in ``[0, size)``
for uniform, ``[n]`` uniforms in ``[0, 1)`` for PER (:meth:`draw`
makes them from a generator).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch

from repro_torch.rl.replay import per as _per
from repro_torch.rl.replay import uniform as _uniform

KINDS = ("uniform", "per")


@dataclasses.dataclass(frozen=True)
class ReplayBuffer:
    """One replay backend bound to its static configuration."""

    kind: str                      # one of KINDS
    capacity: int
    init: Callable[[], Any]        # () -> state
    add: Callable[..., Any]        # (state, obs, act, rew, nxt, disc)
    sample: Callable[..., dict]    # (state, draws, min_size=, beta=, ...)
    update: Callable[..., Any]     # (state, indices, td_abs) -> state

    @property
    def prioritized(self) -> bool:
        return self.kind == "per"

    def draw(self, gen: torch.Generator, shape, size: int,
             device) -> torch.Tensor:
        """Sampling draws of ``shape`` from ``gen`` (on ``device``) for a
        buffer holding ``size`` transitions (a sharded buffer: each
        slot's): slots (uniform) or stratification uniforms (PER)."""
        if self.prioritized:
            return torch.rand(shape, generator=gen, device=device)
        return torch.randint(0, max(int(size), 1), shape, generator=gen,
                             device=device)


def replay_size(state) -> torch.Tensor:
    """Valid-entry count of either backend's state (0-dim int32); for a
    slot-major state ([n_slots] leading axis) the sum over the slots."""
    size = state.store.size if isinstance(state, _per.PERState) \
        else state.size
    return size if size.dim() == 0 else size.sum(dtype=torch.int32)


def make_replay(kind: str, capacity: int, obs_shape,
                action_shape: Tuple[int, ...] = (),
                action_dtype=torch.int32, *, alpha: float = 0.6,
                device="cpu") -> ReplayBuffer:
    """The :class:`ReplayBuffer` for one backend on ``device``.
    ``alpha`` is the PER priority exponent (ignored by ``uniform``)."""
    if kind not in KINDS:
        raise ValueError(f"unknown replay kind {kind!r} "
                         f"(expected one of {KINDS})")
    if kind == "uniform":
        return ReplayBuffer(
            kind, capacity,
            init=lambda: _uniform.replay_init(capacity, obs_shape,
                                              action_shape, action_dtype,
                                              device),
            add=_uniform.replay_add,
            sample=lambda state, draws, min_size=1, beta=1.0, masked=False:
                _uniform.replay_sample(state, draws, min_size, masked),
            update=lambda state, indices, td_abs: state)
    if not 0.0 <= alpha <= 1.0:
        raise ValueError(f"per alpha must be in [0, 1], got {alpha}")
    return ReplayBuffer(
        kind, capacity,
        init=lambda: _per.per_init(capacity, obs_shape, action_shape,
                                   action_dtype, device),
        add=_per.per_add,
        sample=_per.per_sample,
        update=lambda state, indices, td_abs:
            _per.per_update(state, indices, td_abs, alpha))
