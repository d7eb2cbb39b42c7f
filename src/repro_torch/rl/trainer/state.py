"""The training state the trainer threads and checkpoints (port of
``repro.rl.trainer.state``).

``TrainState`` is checkpointed as a plain tuple, so its slots take the
reference's index keys ("0/..." params, "2/..." optimizer state,
"4/..." env state, "5" observations) and a checkpoint of either package
restores in the other.  The on-policy family leaves ``target`` and
``replay`` as ``None``, which carry no leaves; the value family fills
every slot (``replay`` holds the uniform or PER state, pointer, size
and tree included).  The per-iteration
draws are not state: they are a function of (seed, global step).
"""
from __future__ import annotations

from typing import Any, NamedTuple

# recorded in checkpoint metadata under "schema"
STATE_SCHEMA = "trainstate/v1"


class TrainState(NamedTuple):
    params: Any     # online nets
    target: Any     # polyak target nets (None for on-policy)
    opt: Any        # optimizer state
    replay: Any     # replay buffer state (None for on-policy)
    est: Any        # vectorized env state
    obs: Any        # last observations [n_envs, ...]


def value_state(params, target, opt, replay, est, obs) -> TrainState:
    return TrainState(params, target, opt, replay, est, obs)


def onpolicy_state(params, opt, est, obs) -> TrainState:
    return TrainState(params, None, opt, None, est, obs)


def as_checkpoint_tree(state: TrainState) -> tuple:
    """The tree a checkpoint stores: slots under index keys."""
    return tuple(state)
