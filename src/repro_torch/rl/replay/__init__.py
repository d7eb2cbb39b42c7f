"""The off-policy replay subsystem (port of ``repro.rl.replay``): the
uniform circular buffer and proportional prioritized replay on a sum
tree, behind one protocol (:class:`ReplayBuffer`, :func:`make_replay`).
Either backend shards over a mesh's slots via
:func:`make_sharded_replay`: per-slot local buffers (a leading
[n_slots] state axis), stratified-by-slot sampling and globally
corrected IS weights (:mod:`repro_torch.rl.replay.sharded`)."""
from repro_torch.rl.replay import sum_tree
from repro_torch.rl.replay.base import (KINDS, ReplayBuffer, make_replay,
                                        replay_size)
from repro_torch.rl.replay.per import (PERState, PRIORITY_EPS, per_add,
                                       per_init, per_sample, per_update)
from repro_torch.rl.replay.sharded import (make_sharded_replay,
                                           normalize_weights,
                                           per_global_weights,
                                           slot_capacity)
from repro_torch.rl.replay.uniform import (Replay, replay_add, replay_init,
                                           replay_sample)

__all__ = ["KINDS", "PERState", "PRIORITY_EPS", "Replay", "ReplayBuffer",
           "make_replay", "make_sharded_replay", "normalize_weights",
           "per_add", "per_global_weights", "per_init", "per_sample", "per_update",
           "replay_add", "replay_init", "replay_sample", "replay_size",
           "slot_capacity", "sum_tree"]
