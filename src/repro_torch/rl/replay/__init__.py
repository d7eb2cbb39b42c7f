"""The off-policy replay subsystem (port of ``repro.rl.replay``, one
device): the uniform circular buffer and proportional prioritized replay
on a sum tree, behind one protocol (:class:`ReplayBuffer`,
:func:`make_replay`).  The sharded buffer over several cards arrives
with the sharded slice."""
from repro_torch.rl.replay import sum_tree
from repro_torch.rl.replay.base import (KINDS, ReplayBuffer, make_replay,
                                        replay_size)
from repro_torch.rl.replay.per import (PERState, PRIORITY_EPS, per_add,
                                       per_init, per_sample, per_update)
from repro_torch.rl.replay.uniform import (Replay, replay_add, replay_init,
                                           replay_sample)

__all__ = ["KINDS", "PERState", "PRIORITY_EPS", "Replay", "ReplayBuffer",
           "make_replay", "per_add", "per_init", "per_sample", "per_update",
           "replay_add", "replay_init", "replay_sample", "replay_size",
           "sum_tree"]
