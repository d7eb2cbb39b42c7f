"""RL side of the port: envs, nets, the actor fleet (one device or
sharded over a mesh), the trainers and the inference path."""
from repro_torch.rl.actor_learner import (collect, collect_sharded,
                                          collect_value,
                                          collect_value_sharded, fleet_mask,
                                          merge_results, pack_weights,
                                          sync_bytes, unpack_weights)
# ``rollout`` stays the module's name here (the function is
# ``repro_torch.rl.rollout.rollout``)
from repro_torch.rl.rollout import (RolloutResult, Trajectory,
                                    episode_returns, episode_returns_from,
                                    init_envs)

__all__ = ["RolloutResult", "Trajectory", "collect", "collect_sharded",
           "collect_value", "collect_value_sharded", "episode_returns",
           "episode_returns_from", "fleet_mask", "init_envs",
           "merge_results", "pack_weights", "sync_bytes",
           "unpack_weights"]
