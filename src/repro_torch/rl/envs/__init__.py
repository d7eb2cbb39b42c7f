"""Batched torch environments (port of ``repro.rl.envs``).

    from repro_torch.rl.envs import make
    env = make("keydoor")

This slice ports keydoor; the other envs arrive with the PPO training
slice.
"""
from repro_torch.rl.envs import keydoor, spaces, wrappers
from repro_torch.rl.envs.base import Environment, EnvSpec
from repro_torch.rl.envs.registry import make, register, registered
from repro_torch.rl.envs.spaces import Box, Discrete

register("keydoor", keydoor.make)

__all__ = ["Box", "Discrete", "Environment", "EnvSpec", "make",
           "register", "registered", "spaces", "wrappers"]
