"""Batched torch environments (port of ``repro.rl.envs``).

    from repro_torch.rl.envs import make
    env = make("keydoor")

The port has cartpole and keydoor; acrobot, mountain_car, pendulum and
catch arrive with later slices.
"""
from repro_torch.rl.envs import cartpole, keydoor, spaces, wrappers
from repro_torch.rl.envs.base import Environment, EnvSpec
from repro_torch.rl.envs.registry import make, register, registered
from repro_torch.rl.envs.spaces import Box, Discrete

register("cartpole", cartpole.make)
register("keydoor", keydoor.make)

__all__ = ["Box", "Discrete", "Environment", "EnvSpec", "make",
           "register", "registered", "spaces", "wrappers"]
