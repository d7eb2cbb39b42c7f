"""Batched torch environments (port of ``repro.rl.envs``).

    from repro_torch.rl.envs import make
    env = make("keydoor")

The port has cartpole, keydoor and catch; acrobot, mountain_car and
pendulum arrive with a later slice.
"""
from repro_torch.rl.envs import cartpole, catch, keydoor, spaces, wrappers
from repro_torch.rl.envs.base import Environment, EnvSpec
from repro_torch.rl.envs.registry import make, register, registered
from repro_torch.rl.envs.spaces import Box, Discrete

register("cartpole", cartpole.make)
register("catch", catch.make)
register("keydoor", keydoor.make)

__all__ = ["Box", "Discrete", "Environment", "EnvSpec", "make",
           "register", "registered", "spaces", "wrappers"]
