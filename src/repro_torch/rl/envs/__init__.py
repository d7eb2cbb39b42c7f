"""Batched torch environments (port of ``repro.rl.envs``).

    from repro_torch.rl.envs import make
    env = make("keydoor")

Built-ins, as the reference's: cartpole, keydoor, acrobot,
mountain_car, pendulum (continuous Box actions) and catch (pixels).
"""
from repro_torch.rl.envs import (acrobot, cartpole, catch, keydoor,
                                 mountain_car, pendulum, spaces, wrappers)
from repro_torch.rl.envs.base import Environment, EnvSpec
from repro_torch.rl.envs.registry import make, register, registered
from repro_torch.rl.envs.spaces import Box, Discrete

register("cartpole", cartpole.make)
register("keydoor", keydoor.make)
register("acrobot", acrobot.make)
register("mountain_car", mountain_car.make)
register("pendulum", pendulum.make)
register("catch", catch.make)

__all__ = ["Box", "Discrete", "Environment", "EnvSpec", "make",
           "register", "registered", "spaces", "wrappers"]
