"""Environment registry (port of ``repro.rl.envs.registry``)."""
from __future__ import annotations

from typing import Callable, Dict, Tuple

from repro_torch.rl.envs.base import Environment

_REGISTRY: Dict[str, Callable[..., Environment]] = {}


def register(name: str, factory: Callable[..., Environment],
             overwrite: bool = False) -> None:
    if name in _REGISTRY and not overwrite:
        raise ValueError(f"environment {name!r} already registered "
                         "(pass overwrite=True to replace)")
    _REGISTRY[name] = factory


def make(name: str, **kwargs) -> Environment:
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown environment {name!r}; registered: "
            f"{', '.join(registered())}") from None
    env = factory(**kwargs)
    if not isinstance(env, Environment):
        raise TypeError(f"factory for {name!r} returned {type(env)}, "
                        "expected Environment")
    return env


def registered() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))
