"""Parameter initializers and the boxed-parameter helpers (port of
``repro.nn.module``).

Parameters are plain dicts of tensors, in the reference's layouts.  An
initializer draws from an explicit CPU ``torch.Generator`` and then
moves the tensor to ``device``, so one seed gives the same weights on
the CPU and on the card.  (torch and jax draw different numbers from
the same seed: tests that need identical weights in both packages carry
them across with ``repro_torch.checkpoint.from_numpy_tree``.)

A :class:`Param` boxes a leaf with its *logical* sharding axes (names
such as ``"d_model"`` or ``"heads"``, one a dimension, ``None`` for an
unnamed one), as the reference's inits return them.  The port's model
inits return unboxed trees and give the same axes tree through each
family's ``param_axes(cfg)``; ``rebox`` joins the two, ``unbox`` and
``axes_of`` take a boxed tree apart again, and
``distributed.sharding.make_shardings`` turns the axes into specs.

:func:`eval_shape` is the port's ``jax.eval_shape``: a tree's shapes
and dtypes as ``meta`` tensors, computed without drawing or allocating
anything.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Sequence, Tuple

import torch

from repro_torch.core.fxp import QTensor
from repro_torch.tree import (leaves_with_path, map_with_path, tree_leaves,
                              tree_map)

Axes = Optional[Tuple[Optional[str], ...]]


@dataclasses.dataclass
class Param:
    """A parameter leaf annotated with logical sharding axes."""

    value: Any
    axes: Axes = None

    @property
    def shape(self):
        return self.value.shape


def is_param(x) -> bool:
    return isinstance(x, Param)


def is_axes(x) -> bool:
    """An axes leaf: ``None`` or a tuple of names and ``None``s."""
    return x is None or (type(x) is tuple
                         and all(a is None or isinstance(a, str) for a in x))


def unbox(tree):
    """Strip Param boxes -> the plain tree the steps and optimizer see."""
    return tree_map(lambda p: p.value if is_param(p) else p, tree,
                    is_leaf=is_param)


def axes_of(tree):
    """Same structure as ``unbox(tree)`` with axes tuples as leaves."""
    return tree_map(lambda p: p.axes if is_param(p) else None, tree,
                    is_leaf=is_param)


def rebox(values, axes):
    """Inverse of unbox given an axes tree of identical structure."""
    by_path = dict(leaves_with_path(axes, is_leaf=is_axes))
    return map_with_path(lambda path, v: Param(v, by_path.get(path)),
                         values)


def eval_shape(fn: Callable, *args):
    """``fn(*args)`` run under a ``FakeTensorMode`` (no draw, no
    allocation), its tensors handed back as ``meta`` tensors of the same
    shapes and dtypes (a QTensor's payload and scale each).  Arguments
    may be real or ``meta`` tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def meta(t):
        return torch.empty(t.shape, dtype=t.dtype, device="meta")

    def to_meta(x):
        if isinstance(x, QTensor):
            return QTensor(meta(x.qvalue), meta(x.scale), x.bits)
        return meta(x) if isinstance(x, torch.Tensor) else x

    with FakeTensorMode(allow_non_fake_inputs=True):
        out = fn(*args)
    return tree_map(to_meta, out, is_leaf=lambda x: isinstance(x, QTensor))


def param(gen: torch.Generator, shape: Sequence[int], axes: Axes,
          init: Optional[Callable] = None, dtype=torch.float32,
          device="cpu") -> Param:
    init = init or lecun_init()
    if axes is not None and len(axes) != len(shape):
        raise ValueError(f"axes {axes} do not name the {len(shape)} "
                         f"dimensions of {tuple(shape)}")
    return Param(init(gen, tuple(shape), dtype, device), axes)


def count_params(tree) -> int:
    """Elements of every leaf (a QTensor's payload, not its scale)."""
    total = 0
    for leaf in tree_leaves(unbox(tree),
                            is_leaf=lambda x: isinstance(x, QTensor)):
        total += (leaf.qvalue if isinstance(leaf, QTensor)
                  else leaf).numel()
    return total


def _fan_in(shape: Sequence[int]) -> int:
    return shape[-2] if len(shape) >= 2 else shape[-1]


def lecun_init() -> Callable:
    def f(gen: torch.Generator, shape, dtype=torch.float32, device="cpu"):
        std = math.sqrt(1.0 / _fan_in(shape))
        x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32)
        return (x * std).to(dtype=dtype, device=device)
    return f


def he_init() -> Callable:
    def f(gen: torch.Generator, shape, dtype=torch.float32, device="cpu"):
        std = math.sqrt(2.0 / _fan_in(shape))
        x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32)
        return (x * std).to(dtype=dtype, device=device)
    return f


def normal_init(stddev: float = 0.02) -> Callable:
    def f(gen: torch.Generator, shape, dtype=torch.float32, device="cpu"):
        x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32)
        return (x * stddev).to(dtype=dtype, device=device)
    return f


def zeros_init() -> Callable:
    def f(gen: torch.Generator, shape, dtype=torch.float32, device="cpu"):
        del gen
        return torch.zeros(tuple(shape), dtype=dtype, device=device)
    return f


def ones_init() -> Callable:
    def f(gen: torch.Generator, shape, dtype=torch.float32, device="cpu"):
        del gen
        return torch.ones(tuple(shape), dtype=dtype, device=device)
    return f


def uniform(gen: torch.Generator, shape, lo: float, hi: float,
            device="cpu") -> torch.Tensor:
    """fp32 draws uniform in [lo, hi) from ``gen``, placed on ``device``
    (the reference draws its SSD decays and RG-LRU rates so)."""
    x = torch.rand(tuple(shape), generator=gen, dtype=torch.float32)
    return (x * (hi - lo) + lo).to(device)
