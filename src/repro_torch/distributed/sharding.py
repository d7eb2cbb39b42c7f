"""The data axes of a mesh and the sharded map over them (port of the
parts of ``repro.distributed.sharding`` the RL fleet runs).

``shard_map`` is the counterpart of the reference's: each rank takes its
rows of the global ``[B, ...]`` inputs (the slot's share of the data
axes), runs the body, and the outputs come back as the global tensors,
gathered in slot order, on every rank.  The collectives that reduce
(``psum``, ``pmax``) also gather in slot order and then sum (or take the
max) on the device in that order, never through a backend's
``all_reduce``: the result depends on the slot count alone, never on
the backend's ring, and at one slot ``psum(x)`` is ``x`` bit for bit.
The RL fleet's gradients and trajectories are kilobytes, so the extra
bytes of a gather over a reduction do not matter.

Logical-axis rules (``make_shardings``, ``spec_for``, ``mesh_rules``,
``constrain``) belong to the LM layout and are not ported here.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.tree import (is_namedtuple, tree_leaves, tree_map,
                              tree_unflatten)

Tensor = torch.Tensor


def data_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def data_axis_size(mesh: DeviceMesh) -> int:
    """Total number of data-parallel slots (product of data-like axes)."""
    n = 1
    for a in data_axes(mesh):
        n *= mesh.mesh.shape[mesh.mesh_dim_names.index(a)]
    return n


def batch_spec(mesh: DeviceMesh, extra_dims: int = 1,
               batch_size: Optional[int] = None) -> tuple:
    """The reference's ``PartitionSpec`` for [batch, ...] inputs, as a
    tuple: the batch dim over all data axes, the rest unsharded.  A
    ``batch_size`` that does not divide the data axes replicates the
    batch dim."""
    ax = data_axes(mesh)
    if ax and batch_size is not None and batch_size % data_axis_size(mesh):
        ax = ()
    # as ``PartitionSpec`` holds it: one axis by its name
    entry = (ax[0] if len(ax) == 1 else ax) if ax else None
    return (entry,) + (None,) * extra_dims


def slot_index(mesh: DeviceMesh) -> int:
    """This rank's slot: its coordinate over the data axes, row-major."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    names = mesh.mesh_dim_names
    idx = 0
    for a in data_axes(mesh):
        i = names.index(a)
        idx = idx * mesh.mesh.shape[i] + coord[i]
    return idx


def data_group(mesh: DeviceMesh):
    """The process group of the mesh's data axes."""
    axes = data_axes(mesh)
    if not axes:
        raise ValueError(f"mesh {mesh.mesh_dim_names} has no data axes")
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def gather_slots(x: Tensor, mesh: DeviceMesh) -> List[Tensor]:
    """Every slot's ``x`` (same shape and dtype on each), in slot order.
    int16, which neither gloo nor NCCL gathers, travels as its bytes."""
    group = data_group(mesh)
    n = dist.get_world_size(group)
    shape, dtype = x.shape, x.dtype
    wire = x.reshape(-1).contiguous()
    if dtype == torch.int16:
        wire = wire.view(torch.uint8)
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=group)
    if dtype == torch.int16:
        parts = [p.view(torch.int16) for p in parts]
    return [p.reshape(shape) for p in parts]


def psum(x: Tensor, mesh: DeviceMesh) -> Tensor:
    """Sum over the slots, added in slot order on the device."""
    parts = gather_slots(x, mesh)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def pmax(x: Tensor, mesh: DeviceMesh) -> Tensor:
    """Elementwise max over the slots."""
    parts = gather_slots(x, mesh)
    total = parts[0]
    for p in parts[1:]:
        total = torch.maximum(total, p)
    return total


def psum_tree(tree, mesh: DeviceMesh):
    """``psum`` of every leaf of a tree of one dtype, as one gather of
    the leaves laid end to end."""
    leaves = tree_leaves(tree)
    flat = torch.cat([t.reshape(-1) for t in leaves])
    total = psum(flat, mesh)
    out, start = [], 0
    for t in leaves:
        out.append(total[start:start + t.numel()].reshape(t.shape))
        start += t.numel()
    return tree_unflatten(tree, out)


def local_rows(tree, mesh: DeviceMesh, dim: int = 0):
    """This slot's rows along ``dim`` of every leaf of a global tree."""
    n, d = data_axis_size(mesh), slot_index(mesh)

    def take(t):
        size = t.shape[dim]
        if size % n:
            raise ValueError(f"dim {dim} of size {size} does not divide "
                             f"evenly over {n} data slot(s)")
        per = size // n
        return t.narrow(dim, d * per, per)

    return tree_map(take, tree)


def gather_rows(tree, mesh: DeviceMesh, dim: int = 0):
    """Every slot's rows concatenated along ``dim`` in slot order: the
    global tree, on every rank."""
    return tree_map(lambda t: torch.cat(gather_slots(t, mesh), dim=dim),
                    tree)


def _map_spec(fn: Callable, spec, tree):
    """``fn(spec_leaf, subtree)`` where ``spec`` is a prefix of
    ``tree``: an int or None covers the whole subtree below it."""
    if spec is None or isinstance(spec, int):
        return fn(spec, tree)
    if isinstance(spec, dict):
        return {k: _map_spec(fn, spec[k], v) for k, v in tree.items()}
    if is_namedtuple(spec):
        return type(tree)(*(_map_spec(fn, getattr(spec, f), getattr(tree, f))
                            for f in spec._fields))
    return type(tree)(_map_spec(fn, s, t)
                      for s, t in zip(spec, tree, strict=True))


def shard_map(f: Callable, mesh: DeviceMesh, in_specs, out_specs
              ) -> Callable:
    """Run ``f`` on each slot's share of its inputs and gather its
    outputs.  ``in_specs`` has one entry an argument: None passes it as
    it is (replicated), an int ``d`` passes the slot's rows along dim
    ``d`` of every leaf.  ``out_specs`` is a prefix of ``f``'s output:
    an int ``d`` gathers the slots' outputs along dim ``d`` in slot
    order, None keeps the slot's own (replicated) value."""
    if not data_axes(mesh):
        raise ValueError(f"mesh {mesh.mesh_dim_names} has no data axes")

    def run(*args):
        local = [a if s is None else local_rows(a, mesh, s)
                 for a, s in zip(args, in_specs, strict=True)]
        out = f(*local)
        return _map_spec(
            lambda s, t: t if s is None else gather_rows(t, mesh, s),
            out_specs, out)

    return run


def fence(mesh: DeviceMesh, device: torch.device) -> None:
    """Fence the mesh: the card's queued work, then every slot."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dist.barrier(group=data_group(mesh))

