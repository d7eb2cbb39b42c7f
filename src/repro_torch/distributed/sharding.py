"""Sharding on ``torch.distributed`` (port of
``repro.distributed.sharding``): the logical-axis layout of the LM
params, the data axes of a mesh and the sharded map over them.

**Layout.**  Parameters carry *logical* axis names (``nn.module.Param``;
each LM family's ``param_axes``).  A rule table maps each name to mesh
axes (``BASE_RULES``, overridden per arch by
``models.registry.sharding_rules``); ``spec_for`` turns one axes tuple
into a :class:`PartitionSpec` and ``make_shardings`` a whole tree into
:class:`NamedSharding` objects, a QTensor's scale following its
payload's last dimension.  Specs need only the mesh's axis names and
sizes (:class:`MeshShape`), so those of the (16, 16) and (2, 16, 16)
production meshes are computed without 256 or 512 ranks.  On a live
``DeviceMesh`` a spec becomes DTensor placements (``placements``:
``Shard(d)`` or ``Replicate()`` on each mesh dimension), and
``distribute`` / ``gather`` lay a tree out with ``distribute_tensor``
and bring it back whole.  ``mesh_rules`` sets the mesh and rules that
``constrain`` reads: the reference's in-graph layout hints.  Each rank
here computes on its own rows of plain tensors, so on a plain tensor
``constrain`` returns its input; a DTensor it redistributes to the
spec's placements.

**The data axes.**  ``shard_map`` is the counterpart of the
reference's: each rank takes its rows of the global ``[B, ...]`` inputs
(the slot's share of the data axes), runs the body, and the outputs
come back as the global tensors, gathered in slot order, on every rank.
The collectives that reduce (``psum``, ``pmax``, ``ordered_sum`` of a
gather) gather in order and then sum (or take the max) on the device
in that order, never through a backend's ``all_reduce``: the result
depends on the slot count alone, never on the backend's ring, and at
one slot ``psum(x)`` is ``x`` bit for bit.

**One rank of a mesh, in one process.**  A :class:`MeshShape` also
stands for a mesh this process is rank 0 of, with no process group
behind it: the dry run (``launch.dryrun``) traces one rank of the
production meshes this way.  Its coordinate is 0 on every axis, and
``gather_over`` hands back copies of this rank's own value from every
peer.  Every collective of the port starts in ``gather_over``; under an
op recorder (``repro_torch.record``) each call is one transfer, filed
under the reference's kind (``psum`` and ``pmax`` as ``all-reduce``,
the rest, the MoE exchange included, as ``all-gather``), of the bytes
this rank receives: ``n - 1`` copies of its input.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import record
from repro_torch.core.fxp import QTensor, is_qtensor
from repro_torch.nn.module import is_axes
from repro_torch.tree import (is_namedtuple, leaves_with_path,
                              map_with_path, tree_leaves, tree_map,
                              tree_unflatten)

Tensor = torch.Tensor
AxisName = Union[str, Tuple[str, ...], None]

# Base logical->mesh rules.  Per-arch overrides replace entries (e.g.
# kv_heads -> "model" only when divisible; experts -> "model" for EP).
BASE_RULES: Dict[str, AxisName] = {
    "batch": "__data__",      # expands to ("pod","data") when present
    "seq": None,              # flip to "model" for sequence parallelism
    # FSDP/ZeRO-3: the d_model dim of every weight over the data axis
    "d_model": "data",
    "heads": "model",
    "kv_heads": None,
    "d_ff": "model",
    "d_ff_expert": "model",
    "experts": None,
    "d_inner": "model",
    "vocab": "model",
    "layers": None,
}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes: all a spec is computed from."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes, strict=True))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def mesh_shape(mesh) -> MeshShape:
    """The names and sizes of a ``DeviceMesh`` (a ``MeshShape`` as it
    is)."""
    if isinstance(mesh, MeshShape):
        return mesh
    with record.unrecorded():
        return MeshShape(tuple(mesh.mesh_dim_names), tuple(mesh.mesh.shape))


class PartitionSpec(tuple):
    """The reference's ``PartitionSpec``: one entry a tensor dimension,
    each a mesh axis name, a tuple of names, or ``None``."""

    def __new__(cls, *entries: AxisName):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (a ``DeviceMesh``, or a ``MeshShape`` whose specs
    are computed but not laid out)."""

    mesh: object
    spec: PartitionSpec


def _axis_names(mesh) -> Tuple[str, ...]:
    return mesh.axis_names if isinstance(mesh, MeshShape) \
        else tuple(mesh.mesh_dim_names)


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in _axis_names(mesh))


def data_axis_size(mesh) -> int:
    """Total number of data-parallel slots (product of data-like axes)."""
    shape = mesh_shape(mesh).shape
    n = 1
    for a in data_axes(mesh):
        n *= shape[a]
    return n


def batch_spec(mesh, extra_dims: int = 1,
               batch_size: Optional[int] = None) -> PartitionSpec:
    """The spec of [batch, ...] inputs: the batch dim over all data
    axes, the rest unsharded.  A ``batch_size`` that does not divide the
    data axes replicates the batch dim."""
    ax = data_axes(mesh)
    if ax and batch_size is not None and batch_size % data_axis_size(mesh):
        ax = ()
    return P(_entry(ax), *([None] * extra_dims))


def _entry(ax: Tuple[str, ...]) -> AxisName:
    """Mesh axes as ``PartitionSpec`` holds them: one axis by its name."""
    return (ax[0] if len(ax) == 1 else ax) if ax else None


def _coordinate(mesh):
    """This rank's coordinate on the mesh (0 on every axis of a
    ``MeshShape``)."""
    if isinstance(mesh, MeshShape):
        return (0,) * len(mesh.sizes)
    with record.unrecorded():
        coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return coord


def slot_index(mesh) -> int:
    """This rank's slot: its coordinate over the data axes, row-major."""
    coord, ms = _coordinate(mesh), mesh_shape(mesh)
    idx = 0
    for a in data_axes(mesh):
        i = ms.axis_names.index(a)
        idx = idx * ms.sizes[i] + coord[i]
    return idx


def axes_group(mesh: DeviceMesh, axes: Sequence[str]):
    """The process group of this rank's peers over ``axes`` (the
    others fixed), ranked row-major over them."""
    axes = tuple(axes)
    if not axes:
        raise ValueError(f"mesh {mesh.mesh_dim_names} has no such axes")
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def data_group(mesh: DeviceMesh):
    """The process group of the mesh's data axes."""
    axes = data_axes(mesh)
    if not axes:
        raise ValueError(f"mesh {mesh.mesh_dim_names} has no data axes")
    return axes_group(mesh, axes)


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return _coordinate(mesh)[mesh_shape(mesh).axis_names.index(axis)]


def gather_over(x: Tensor, mesh, axes: Sequence[str],
                kind: str = "all-gather") -> List[Tensor]:
    """Every peer's ``x`` over ``axes`` (same shape and dtype on each),
    in their order.  int16, which neither gloo nor NCCL gathers, travels
    as its bytes.  Over a ``MeshShape`` every peer's is a copy of this
    rank's.  An active op recorder files the call under ``kind``."""
    rec = record.active()
    if rec is None or rec.in_kernel:
        return _gather(x, mesh, axes)
    with rec.inside_kernel():
        parts = _gather(x, mesh, axes)
    rec.collective(kind, x, parts)
    return parts


def _gather(x: Tensor, mesh, axes: Sequence[str]) -> List[Tensor]:
    shape, dtype = x.shape, x.dtype
    wire = x.reshape(-1).contiguous()
    if isinstance(mesh, MeshShape):
        n = 1
        for a in axes:
            n *= mesh.shape[a]
        return [wire.clone().reshape(shape) for _ in range(n)]
    group = axes_group(mesh, axes)
    n = dist.get_world_size(group)
    if dtype == torch.int16:
        wire = wire.view(torch.uint8)
    parts = [torch.empty_like(wire) for _ in range(n)]
    dist.all_gather(parts, wire, group=group)
    if dtype == torch.int16:
        parts = [p.view(torch.int16) for p in parts]
    return [p.reshape(shape) for p in parts]


def gather_slots(x: Tensor, mesh, kind: str = "all-gather") -> List[Tensor]:
    """Every slot's ``x`` (same shape and dtype on each), in slot order."""
    if not data_axes(mesh):
        raise ValueError(f"mesh {_axis_names(mesh)} has no data axes")
    return gather_over(x, mesh, data_axes(mesh), kind)


def ordered_sum(parts: Sequence[Tensor]) -> Tensor:
    """``parts[0] + parts[1] + ...``, added in that order."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def psum(x: Tensor, mesh) -> Tensor:
    """Sum over the slots, added in slot order on the device."""
    return ordered_sum(gather_slots(x, mesh, "all-reduce"))


def pmax(x: Tensor, mesh) -> Tensor:
    """Elementwise max over the slots."""
    parts = gather_slots(x, mesh, "all-reduce")
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


def local_rows(tree, mesh, dim: int = 0):
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


def gather_rows(tree, mesh, dim: int = 0):
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
        with manual():
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



# ---------------------------------------------------------------------------
# logical-axis layout
# ---------------------------------------------------------------------------

def resolve(rules: Dict[str, AxisName], name: Optional[str],
            mesh) -> AxisName:
    """The mesh axes of one logical name under ``rules`` (``None`` where
    the rule names an axis the mesh lacks)."""
    if name is None:
        return None
    r = rules.get(name, None)
    if r == "__data__":
        ax = data_axes(mesh)
        return ax if ax else None
    if isinstance(r, str) and r not in _axis_names(mesh):
        return None
    return r


def spec_for(axes, rules: Dict[str, AxisName], mesh) -> PartitionSpec:
    """The spec of one axes tuple.  A mesh axis may appear once in a
    spec (``seq`` under sequence parallelism collides with ``vocab``):
    the first dimension to claim it keeps it."""
    if axes is None:
        return P()
    resolved, used = [], set()
    for a in axes:
        r = resolve(rules, a, mesh)
        flat = r if isinstance(r, tuple) else (r,) if r else ()
        if any(f in used for f in flat):
            r = None
        else:
            used.update(flat)
        resolved.append(_entry(r) if isinstance(r, tuple) else r)
    return P(*resolved)


def make_shardings(params_like, axes_tree, mesh,
                   rules: Optional[Dict[str, AxisName]] = None):
    """A :class:`NamedSharding` tree matching ``params_like`` (tensors,
    ``meta`` tensors or QTensors); ``axes_tree`` holds the logical axes
    of the (pre-quantization) weights.  A QTensor's payload takes the
    weight's spec and its scale the payload's last entry on its last
    dimension, its broadcast dimensions unsharded."""
    rules = dict(BASE_RULES, **(rules or {}))
    axes_at = dict(leaves_with_path(axes_tree, is_leaf=is_axes))

    def one(path, leaf):
        spec = spec_for(axes_at.get(path), rules, mesh)
        if isinstance(leaf, QTensor):
            n = leaf.scale.ndim
            last = spec[-1] if len(spec) else None
            s_spec = P(*([None] * (n - 1) + [last])) if n else P()
            return QTensor(NamedSharding(mesh, spec),
                           NamedSharding(mesh, s_spec), leaf.bits)
        return NamedSharding(mesh, spec)

    return map_with_path(one, params_like, is_leaf=is_qtensor)


def placements(spec: PartitionSpec, mesh: DeviceMesh):
    """DTensor placements of ``spec`` on a live mesh: on each mesh
    dimension ``Shard(d)`` for the tensor dimension ``d`` it splits, or
    ``Replicate()``.  A dimension over several mesh axes is split over
    them in the mesh's order, outer first, as ``("pod", "data")`` is."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else \
            (entry,) if entry else ()
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec} splits dimension {d} over "
                             f"{axes}, not in the mesh's order {names}")
        for i in idx:
            out[i] = Shard(d)
    return out


def _sharded(fn: Callable, tree, shardings):
    """``fn(tensor, sharding)`` over the leaves of ``tree``, a QTensor's
    payload and scale each with its own sharding."""
    at = dict(leaves_with_path(shardings, is_leaf=is_qtensor))

    def one(path, leaf):
        s = at[path]
        if isinstance(leaf, QTensor):
            return QTensor(fn(leaf.qvalue, s.qvalue), fn(leaf.scale, s.scale),
                           leaf.bits)
        return fn(leaf, s)

    return map_with_path(one, tree, is_leaf=is_qtensor)


def distribute(tree, shardings):
    """Every leaf of a replicated ``tree`` as a DTensor laid out by its
    :class:`NamedSharding`: each rank keeps its shard of its own copy
    (no data moves)."""
    from torch.distributed.tensor import distribute_tensor
    return _sharded(lambda t, s: distribute_tensor(
        t, s.mesh, placements(s.spec, s.mesh), src_data_rank=None), tree,
        shardings)


def gather(tree):
    """Every DTensor leaf of ``tree`` whole again, on every rank (an
    all-gather; nothing is reduced)."""
    from torch.distributed.tensor import DTensor

    def full(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    return tree_map(lambda x: QTensor(full(x.qvalue), full(x.scale), x.bits)
                    if isinstance(x, QTensor) else full(x), tree,
                    is_leaf=is_qtensor)


# ---------------------------------------------------------------------------
# activation constraints via a thread-local mesh/rules context
# ---------------------------------------------------------------------------

_ctx = threading.local()


@contextlib.contextmanager
def mesh_rules(mesh, rules: Optional[Dict[str, AxisName]] = None):
    """Within the block, ``current_mesh()`` is ``mesh`` and ``constrain``
    reads ``rules`` over the base rules (no mesh: no context)."""
    prev = getattr(_ctx, "state", None)
    _ctx.state = (mesh, dict(BASE_RULES, **(rules or {}))) if mesh \
        else None
    try:
        yield
    finally:
        _ctx.state = prev


def current_mesh():
    state = getattr(_ctx, "state", None)
    return state[0] if state else None


@contextlib.contextmanager
def manual():
    """Within the block, a rank computes as one slot of a ``shard_map``
    body does: its statistics are its own (``across_slots`` is false)."""
    prev = getattr(_ctx, "manual", False)
    _ctx.manual = True
    try:
        yield
    finally:
        _ctx.manual = prev


def context():
    """This thread's mesh context (``mesh_rules``' and ``manual``'s), to
    run other work under with :func:`restored`."""
    return getattr(_ctx, "state", None), getattr(_ctx, "manual", False)


@contextlib.contextmanager
def restored(saved):
    """Within the block, this thread's mesh context is ``saved`` (a
    :func:`context`): a rematerialised forward recomputed on autograd's
    own thread sees the context its forward saw."""
    prev = context()
    _ctx.state, _ctx.manual = saved
    try:
        yield
    finally:
        _ctx.state, _ctx.manual = prev


def across_slots() -> bool:
    """Whether a tensor-wide statistic here spans the data slots: under
    a mesh of more than one slot, outside ``manual``.  The reference's
    global program takes such a statistic over the whole batch; off a
    mesh, at one slot and in a per-slot body, a rank's own tensor is
    the whole of it."""
    mesh = current_mesh()
    return mesh is not None and not getattr(_ctx, "manual", False) \
        and data_axis_size(mesh) > 1


def constrain(x, axes: Tuple[Optional[str], ...]):
    """The reference's layout hint.  A plain tensor holds this rank's
    own rows and comes back as it is; a DTensor is redistributed to the
    spec of ``axes`` on its mesh.  Neither changes a value."""
    state = getattr(_ctx, "state", None)
    if state is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh, rules = state
    spec = spec_for(axes, rules, mesh)
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))
