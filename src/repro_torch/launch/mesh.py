"""Device meshes on ``torch.distributed`` (port of ``repro.launch.mesh``)
and the process group they stand on.

The reference's mesh is ``Mesh(devices.reshape(n, 1), ("data",
"model"))``; the port's is a ``torch.distributed.device_mesh.DeviceMesh``
of the same shape and dimension names over the first ``n`` ranks of the
process group.  Its collectives run on the backend of its device: NCCL
for ``cuda``, gloo for ``cpu``.  Nothing falls back: a mesh on the card
whose NCCL group fails fails the run.

The process group comes from ``torchrun``'s environment when there is
one (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ...), and is otherwise a
world of one rank on a ``FileStore`` in a temporary directory; it is torn
down when the process exits.  A caller that made its own group (a test's
spawned ranks) keeps it.  Importing this module touches no group.
"""
from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import MeshShape, mesh_shape

# the ranks' layout of the reference's meshes
HOST_AXES = ("data", "model")
PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def backend_for(device: torch.device) -> str:
    """The collective backend of a device type: NCCL on the card, gloo on
    the CPU."""
    return "nccl" if device.type == "cuda" else "gloo"


class _ProcessGroup:
    """This process's group, made once, and the meshes built on it (a
    mesh makes its dimension groups collectively, so every rank builds
    the same meshes in the same order and reuses them)."""

    def __init__(self):
        self.tmpdir: Optional[str] = None
        self.meshes: Dict[Tuple, DeviceMesh] = {}

    def ensure(self, device: torch.device) -> None:
        if dist.is_initialized():
            return
        backend = backend_for(device)
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            if device.type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
            dist.init_process_group(backend, init_method="env://")
        else:
            self.tmpdir = tempfile.mkdtemp(prefix="repro_torch_pg_")
            store = dist.FileStore(os.path.join(self.tmpdir, "store"), 1)
            dist.init_process_group(backend, store=store, rank=0,
                                    world_size=1)
        atexit.register(self.close)

    def close(self) -> None:
        self.meshes.clear()
        if dist.is_initialized():
            dist.destroy_process_group()
        if self.tmpdir:
            shutil.rmtree(self.tmpdir, ignore_errors=True)
            self.tmpdir = None

    def mesh(self, device: torch.device, shape: Tuple[int, ...],
             names: Tuple[str, ...]) -> DeviceMesh:
        key = (device.type, shape, names)
        if key not in self.meshes:
            n = 1
            for s in shape:
                n *= s
            backend = backend_for(device)
            self.meshes[key] = DeviceMesh(
                device.type, torch.arange(n).reshape(shape),
                mesh_dim_names=names,
                backend_override=((backend, None),) * len(shape))
        return self.meshes[key]


_GROUP = _ProcessGroup()


def world_size(device: DeviceLike = None) -> int:
    """The number of ranks (joining or making the group on ``device``'s
    backend first)."""
    _GROUP.ensure(resolve_device(device))
    return dist.get_world_size()


def rank() -> int:
    """This process's rank (0 before any group exists)."""
    return dist.get_rank() if dist.is_initialized() else 0


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    """The production mesh's names and sizes, from which its specs are
    computed without the 256 or 512 ranks a live mesh needs."""
    shape, names = PRODUCTION_SHAPES[multi_pod]
    return MeshShape(names, shape)


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> DeviceMesh:
    """The reference's production mesh, (16, 16) over ("data", "model")
    or (2, 16, 16) over ("pod", "data", "model"): the world must hold
    exactly 256 or 512 ranks, as ``jax.make_mesh`` needs that many
    devices."""
    dev = resolve_device(device)
    shape, names = PRODUCTION_SHAPES[multi_pod]
    need = 1
    for s in shape:
        need *= s
    have = world_size(dev)
    if have != need:
        raise ValueError(f"the production mesh {dict(zip(names, shape))} "
                         f"needs {need} ranks; this world has {have}")
    return _GROUP.mesh(dev, shape, names)


def make_host_mesh(n_devices: Optional[int] = None,
                   device: DeviceLike = None) -> DeviceMesh:
    """The first ``n_devices`` ranks (default: all of them) as an
    (n, 1) mesh over ("data", "model") on ``device`` (default: the
    card).  Every rank of the world calls it; a rank past the first
    ``n`` is outside the mesh (``in_mesh`` is false there)."""
    dev = resolve_device(device)
    have = world_size(dev)
    n = have if n_devices is None else n_devices
    if not 1 <= n <= have:
        raise ValueError(f"n_devices={n_devices} but this host exposes "
                         f"{have} device(s)")
    return _GROUP.mesh(dev, (n, 1), HOST_AXES)


def make_mesh(shape: Tuple[int, ...], names: Tuple[str, ...],
              device: DeviceLike = None) -> DeviceMesh:
    """The first ``prod(shape)`` ranks as a mesh of ``shape`` over
    ``names``, row-major (as ``jax.make_mesh`` lays out host devices):
    a (2, 4) mesh over ("data", "model") puts rank ``r`` at (r // 4,
    r % 4)."""
    dev = resolve_device(device)
    need = 1
    for s in shape:
        need *= s
    have = world_size(dev)
    if need > have:
        raise ValueError(f"a mesh {dict(zip(names, shape))} needs {need} "
                         f"ranks; this world has {have}")
    return _GROUP.mesh(dev, tuple(shape), tuple(names))


def in_mesh(mesh: DeviceMesh) -> bool:
    """Whether this rank is one of the mesh's."""
    return mesh.get_coordinate() is not None


def describe(mesh) -> str:
    """The reference's banner: ``mesh {'data': n, 'model': 1} (n
    devices)``, of a live mesh or a ``MeshShape``."""
    ms = mesh_shape(mesh)
    return f"mesh {ms.shape} ({ms.size} devices)"
