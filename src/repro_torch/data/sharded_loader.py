"""Batch placement over a mesh's data axes (port of
``repro.data.sharded_loader``).

``place(batch, mesh)`` gives each rank the rows of the global batch
that ``batch_spec`` puts on its slot, moved to the mesh's device, so no
rank's device holds more than its own share (the reference's
``jax.make_array_from_callback`` materializes each device's slice
alone).  A batch that does not divide over the data axes raises, as
the reference's placement does.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.distributed.sharding import local_rows


def _mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's share of ``mesh`` lives on (the current
    card for a ``cuda`` mesh)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def place(batch: Dict, mesh: DeviceMesh) -> Dict:
    """This rank's rows of every ``[B, ...]`` entry of ``batch`` (numpy
    arrays or CPU tensors), on the mesh's device."""
    dev = _mesh_device(mesh)

    def put(x):
        t = torch.from_numpy(np.ascontiguousarray(x)) \
            if isinstance(x, np.ndarray) else x
        return local_rows(t, mesh).to(dev)

    return {k: put(v) for k, v in batch.items()}
