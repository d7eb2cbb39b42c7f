"""Command-line entry points of the port, the device meshes the sharded
paths (the RL fleet, LM training) run on, and the dry run
(``dryrun``, ``hlo_analysis``, ``roofline``), which needs no device."""
from repro_torch.launch.mesh import (describe, make_host_mesh, make_mesh,
                                     make_production_mesh,
                                     production_mesh_shape)

__all__ = ["describe", "make_host_mesh", "make_mesh", "make_production_mesh",
           "production_mesh_shape"]
