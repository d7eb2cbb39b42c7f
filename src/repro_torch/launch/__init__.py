"""Command-line entry points of the port, and the device meshes the
sharded paths run on."""
from repro_torch.launch.mesh import (describe, make_host_mesh,
                                     make_production_mesh)

__all__ = ["describe", "make_host_mesh", "make_production_mesh"]
