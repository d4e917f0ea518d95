"""Launch layer: meshes over ``torch.distributed``, the card's hardware
model, the perf model, the pods and the multi-tenant server.

The server (``launch.serve_tm``), the scheduler (``launch.scheduler``)
and the pods (``launch.pod``) import the whole front end and are imported
from their modules."""
from .mesh import (H100, HardwareModel, data_axes, make_host_mesh,
                   make_production_mesh, mesh_chips)

__all__ = ["make_production_mesh", "make_host_mesh", "HardwareModel",
           "H100", "mesh_chips", "data_axes"]
