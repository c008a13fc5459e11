from sskd_tpu_torch.parallel.distributed import initialize_distributed
from sskd_tpu_torch.parallel.mesh import Mesh, create_mesh, local_devices, mesh_shape_for

__all__ = ["Mesh", "create_mesh", "initialize_distributed", "local_devices", "mesh_shape_for"]
