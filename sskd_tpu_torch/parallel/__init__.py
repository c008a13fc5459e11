from sskd_tpu_torch.parallel.mesh import Mesh, create_mesh, local_devices, mesh_shape_for

__all__ = ["Mesh", "create_mesh", "local_devices", "mesh_shape_for"]
