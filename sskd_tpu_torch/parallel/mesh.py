"""Device meshes (port of sskd_tpu/parallel/mesh.py: ``mesh_shape_for`` and
``create_mesh``).

A mesh is what the JAX mesh is on one host: one process and a grid of its
devices, ``[data, index]``, with the JAX package's axis names. An index
sharded over the ``index`` axis keeps one shard on each device of that axis
(:mod:`sskd_tpu_torch.index.sharded`), the layout FAISS's ``IndexShards``
uses over the GPUs of one host. Nothing here needs a process group.

Devices: ``create_mesh(devices=None)`` takes ``cuda:0`` .. ``cuda:n-1`` and
raises where CUDA is missing; asking for more devices than there are raises
(:func:`mesh_shape_for`), with no fallback to fewer devices or to the CPU.
A CPU mesh of N entries is made only when it is asked for:
``devices=[torch.device("cpu")] * N``, or :func:`local_devices` of the CPU
after :func:`set_cpu_devices` (the CLI's ``--cpu-devices N``, the port's
counterpart of the JAX flag's virtual CPU devices).

Across processes: in a data-parallel run the ``data`` axis spans processes,
one process a row, joined by a ``torch.distributed`` group
(:mod:`sskd_tpu_torch.parallel.distributed`, ``initialize_distributed``);
row ``r`` holds rank ``r``'s device (``process_mesh``), and only a rank's
own row is read by it. The ``index`` axis stays inside a process.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

from sskd_tpu_torch.utils.platform import resolve_device

_cpu_devices = 1  # the CPU entries local_devices gives (set_cpu_devices)


def set_cpu_devices(n: int) -> None:
    """How many entries :func:`local_devices` gives for the CPU (default 1)."""
    global _cpu_devices
    if n < 1:
        raise ValueError(f"cpu devices {n} < 1")
    _cpu_devices = int(n)


def local_devices(device: str | torch.device = "cuda") -> list[torch.device]:
    """The devices a mesh over ``device``'s type may take: every CUDA device
    of the machine (raises where CUDA is missing), or the CPU as many times
    as :func:`set_cpu_devices` said."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return [torch.device("cpu")] * _cpu_devices
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def same_device(a: str | torch.device, b: str | torch.device) -> bool:
    """Whether ``a`` and ``b`` name one device (``cuda`` is the current one)."""
    a, b = torch.device(a), torch.device(b)
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    current = torch.cuda.current_device()
    return (current if a.index is None else a.index) == (current if b.index is None else b.index)


def on_device(device: torch.device):
    """``torch.cuda.device(device)`` for a CUDA device (a nothing context for
    the CPU): the kernels launched under it run on that device's current
    stream, as a shard's must."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def mesh_shape_for(
    n_devices: int, data_parallel: int = -1, index_parallel: int = 1
) -> tuple[int, int]:
    """Resolve (data, index) axis sizes. ``data_parallel=-1`` means "all
    devices not used by index_parallel". A mesh smaller than the device count
    is allowed (it occupies the first dp*ip devices)."""
    if index_parallel < 1 or n_devices % index_parallel:
        raise ValueError(
            f"index_parallel={index_parallel} must divide device count {n_devices}"
        )
    if data_parallel == -1:
        data_parallel = n_devices // index_parallel
    if data_parallel * index_parallel > n_devices:
        raise ValueError(
            f"mesh {data_parallel}x{index_parallel} needs more than "
            f"{n_devices} devices"
        )
    return data_parallel, index_parallel


@dataclass(frozen=True)
class Mesh:
    """A ``[dp, ip]`` grid of devices and the names of its two axes."""

    devices: tuple[tuple[torch.device, ...], ...]
    axis_names: tuple[str, str]

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return {self.axis_names[0]: len(self.devices), self.axis_names[1]: len(self.devices[0])}

    def devices_along(self, axis: str) -> list[torch.device]:
        """The devices of ``axis`` at position 0 of the other axis: where an
        array sharded over ``axis`` keeps its shards, in shard order."""
        if axis == self.axis_names[1]:
            return list(self.devices[0])
        if axis == self.axis_names[0]:
            return [row[0] for row in self.devices]
        raise ValueError(f"mesh has no axis {axis!r}")


def create_mesh(
    data_parallel: int = -1,
    index_parallel: int = 1,
    data_axis: str = "data",
    index_axis: str = "index",
    devices=None,
) -> Mesh:
    devices = list(devices) if devices is not None else local_devices("cuda")
    dp, ip = mesh_shape_for(len(devices), data_parallel, index_parallel)
    grid = tuple(tuple(devices[r * ip:(r + 1) * ip]) for r in range(dp))
    return Mesh(grid, (data_axis, index_axis))
