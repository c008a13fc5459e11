"""Device meshes (port of sskd_tpu/parallel/mesh.py: ``mesh_shape_for`` and
``create_mesh``).

A mesh is a ``[data, index]`` grid of devices with the JAX package's axis
names. An index sharded over the ``index`` axis keeps one shard on each
entry of that axis (:mod:`sskd_tpu_torch.index.sharded`), the layout
FAISS's ``IndexShards`` uses over the GPUs of one host.

Devices: ``create_mesh(devices=None)`` takes ``cuda:0`` .. ``cuda:n-1`` and
raises where CUDA is missing; asking for more devices than there are raises
(:func:`mesh_shape_for`), with no fallback to fewer devices or to the CPU.
A CPU mesh of N entries is made only when it is asked for:
``devices=[torch.device("cpu")] * N``, ``create_mesh(device="cpu")`` after
:func:`set_cpu_devices` (the CLI's ``--cpu-devices N``, the port's
counterpart of the JAX flag's virtual CPU devices).

Across processes: a mesh over a ``torch.distributed`` group records the
rank that owns each entry (``Mesh.ranks``), as a JAX mesh over
``jax.devices()`` after ``jax.distributed.initialize`` holds every
process's devices. ``create_mesh(devices=None)`` while a group is up lays
out every rank's :func:`local_devices` in rank order (one gather of each
rank's device names), or ``devices`` and ``ranks`` are given entry by
entry. Two
layouts are served, and any other raises ``ValueError`` naming it:

- the ``data`` axis over processes and the ``index`` axis inside one: every
  row of the grid is one rank's (a data-parallel run, row ``r`` rank
  ``r``'s; an index sharded over a rank's own devices);
- one row, the ``index`` axis over every process of the group, each rank
  owning an equal run of its entries in rank order (the layout of
  ``create_mesh(data_parallel=1, index_parallel=world * local)``): a rank
  holds only its own shards and the shards' candidates meet in one
  all-gather over the group (:mod:`sskd_tpu_torch.parallel.distributed`).

A mesh made without a group (``ranks`` None) is this process's alone. Only
a rank's own entries are touched by it; an entry names a device of its
owner's host.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch
import torch.distributed as dist

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
    """A ``[dp, ip]`` grid of devices and the names of its two axes; over a
    process group, also the rank that owns each entry."""

    devices: tuple[tuple[torch.device, ...], ...]
    axis_names: tuple[str, str]
    ranks: tuple[tuple[int, ...], ...] | None = None  # None: this process's alone

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return {self.axis_names[0]: len(self.devices), self.axis_names[1]: len(self.devices[0])}

    def devices_along(self, axis: str) -> list[torch.device]:
        """The devices of ``axis`` at position 0 of the other axis: where an
        array sharded over ``axis`` keeps its shards, in shard order."""
        return self.line_of(axis)[0]

    def line_of(self, axis: str, rank: int = 0) -> tuple[list[torch.device], list[int]]:
        """The entries of ``axis`` through ``rank``'s first entry, in order,
        and the rank that owns each: where an array sharded over ``axis``
        keeps its shards, and who holds them. A mesh of one process: the
        line at position 0 of the other axis, every entry ``rank``'s."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}")
        owners = self.ranks or tuple((rank,) * len(row) for row in self.devices)
        at = next(((i, j) for i, row in enumerate(owners) for j, r in enumerate(row) if r == rank),
                  None)
        if at is None:
            raise ValueError(f"rank {rank} owns no entry of the mesh")
        i, j = at
        if axis == self.axis_names[1]:
            return list(self.devices[i]), list(owners[i])
        return [row[j] for row in self.devices], [row[j] for row in owners]


def _group_ranks(local: list[torch.device]) -> tuple[list[torch.device], list[int]]:
    """Every rank's local entries in rank order and their owners: one gather
    of each rank's device names over the group."""
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, [str(d) for d in local])
    devices = [torch.device(n) for theirs in names for n in theirs]
    ranks = [r for r, theirs in enumerate(names) for _ in theirs]
    return devices, ranks


def _check_layout(grid: tuple[tuple[int, ...], ...], world: int) -> None:
    """Raise ``ValueError`` for a group layout the port cannot serve (see
    the module docstring); the layout is never cut down to one that fits."""
    dp, ip = len(grid), len(grid[0])
    name = f"mesh {dp}x{ip} with entries of ranks {[list(row) for row in grid]}"
    missing = sorted(set(range(world)) - {r for row in grid for r in row})
    if missing:
        raise ValueError(f"{name} over {world} processes leaves rank(s) {missing} without an "
                         "entry: every process runs the same program over the mesh")
    if all(len(set(row)) == 1 for row in grid):
        return  # the index axis inside one process
    row = list(grid[0])
    run = ip // world
    if dp == 1 and ip % world == 0 and row == [r for r in range(world) for _ in range(run)]:
        return  # the index axis over every process, equal runs in rank order
    raise ValueError(
        f"{name} over {world} processes: the port serves an index axis inside one process "
        "(every row one rank's) or over every process of the group in one row, each rank "
        "owning an equal run of entries in rank order")


def create_mesh(
    data_parallel: int = -1,
    index_parallel: int = 1,
    data_axis: str = "data",
    index_axis: str = "index",
    devices=None,
    ranks=None,
    device: str | torch.device = "cuda",
) -> Mesh:
    """The ``[data_parallel, index_parallel]`` mesh over ``devices`` (the
    first dp * ip of them). ``devices`` None: this process's
    :func:`local_devices` of ``device``'s type, or, while a process group is
    up, every rank's in rank order (a mesh over the group, as JAX's over
    ``jax.devices()``). ``ranks``: the owner of each of ``devices`` (a mesh
    over the group; needs one). A group layout the port cannot serve raises
    ``ValueError``."""
    if ranks is not None and devices is None:
        raise ValueError("ranks name the owners of the devices given; pass both")
    if devices is None:
        devices = local_devices(device)
        if dist.is_initialized():
            devices, ranks = _group_ranks(devices)
    devices = list(devices)
    dp, ip = mesh_shape_for(len(devices), data_parallel, index_parallel)
    grid = tuple(tuple(devices[r * ip:(r + 1) * ip]) for r in range(dp))
    if ranks is None:
        return Mesh(grid, (data_axis, index_axis))
    ranks = [int(r) for r in ranks]
    if len(ranks) != len(devices):
        raise ValueError(f"{len(ranks)} ranks for {len(devices)} devices")
    if not dist.is_initialized():
        raise ValueError("a mesh over a process group needs the group: call "
                         "initialize_distributed() first")
    world = dist.get_world_size()
    if not all(0 <= r < world for r in ranks):
        raise ValueError(f"ranks {sorted(set(ranks))} outside the group's 0..{world - 1}")
    owners = tuple(tuple(ranks[r * ip:(r + 1) * ip]) for r in range(dp))
    _check_layout(owners, world)
    return Mesh(grid, (data_axis, index_axis), owners)
