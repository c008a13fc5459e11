"""Process groups for data-parallel training and for an index sharded
across processes (port of ``initialize_distributed`` in
sskd_tpu/parallel/mesh.py).

The JAX package spans processes with ``jax.distributed.initialize``: after
it one global mesh holds every process's devices and a jitted step reduces
over the ``data`` axis by itself. Here the processes join a
``torch.distributed`` process group (NCCL between CUDA devices, gloo on the
CPU), and a mesh over the group records the rank that owns each entry
(:mod:`sskd_tpu_torch.parallel.mesh`): the ``data`` axis over processes,
one process a data-axis entry, or the ``index`` axis over every process of
the group, each rank holding its own shards. Rank ``r`` runs on
:func:`rank_device` ``(r)``: ``cuda:(r % devices on the host)``, so the
ranks of one host take its cards in order (NCCL refuses two ranks on one
card), or the CPU.

The collectives the trainer, the student and the sharded index need are
here: rank and world size (0 and 1 without a group), a barrier, a
broadcast of a Python object from rank 0, a sum over ranks of a list of
tensors, an all-gather along dim 0, differentiable
(``torch.distributed.nn.functional.all_gather``: its backward gives each
rank the sum over ranks of the gradient on its rows), and the all-gather of
each rank's top-k candidates that a search across processes merges
(:func:`all_gather_candidates`). They are collectives of the library, not
kernels.

Two timeouts. The training collectives (the sums and the gather) wait at
most ``timeout_s`` for the other ranks, and so does the candidates' gather: a
rank that died or took another branch fails the run rather than hanging
it. The barrier and the broadcast
are where the other ranks wait for work rank 0 does alone (preparing and
mining the data, an ANCE refresh, a checkpoint), which can take hours on a
real corpus; they run in a gloo group of their own whose timeout is
``lead_wait_s`` (a week by default). A rank 0 that dies still fails them at
once, since its sockets close.
"""

from __future__ import annotations

import datetime
import os
import warnings

import torch
import torch.distributed as dist

from sskd_tpu_torch.exceptions import ConfigError
from sskd_tpu_torch.parallel.mesh import Mesh, create_mesh, same_device
from sskd_tpu_torch.utils.platform import resolve_device

# how long a training collective (or the rendezvous) waits for the other
# ranks before it raises: a rank that died or took another branch fails the
# run, not hangs it
DEFAULT_TIMEOUT_S = 600.0
# how long the barrier and the broadcast wait for rank 0's work alone
LEAD_WAIT_TIMEOUT_S = 7 * 24 * 3600.0

# the gloo group of the barrier and the broadcast (None: the default group)
_lead_group = None


def _env_int(name: str) -> int | None:
    value = os.environ.get(name)
    return None if value is None else int(value)


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str | torch.device = "cuda",
    timeout_s: float = DEFAULT_TIMEOUT_S,
    lead_wait_s: float = LEAD_WAIT_TIMEOUT_S,
) -> bool:
    """Join the process group of a multi-process run. Arguments default to
    ``SSKD_COORDINATOR`` (``host:port`` of rank 0), ``SSKD_NUM_PROCESSES``
    and ``SSKD_PROCESS_ID``, as in the JAX package. Returns False, and
    creates no group, when neither an address nor a process count is given;
    True once the group is up (or was already).

    ``device`` picks the backend: NCCL on CUDA, with this rank's device
    (:func:`rank_device`) made current first; gloo only when ``"cpu"`` is
    asked for. CUDA asked for and missing raises ``RuntimeError``. The
    rendezvous and the training collectives wait at most ``timeout_s``
    seconds, :func:`barrier` and :func:`broadcast_object` at most
    ``lead_wait_s``."""
    global _lead_group
    coordinator_address = coordinator_address or os.environ.get("SSKD_COORDINATOR")
    if num_processes is None:
        num_processes = _env_int("SSKD_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("SSKD_PROCESS_ID")
    if coordinator_address is None and num_processes is None:
        return False
    if dist.is_initialized():
        return True
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a process group needs the coordinator's address, the process count and this "
            "process's id (SSKD_COORDINATOR, SSKD_NUM_PROCESSES, SSKD_PROCESS_ID); got "
            f"{coordinator_address!r}, {num_processes!r}, {process_id!r}"
        )
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside 0..{num_processes - 1}")
    dev = resolve_device(device)
    bound = {}
    if dev.type == "cuda":  # NCCL binds the rank to its device
        bound["device_id"] = rank_device(process_id, dev)
        torch.cuda.set_device(bound["device_id"])
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
        **bound,
    )
    _lead_group = dist.new_group(backend="gloo",
                                 timeout=datetime.timedelta(seconds=lead_wait_s))
    return True


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device(r: int, device: str | torch.device = "cuda") -> torch.device:
    """Where rank ``r`` runs: the CPU, or ``cuda:(r % devices on the host)``."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", r % torch.cuda.device_count())


def process_mesh(device: str | torch.device = "cuda") -> Mesh:
    """The ``[world, 1]`` mesh of a data-parallel run: row ``r`` holds rank
    ``r``'s device (without a group, ``[[device]]``)."""
    return create_mesh(data_parallel=world_size(), index_parallel=1,
                       devices=[rank_device(r, device) for r in range(world_size())])


def data_axis_rank(mesh: Mesh, device, axis: str | None = None) -> tuple[int, int]:
    """(rank, entries) of this process on ``axis`` of ``mesh`` (default: its
    data axis, the first), whose entries must be this run's processes, one
    each, with this rank's entry its ``device``; else ``ConfigError``."""
    axis = axis or mesh.axis_names[0]
    dp, world, r = mesh.shape[axis], world_size(), rank()
    if dp != world:
        raise ConfigError(
            f"mesh axis {axis!r} has {dp} entries but this run has {world} process(es): "
            "data-parallel work runs one process per entry. Start them with "
            f"`semantic-kd-torch train --data-parallel {dp}`, or set SSKD_COORDINATOR, "
            f"SSKD_NUM_PROCESSES={dp} and SSKD_PROCESS_ID in each and call "
            "initialize_distributed() first"
        )
    entry = mesh.devices_along(axis)[r]
    if not same_device(entry, device):
        raise ConfigError(f"rank {r} runs on its mesh entry {entry}, but its model is on {device}")
    return r, dp


def barrier() -> None:
    """Every rank waits here for the others, for as long as rank 0's work
    alone may take (``lead_wait_s``)."""
    if dist.is_initialized():
        dist.barrier(group=_lead_group)


def broadcast_object(obj):
    """Rank 0's ``obj`` on every rank (``obj`` itself without a group); the
    others wait for it as :func:`barrier` does."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=_lead_group)
    return box[0]


def all_reduce_sum_(tensors: list[torch.Tensor]) -> None:
    """Sum each tensor over the ranks, in place, in one collective (over a
    flat copy when there are several); every rank then holds the same bits."""
    if not dist.is_initialized() or not tensors:
        return
    if len(tensors) == 1 and tensors[0].is_contiguous():
        dist.all_reduce(tensors[0], op=dist.ReduceOp.SUM)
        return
    flat = torch._utils._flatten_dense_tensors(tensors)
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    torch._foreach_copy_(tensors, torch._utils._unflatten_dense_tensors(flat, tensors))


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` concatenated along dim 0 in rank order (``x``
    itself without a group). Differentiable: the backward gives each rank
    the sum over ranks of the gradient on its own rows."""
    if not dist.is_initialized():
        return x
    if not x.requires_grad:
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
        dist.all_gather(parts, x.contiguous())
        return torch.cat(parts, dim=0)
    from torch.distributed.nn.functional import all_gather

    with warnings.catch_warnings():  # the library marks its autograd collectives deprecated
        warnings.simplefilter("ignore")
        return torch.cat(all_gather(x.contiguous()), dim=0)


# the device a collective's tensors cross on, by the group's backend
_WIRE = {"nccl": lambda: torch.device("cuda", torch.cuda.current_device()),
         "gloo": lambda: torch.device("cpu")}


def all_gather_candidates(vals: torch.Tensor, idx: torch.Tensor) -> tuple[torch.Tensor,
                                                                          torch.Tensor]:
    """Every rank's ``[B, m]`` candidate scores (f32) and positions (int32),
    concatenated along dim 1 in rank order, on ``vals``'s device: the layout
    of ``all_gather(..., axis=1, tiled=True)`` over the ranks. One
    collective: the scores ride beside the positions as their int32 bits. The
    tensors cross on the device of the group's backend: this rank's CUDA
    device for NCCL, the CPU for gloo. Every rank must call it with the same
    ``[B, m]``; a rank that does not come fails the others after the
    group's timeout."""
    if not dist.is_initialized():
        raise RuntimeError("a search across processes needs the process group: call "
                           "initialize_distributed() first")
    backend = dist.get_backend()
    if backend not in _WIRE:
        raise ValueError(f"no candidate gather over a {backend!r} group (nccl or gloo)")
    packed = torch.stack([vals.to(torch.float32).view(torch.int32), idx.to(torch.int32)])
    parts = all_gather_rows(packed[None].to(_WIRE[backend]()))  # [world, 2, B, m]
    both = parts.permute(1, 2, 0, 3).reshape(2, vals.shape[0], -1).to(vals.device)
    return both[0].view(torch.float32), both[1]
