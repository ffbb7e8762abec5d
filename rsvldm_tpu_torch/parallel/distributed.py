"""Multi-process runtime (rsvldm_tpu/parallel/distributed.py): process
init, the global mesh, each rank's rows, and the collectives the port uses.

The port runs one process per device, every process the same program
(torch.distributed). JAX's design (one process per host, XLA inserting the
collectives from sharding annotations) becomes explicit collectives over
the groups of a `DeviceMesh` with dims ("data", "tile"):

1. `init_distributed()`: `init_process_group` with a tcp:// rendezvous
   from RSVLDM_COORDINATOR=host:port, RSVLDM_NUM_PROCESSES=N and
   RSVLDM_PROCESS_ID=i (idempotent; a no-op that returns False without
   them; RSVLDM_DISTRIBUTED=1 reads torchrun's env:// instead). Backend:
   NCCL on CUDA, gloo on the CPU, or the one named by `backend=` or
   RSVLDM_BACKEND (two ranks on one card run over gloo: NCCL refuses two
   ranks on one device).
2. `make_global_mesh(tile)`: a (data, tile) mesh over every rank, the
   'tile' groups (whose GroupNorm statistics are all-reduced at every
   tiled-VAE norm) inside one host, 'data' across hosts.
3. `local_batch_range` / `from_process_local`: each rank loads only its
   rows of the global batch; nothing is assembled.

Collectives (`all_reduce`, `all_gather`, `broadcast`) take tensors on the
rank's device. Over gloo, CUDA tensors are staged through host memory
here, explicitly, and the result copied back to the device.
"""

from __future__ import annotations

import os
import socket
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

ReduceOp = dist.ReduceOp


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def default_backend() -> str:
    return os.environ.get("RSVLDM_BACKEND") or (
        "nccl" if torch.cuda.is_available() else "gloo")


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> bool:
    """Join the multi-process runtime (idempotent, env-gated). Explicit
    arguments win; otherwise the RSVLDM_* env above; otherwise a no-op
    returning False. With NCCL each rank takes device process_id modulo
    the local device count. Returns True when this process is part of a
    process group after the call."""
    if dist.is_initialized():
        return True
    env = os.environ
    if coordinator is None and env.get("RSVLDM_COORDINATOR"):
        coordinator = env["RSVLDM_COORDINATOR"]
        num_processes = int(env["RSVLDM_NUM_PROCESSES"])
        process_id = int(env["RSVLDM_PROCESS_ID"])
    backend = backend or default_backend()
    if coordinator is not None:
        init = f"tcp://{coordinator}"
    elif env.get("RSVLDM_DISTRIBUTED"):
        init = "env://"   # torchrun: MASTER_ADDR, WORLD_SIZE, RANK
        num_processes = int(env["WORLD_SIZE"])
        process_id = int(env["RANK"])
    else:
        return False
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id)
    return True


def init_world_of_one(backend: str | None = None) -> None:
    """A process group of this process alone, on a free localhost port
    (a mesh of one rank; no-op when a group exists)."""
    if not dist.is_initialized():
        init_distributed(f"127.0.0.1:{_free_port()}", 1, 0, backend)


def world() -> tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def local_world_size() -> int:
    """Ranks on this host: LOCAL_WORLD_SIZE when set, else the card count
    under NCCL (one rank per card), else the whole world (gloo ranks are
    taken to share one host)."""
    if os.environ.get("LOCAL_WORLD_SIZE"):
        return int(os.environ["LOCAL_WORLD_SIZE"])
    n = world()[1]
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return max(min(torch.cuda.device_count(), n), 1)
    return n


def _order_data_axis_by_process(arr: np.ndarray) -> np.ndarray:
    """Sort the rows of a (data, tile) array of ranks so that ranks never
    decrease along its flattened traversal, then check that invariant.

    Per-rank feeding (local_batch_range) maps global rows [i*per,
    (i+1)*per) to rank i: valid only when the flattened mesh is in rank
    order. A whole-row permutation keeps every tile group intact; where
    sorting cannot restore the order, RuntimeError."""
    arr = np.asarray(arr)
    arr = arr[np.argsort(arr.min(axis=1), kind="stable")]
    if np.any(np.diff(arr.reshape(-1)) < 0):
        raise RuntimeError(
            "global mesh 'data' axis is not process-contiguous even after "
            "row sort — per-host batch feeding (local_batch_range/"
            "from_process_local) would mis-place rows on this topology; "
            "build the mesh explicitly via parallel.mesh.make_mesh")
    return arr


def mesh_from_ranks(arr: np.ndarray, backend: str | None = None):
    """A DeviceMesh ("data", "tile") over the ranks of `arr` (every rank
    of the world, in process order). Device type cuda under NCCL, else
    cpu: the port uses the mesh's process groups, not DTensor placements,
    so a gloo mesh also carries CUDA tensors (through `all_reduce` & co)."""
    from torch.distributed.device_mesh import DeviceMesh
    backend = backend or dist.get_backend()
    dev = "cuda" if backend == "nccl" else "cpu"
    return DeviceMesh(dev, torch.as_tensor(_order_data_axis_by_process(arr)),
                      mesh_dim_names=("data", "tile"))


def make_global_mesh(tile: int = 1):
    """(data, tile) mesh over every rank, the 'tile' groups inside one host.
    A world of one is made when no process group exists."""
    init_world_of_one()
    n = world()[1]
    if tile > 1:
        per_host = max(local_world_size(), 1)
        if per_host % tile and tile % per_host:
            raise ValueError(f"tile={tile} does not pack into hosts of "
                             f"{per_host} devices — the tile-GN pmean "
                             "would cross hosts")
    if n % tile:
        raise ValueError(f"tile={tile} must divide the device count {n}")
    # ranks are in process order, so the trailing (fast) axis keeps each
    # tile group within one host when tile <= per_host
    return mesh_from_ranks(np.arange(n).reshape(n // tile, tile))


class LocalRows(NamedTuple):
    """This rank's rows of a global batch and the global index of the
    first."""
    rows: object
    offset: int


def from_process_local(local, global_batch: int | None = None) -> LocalRows:
    """This rank's loaded rows with their global offset (JAX assembles a
    global array here; the port keeps the rows local and says where they
    sit). global_batch, when given, is checked against the rank count."""
    n = len(local)
    if global_batch is not None and n * world()[1] != global_batch:
        raise ValueError(f"{n} local rows x {world()[1]} ranks != global "
                         f"batch {global_batch}")
    return LocalRows(local, world()[0] * n)


def local_batch_range(global_batch: int) -> tuple[int, int]:
    """[start, stop) of the global batch this rank loads (an even split;
    the global batch must divide)."""
    rank, n = world()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} must divide across "
                         f"{n} processes")
    per = global_batch // n
    return rank * per, (rank + 1) * per


# ------------------------------------------------------------ collectives
def _staged(group) -> bool:
    return dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group, op=ReduceOp.SUM) -> torch.Tensor:
    """In place over `group`; returns t. Over gloo a CUDA tensor goes
    through host memory."""
    if t.is_cuda and _staged(group):
        h = t.cpu()
        dist.all_reduce(h, op=op, group=group)
        t.copy_(h)
        return t
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's `t` (equal shapes) concatenated along `dim` in group
    rank order."""
    n = dist.get_world_size(group)
    src = t.cpu() if t.is_cuda and _staged(group) else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def broadcast(t: torch.Tensor, group, src_rank: int = 0) -> torch.Tensor:
    """In place from the group's rank `src_rank`; returns t."""
    src = dist.get_global_rank(group, src_rank) if group is not None else src_rank
    if t.is_cuda and _staged(group):
        h = t.cpu()
        dist.broadcast(h, src, group=group)
        t.copy_(h)
        return t
    dist.broadcast(t, src, group=group)
    return t
