"""Process groups and batch placement (`skyhdr.parallel.mesh`), over
`torch.distributed`.

Axis conventions, as in `skyhdr`:
  * `data`  — the batch dimension: each process holds a shard of the batch
    and a replica of the state;
  * `width` — the panorama width (spatial parallelism); 1 until the ring
    halo (`skyhdr.parallel.spatial`) is ported.

Where `skyhdr` places arrays on a device mesh with a sharding, a process
here takes its rows of a host batch (`batch_sharding`, `vector_sharding`)
and receives rank 0's copy of a replicated tensor (`replicated`).
Collectives on CUDA tensors under gloo go through host memory
(`all_reduce_`, `broadcast_`): gloo is how two processes share one card,
where NCCL refuses two ranks on one device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist


def initialize_distributed(init_method: str, world_size: int, rank: int,
                           device="cuda", backend: Optional[str] = None) -> str:
    """Join the process group (`torch.distributed.init_process_group`) and
    return its backend: NCCL for a CUDA `device`, gloo for the CPU, or
    `backend` where the caller names one (gloo for several ranks on one
    card). No fallback from one backend to the other. `init_method` is
    explicit: `file://<path>` (the tests, under their temporary directory)
    or `tcp://localhost:<port>`."""
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: nccl or gloo")
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank)
    return backend


class Mesh(NamedTuple):
    """A (data, width) layout of the processes of the default group: this
    process's rank, its coordinates and the group's backend."""

    data: int
    width: int
    rank: int
    backend: str

    @property
    def data_index(self) -> int:
        return self.rank // self.width


def make_mesh(data: int = 0, width: int = 1) -> Mesh:
    """A (data, width) mesh over the initialised process group; data=0 means
    every process. `width` must be 1 (spatial parallelism is not ported)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: call initialize_distributed first")
    if width != 1:
        raise NotImplementedError("width > 1 needs skyhdr.parallel.spatial, not ported")
    n = dist.get_world_size()
    if data == 0:
        data = n // width
    if data * width != n:
        raise ValueError(f"a {data}x{width} mesh over {n} processes")
    return Mesh(data, width, dist.get_rank(), dist.get_backend())


def _rows(mesh: Mesh, t):
    b = t.shape[0]
    if b % mesh.data:
        raise ValueError(f"a batch of {b} over {mesh.data} data shards")
    n = b // mesh.data
    return t[mesh.data_index * n:(mesh.data_index + 1) * n]


def batch_sharding(mesh: Mesh):
    """[b, h, w, c] batches: a function that takes this process's rows of a
    host batch (the batch over `data`; `skyhdr`'s width sharding waits for
    `spatial.py`)."""
    return lambda t: _rows(mesh, t)


def vector_sharding(mesh: Mesh):
    """[b] per-sample scalars (elevations): this process's rows."""
    return lambda t: _rows(mesh, t)


def replicated(mesh: Mesh):
    """A function that overwrites a tensor with rank 0's copy, in place, and
    returns it."""
    return lambda t: broadcast_(t, mesh)


def _via_host(mesh: Mesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.is_cuda


def all_reduce_(t: torch.Tensor, mesh: Mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """`dist.all_reduce` in place (through host memory for a CUDA tensor
    under gloo); every rank ends with the same bits."""
    if _via_host(mesh, t):
        host = t.cpu()
        dist.all_reduce(host, op=op)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op)
    return t


def broadcast_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """`dist.broadcast` from rank 0 in place (through host memory for a CUDA
    tensor under gloo)."""
    with torch.no_grad():
        if _via_host(mesh, t):
            host = t.cpu()
            dist.broadcast(host, 0)
            t.copy_(host)
        else:
            dist.broadcast(t, 0)
    return t
