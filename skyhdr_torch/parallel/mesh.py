"""Process groups and batch placement (`skyhdr.parallel.mesh`), over
`torch.distributed`.

Axis conventions, as in `skyhdr`:
  * `data`  — the batch dimension: each process holds a shard of the batch
    (and a replica of the state, or under `fsdp.py` a shard of it);
  * `width` — the panorama width (spatial parallelism): the processes of
    one data row form a ring over the width (`spatial.py`).

The process of rank r sits at (data_index, width_index) = divmod(r, width),
as `skyhdr.parallel.mesh.make_mesh` lays its devices out row by row. Where
`skyhdr` places arrays on a device mesh with a sharding, a process here
takes its rows (and width columns) of a host batch (`batch_sharding`,
`vector_sharding`) and receives rank 0's copy of a replicated tensor
(`replicated`). Collectives on CUDA tensors under gloo go through host
memory (`all_reduce_`, `broadcast_`, `all_gather_`, `reduce_scatter_`,
`spatial.py`'s ring): gloo is how two processes share one card, where NCCL
refuses two ranks on one device.
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
    process's rank, its coordinates, the group's backend, the process group
    of this process's width ring (its data row; None: every process) and
    that of its data column (the processes of its width index; None: every
    process). A width-sharded step reduces over the width ring (a
    panorama's columns), the data column (`fsdp.py`'s blocks) and every
    process (BatchNorm, the batch maximum, the losses, the gradients)."""

    data: int
    width: int
    rank: int
    backend: str
    width_group: object = None
    data_group: object = None

    @property
    def data_index(self) -> int:
        return self.rank // self.width

    @property
    def width_index(self) -> int:
        return self.rank % self.width

    def width_peer(self, step: int) -> int:
        """The rank `step` places along this process's width ring
        ((width_index + step) mod width, in its data row)."""
        return self.data_index * self.width + (self.width_index + step) % self.width


def make_mesh(data: int = 0, width: int = 1) -> Mesh:
    """A (data, width) mesh over the initialised process group; data=0 means
    every process over `width`."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: call initialize_distributed first")
    n = dist.get_world_size()
    if width < 1 or n % width:
        raise ValueError(f"a width of {width} over {n} processes")
    if data == 0:
        data = n // width
    if data * width != n:
        raise ValueError(f"a {data}x{width} mesh over {n} processes")
    rank, row, column = dist.get_rank(), None, None
    # Every process creates every row's and column's group, in the same
    # order (a column of one process where data == 1).
    if data > 1 and width > 1:
        rows = [dist.new_group(list(range(d * width, (d + 1) * width))) for d in range(data)]
        row = rows[rank // width]
    if width > 1:
        columns = [dist.new_group(list(range(i, n, width))) for i in range(width)]
        column = columns[rank % width]
    return Mesh(data, width, rank, dist.get_backend(), row, column)


def _rows(mesh: Mesh, t):
    b = t.shape[0]
    if b % mesh.data:
        raise ValueError(f"a batch of {b} over {mesh.data} data shards")
    n = b // mesh.data
    return t[mesh.data_index * n:(mesh.data_index + 1) * n]


def _cols(mesh: Mesh, t):
    w = t.shape[2]
    if w % mesh.width:
        raise ValueError(f"a width of {w} over {mesh.width} width shards")
    n = w // mesh.width
    return t[:, :, mesh.width_index * n:(mesh.width_index + 1) * n]


def batch_sharding(mesh: Mesh, shard_width: bool = False):
    """[b, h, w, c] batches: a function that takes this process's rows of a
    host batch (the batch over `data`) and, with `shard_width`, its columns
    of them (the width over `width`)."""
    if shard_width:
        return lambda t: _cols(mesh, _rows(mesh, t))
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


def all_reduce_(t: torch.Tensor, mesh: Mesh, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    """`dist.all_reduce` over `group` (default every process) in place
    (through host memory for a CUDA tensor under gloo); every rank of the
    group ends with the same bits."""
    if _via_host(mesh, t):
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
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


def all_gather_(shard: torch.Tensor, mesh: Mesh, group=None) -> torch.Tensor:
    """`dist.all_gather_into_tensor` over `group` (default every process):
    the ranks' `shard`s stacked along dimension 0, in rank order, in the
    shard's dtype (its bytes travel, as uint8: gloo takes no 2-byte types;
    through host memory for a CUDA tensor under gloo)."""
    shard = shard.contiguous()
    out = shard.new_empty((shard.shape[0] * dist.get_world_size(group), *shard.shape[1:]))
    src, dst = shard.view(torch.uint8), out.view(torch.uint8)
    if _via_host(mesh, shard):
        host = dst.new_empty(dst.shape, device="cpu")
        dist.all_gather_into_tensor(host, src.cpu(), group=group)
        dst.copy_(host)
    else:
        dist.all_gather_into_tensor(dst, src, group=group)
    return out


def reduce_scatter_(t: torch.Tensor, mesh: Mesh, group=None) -> torch.Tensor:
    """`dist.reduce_scatter_tensor` (SUM) over `group` (default every
    process): this rank's block of dimension 0 of the ranks' `t`s summed
    (through host memory for a CUDA tensor under gloo)."""
    t = t.contiguous()
    n = dist.get_world_size(group)
    if t.shape[0] % n:
        raise ValueError(f"reduce_scatter_: {t.shape[0]} rows over {n} processes")
    out = t.new_empty((t.shape[0] // n, *t.shape[1:]))
    if _via_host(mesh, t):
        host = out.new_empty(out.shape, device="cpu")
        dist.reduce_scatter_tensor(host, t.cpu(), group=group)
        out.copy_(host)
    else:
        dist.reduce_scatter_tensor(out, t, group=group)
    return out
