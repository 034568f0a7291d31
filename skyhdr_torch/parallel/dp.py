"""Data-parallel training (`skyhdr.parallel.dp`): the batch sharded over the
`data` axis, the state replicated, over `torch.distributed`.

`skyhdr`'s step is the single-device one under GSPMD: it sees the global
batch, and XLA inserts the gradient all-reduce. Here each process runs the
single-process step (`skyhdr_torch.train.engine`) on its shard, with the
hand kernels (K1-K3, and K8/K9 under fused InstanceNorm) on its own rows:
the DA conv and InstanceNorm work per sample, so that is exact. What couples
the samples of a batch is taken over the whole batch:

  C1  train-mode BatchNorm (the discriminator, SunRadNet): the sums and the
      count over every rank, through a differentiable all-reduce
      (`layers.batch_across`); the running statistics come out equal.
  C2  the sun-pose PDF scaled by its batch maximum: the all-reduced MAX,
      whose gradient (every rank's, summed) goes to the element(s) that
      hold it, split among ties, as JAX's max VJP does.
  C3  the degradation's draws: every rank draws the whole batch's from the
      same key (`utils.jax_random`) and keeps its rows.
  C4  the JPEG quality ramp over the sample index: the whole batch's ramp,
      a rank's rows of it.

The gradients are all-reduced in the place of `engine._grads`' list (the
models are not wrapped in `DistributedDataParallel`, which reduces only
`.grad`: the port takes `torch.autograd.grad`, and Grad-CAM differentiates
inside the loss): flattened into buckets, in float32, averaged over the
ranks (every loss is a batch mean), before the cast to `grad_dtype`, as
`skyhdr`'s GSPMD step reduces inside `value_and_grad` and casts after. The
metrics are reduced as the global step's: the loss means as means,
`g_out`/`b_out` as the maximum. `skyhdr`'s `_mesh_cfg` routing and
`ops/pallas/sharded.py` are TPU workarounds and have no counterpart.

On a mesh of width > 1 the batch is sharded over `data` only, as
`skyhdr`'s: the processes of one width ring compute the same rows, and the
reductions above run over the data column (`Mesh.data_group`). With
`shard_width=True` (the GAN step; `skyhdr` has no width-sharded sun step)
each process also holds its columns of the panorama (`batch_sharding(mesh,
shard_width=True)`) and the step runs in the width context of
`spatial.WidthRing` (`ops/width.py`): every layer takes its halos, sums
and gathers over the ring (`spatial.py`, `models/layers.py`), C1 and C2
take every process's rows and columns, the degradation's draws are the
whole panorama's, of which a process keeps its rows and columns (C3), and
each process's loss and gradient are its share of the batch's: the
gradients are summed over the width ring and averaged over `data`, and
the metrics likewise.
"""

from __future__ import annotations

import hashlib
import time

import torch
import torch.distributed as dist

from skyhdr_torch.models.layers import batch_across
from skyhdr_torch.parallel.mesh import (Mesh, all_reduce_, batch_sharding, broadcast_,
                                        vector_sharding)
from skyhdr_torch.parallel.spatial import WidthRing, width_across
from skyhdr_torch.train.engine import make_gan_train_step, make_sun_train_step, with_degradation

# Elements a gradient bucket holds (float32: 64 MiB); a GAN state's 280
# leaves go in a few.
BUCKET = 1 << 24
# The metrics that are batch maxima; every other metric is a batch mean.
MAX_METRICS = ("g_out", "b_out")


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the ranks; its gradient, the sum of the ranks'
    cotangents."""

    @staticmethod
    def forward(ctx, x, reduce):
        ctx.reduce = reduce
        return reduce.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.reduce.all_reduce(g.clone()), None


class _BatchMax(torch.autograd.Function):
    """m = the maximum of x over every rank's elements; the gradient, the
    ranks' cotangents summed, split evenly over the elements (on any rank)
    equal to m, as `torch.max` and JAX's reduce_max split it."""

    @staticmethod
    def forward(ctx, x, reduce):
        m = reduce.all_reduce(x.max().reshape(1).clone(), dist.ReduceOp.MAX)
        mask = x == m
        n = reduce.all_reduce(mask.sum().to(x.dtype).reshape(1))
        ctx.save_for_backward(mask, n)
        ctx.reduce = reduce
        return m.reshape(())

    @staticmethod
    def backward(ctx, g):
        mask, n = ctx.saved_tensors
        total = ctx.reduce.all_reduce(g.reshape(1).clone())
        return mask * (total / n).reshape(()), None


class BatchReduce:
    """The reductions of one data-parallel step over `mesh`'s ranks: what
    `layers.batch_across` asks of it (`sum`, `max`, `world`), the gradient
    all-reduce (`grads`) and the metrics' (`metrics`). They run over
    `group`: every process of a width-sharded step (`shard_width`), whose
    shards of the batch are its rows and columns, else the data column,
    whose shards are its rows; `world` is the number of shards (BatchNorm's
    count), `data` that of data shards (the gradients and means are summed
    over the group and divided by it). `comm_s` adds up the host seconds
    spent in collectives (with `timed`, after the device's queued work is
    finished, so that it is the collectives' share)."""

    def __init__(self, mesh: Mesh, shard_width: bool = False, ring_of_one: bool = False):
        self.mesh = mesh
        self.shard_width = shard_width
        # The width context: a ring of width > 1, or with `ring_of_one` a
        # ring of one process (its halos the shard's own opposite edge).
        self.ring = shard_width and (mesh.width > 1 or ring_of_one)
        self.group = None if shard_width or mesh.width == 1 else mesh.data_group
        self.world = mesh.data * (mesh.width if shard_width else 1)
        self.data = mesh.data
        self.timed = False
        self.comm_s = 0.0

    def all_reduce(self, t, op=dist.ReduceOp.SUM):
        """`all_reduce_` over the step's group, timed."""
        if self.timed and t.is_cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        all_reduce_(t, self.mesh, op, self.group)
        self.comm_s += time.perf_counter() - t0
        return t

    def sum(self, x):
        return _AllReduceSum.apply(x, self)

    def max(self, x):
        return _BatchMax.apply(x, self)

    def grads(self, grads, params=None):
        """The gradients summed over the group and divided by the data
        shards, in float32 (a bfloat16 gradient, of a bfloat16-stored
        parameter, upcast for the sum and rounded back), each in its own
        dtype; `params` (the parameters they belong to) is not read here. A
        list is overwritten in place, bucket by bucket."""
        out = grads if isinstance(grads, list) else list(grads)
        start = 0
        while start < len(out):
            stop, size = start, 0
            while stop < len(out) and (stop == start or size + out[stop].numel() <= BUCKET):
                size += out[stop].numel()
                stop += 1
            flat = torch.cat([g.reshape(-1).float() for g in out[start:stop]])
            self.all_reduce(flat).div_(self.data)
            at = start
            for piece in flat.split([g.numel() for g in out[start:stop]]):
                out[at] = piece.view(out[at].shape).to(out[at].dtype)
                at += 1
            start = stop
        return out

    def metrics(self, metrics: dict) -> dict:
        """The step's metrics over the whole batch: the means summed over
        the group and divided by the data shards, the MAX_METRICS the
        largest."""
        means = sorted(k for k in metrics if k not in MAX_METRICS)
        maxima = sorted(k for k in metrics if k in MAX_METRICS)
        out = {}
        for names, op in ((means, dist.ReduceOp.SUM), (maxima, dist.ReduceOp.MAX)):
            if names:
                v = self.all_reduce(torch.stack([metrics[k].float() for k in names]), op)
                if op == dist.ReduceOp.SUM:
                    v = v / self.data
                out.update({k: v[i].to(metrics[k].dtype) for i, k in enumerate(names)})
        return out


def _tensors(state):
    """Every tensor of a train state, in a fixed order: the modules'
    parameters and buffers, then the optimizers' moments (and master)."""
    out = [t for m in state.modules().values() for t in m.state_dict().values()]
    for opt in state.optimizers().values():
        for name, tensors in sorted(opt.state().items()):
            if name != "count":
                out += list(tensors)
    return out


@torch.no_grad()
def replicate_state(state, mesh: Mesh):
    """Overwrite `state` with rank 0's: parameters, buffers, moments and the
    float32 master, in place (the counts must already agree). Returns it."""
    for t in _tensors(state):
        broadcast_(t, mesh)
    return state


def state_digest(state) -> str:
    """A hash of the bits of every tensor of `state` (`_tensors`) and its
    step count: equal on two ranks exactly when their states are."""
    h = hashlib.sha256(str(state.step).encode())
    for t in _tensors(state):
        h.update(t.detach().reshape(-1).contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def replicas_agree(state, mesh: Mesh) -> bool:
    """Whether every rank's state is bit-equal to every other's (an
    all-gather of `state_digest`)."""
    digests = [None] * dist.get_world_size()
    dist.all_gather_object(digests, state_digest(state))
    return len(set(digests)) == 1


def _shard_batch(mesh: Mesh, device, shard_width: bool = False):
    rows, vec = batch_sharding(mesh, shard_width), vector_sharding(mesh)

    def shard_batch(batch):
        """This rank's rows (and with `shard_width` its columns) of a host
        batch {"hdr": [B, h, w, 3], "elevation": [B]}, on the step's
        device."""
        return {"hdr": torch.as_tensor(rows(batch["hdr"])).to(device),
                "elevation": torch.as_tensor(vec(batch["elevation"])).to(device)}

    return shard_batch


def _parallel(cfg, banks, mesh, single, reduce):
    """(step, shard_batch) of `single` (a single-process step) over `mesh`
    with `reduce`'s reductions, in the width context of `mesh`'s ring when
    `reduce.ring` (else a ring of one holds the whole panorama: no context,
    the data-parallel step)."""
    core = single.train_on
    ring = WidthRing(mesh) if reduce.ring else None

    def train_on(state, hdr_t, ldr, sunpose_gt):
        with batch_across(reduce), width_across(ring):
            state, metrics = core(state, hdr_t, ldr, sunpose_gt)
        return state, reduce.metrics(metrics)

    inner = with_degradation(cfg, banks, train_on, shard=(mesh.data_index, mesh.data))

    def step(state, batch, key):
        with width_across(ring):  # the degradation's draws are the whole panorama's
            return inner(state, batch, key)

    step.train_on, step.reduce = train_on, reduce
    return step, _shard_batch(mesh, banks.crfs.device, reduce.shard_width)


def make_parallel_gan_train_step(cfg, banks, vgg_weights, mesh: Mesh,
                                 shard_width: bool = False, *, ring_of_one: bool = False):
    """The GAN train step (`engine.make_gan_train_step`) with the batch
    sharded over `mesh`'s `data` axis, and with `shard_width` the panorama's
    width over its `width` axis. Returns (step, shard_batch): `step(state,
    shard, key)` takes this rank's rows (and columns; `shard_batch(host
    batch)`) and the step's key (`utils.jax_random`), the same on every
    rank, and returns the state, updated alike on every rank, and the whole
    batch's metrics; `step.train_on(state, hdr_t, ldr, sunpose_gt)` takes
    this rank's block of degraded inputs (sunpose_gt: its rows, whole). The
    state must start replicated (`replicate_state`). `step.reduce` is the
    step's `BatchReduce` (its `timed` and `comm_s` time the
    collectives). On a mesh of width 1 `shard_width` gives the
    data-parallel step, as `skyhdr`'s; with `ring_of_one` too, the width
    context on a ring of one (each halo the shard's own opposite edge): the
    same function through the width-aware ops, to check them on one
    process."""
    reduce = BatchReduce(mesh, shard_width, ring_of_one)
    return _parallel(cfg, banks, mesh,
                     make_gan_train_step(cfg, banks, vgg_weights, reduce.grads), reduce)


def make_parallel_sun_train_step(cfg, banks, mesh: Mesh):
    """The sun-pretrain step (`engine.make_sun_train_step`) with the batch
    sharded over `data`: (step, shard_batch), as
    `make_parallel_gan_train_step`."""
    reduce = BatchReduce(mesh)
    return _parallel(cfg, banks, mesh, make_sun_train_step(cfg, banks, reduce.grads), reduce)
