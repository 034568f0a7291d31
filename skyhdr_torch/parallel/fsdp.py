"""ZeRO-3 sharded train state over the `data` axis (`skyhdr.parallel.fsdp`),
over `torch.distributed`.

`skyhdr` marks each big leaf of its train state `P(..., "data", ...)` and
lets GSPMD insert the all-gather and the reduce-scatter around the
single-device step. Here each process keeps, at rest, only its block of
every planned tensor and runs the data-parallel step of `dp.py` around it:

  1. the planned parameters (and BatchNorm buffers) are all-gathered into
     full tensors, in their stored dtype;
  2. the single-process forward and backward run on the rank's rows, with
     `dp.py`'s batch couplings C1-C4 (`dp._parallel`, `BatchReduce`,
     `layers.batch_across`);
  3. the gradients are reduced in float32 before the `grad_dtype` cast: a
     parameter whose group is sharded gets its block of the mean through a
     reduce-scatter, every other one `BatchReduce`'s bucketed all-reduce;
  4. `train/optim.py`'s optimizer, its lists rewritten to the blocks,
     updates each sharded group's blocks (parameter, moments, float32
     master) in place; a member of such a group that the plan keeps whole
     (a bfloat16 moment under a float32 parameter, say) is updated on its
     block too and all-gathered back, as GSPMD would;
  5. the gathered full tensors are dropped again.

The plan (`fsdp_plan`) is `skyhdr`'s `_leaf_spec`, leaf by leaf: a tensor is
sharded when it holds at least `min_bytes` in its own stored dtype, along
the LAST dimension of its Flax leaf that the rank count divides. It is read
from shapes and dtypes alone, so a state built on the "meta" device plans a
64x256 state without allocating it. A parameter, its moments and its master
share one shape and so one dimension. The models are not wrapped in
`FullyShardedDataParallel` (`fully_shard`): the port takes
`torch.autograd.grad`, and Grad-CAM differentiates inside the loss.

A block of a dimension other than the tensor's first is stored with that
dimension moved to the front, so that the all-gather (which stacks blocks
along dimension 0) returns the tensor with that dimension first. The
optimizers are elementwise, so an update on blocks gives the bits of the
update on the whole tensor, and at two ranks the mean of a reduce-scatter
is the all-reduce's (a sum of two numbers is the same in either order):
the steps are bit-equal to `dp.py`'s.

On a mesh of width > 1 the state is sharded over `data` only and
replicated over `width`, as `skyhdr`'s `fsdp_state_sharding` reads
`mesh.shape["data"]`: the all-gathers and reduce-scatters run over the
data column (`Mesh.data_group`). With `shard_width=True` (the GAN step) the
step is `dp.py`'s width-sharded one, each process's gradients its columns'
share: they are summed over the width ring and then reduce-scattered (the
sharded groups) or all-reduced (the rest) over `data`.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch

from skyhdr_torch.parallel.dp import BatchReduce, _parallel
from skyhdr_torch.parallel.mesh import Mesh, all_gather_, all_reduce_, reduce_scatter_
from skyhdr_torch.train.convert import state_rows
from skyhdr_torch.train.engine import make_gan_train_step, make_sun_train_step
from skyhdr_torch.utils.transplant import _flax_shape, _leaf_modules

# Tensors smaller than this stay replicated (`skyhdr`'s DEFAULT_MIN_BYTES).
DEFAULT_MIN_BYTES = 1 << 20
# Flax dimension -> torch dimension of each layout of `flax_leaves`: a conv
# kernel [kh, kw, in, out] is [out, in, kh, kw], a Dense kernel [in, out] is
# [out, in].
_TORCH_DIM = {"hwio": (2, 3, 1, 0), "dense": (1, 0)}


class Split(NamedTuple):
    """The sharded dimension of one tensor: of its Flax leaf (`skyhdr`'s
    plan) and of the torch tensor."""

    flax: int
    dim: int


def leaf_split(flax_shape, nbytes: int, n_shards: int, layout: str,
               min_bytes: int = DEFAULT_MIN_BYTES) -> Optional[Split]:
    """`skyhdr.parallel.fsdp._leaf_spec` of one leaf: the last dimension of
    the Flax shape that `n_shards` divides (and is at least), when the leaf
    holds `min_bytes`; None (replicated) otherwise."""
    if not flax_shape or nbytes < min_bytes:
        return None
    for d in reversed(range(len(flax_shape))):
        if flax_shape[d] >= n_shards and flax_shape[d] % n_shards == 0:
            return Split(d, _TORCH_DIM[layout][d] if layout in _TORCH_DIM else d)
    return None


def _members(opt, name: str) -> list:
    """The optimizer's list of `name`: its parameters, a moment or the
    master."""
    return opt.params if name == "params" else getattr(opt, name)


def state_leaves(state):
    """[(Flax path, layout, tensor, slot)] of every tensor of a replicated
    `state`, in the export's order (`convert.state_rows`): slot is
    ("group", optimizer, index, member) for a parameter ("params"), its
    moment or its master, and ("buffer", module, name) for a BatchNorm
    statistic."""
    index = {id(p): (opt, i) for opt in state.optimizers().values()
             for i, p in enumerate(opt.params)}
    out = []
    for prefix, module, colls, opt, name in state_rows(state):
        for path, mod in _leaf_modules(module):
            for coll, leaf, tensor, layout, _ in mod.flax_leaves():
                if coll not in colls:
                    continue
                if opt is None and coll == "batch_stats":
                    out.append(("/".join([prefix, coll, *path, leaf]), layout, tensor,
                                ("buffer", mod, leaf)))
                    continue
                owner, i = index[id(tensor)]
                member = "params" if opt is None else name
                key = [prefix, coll, *path, leaf] if opt is None else [prefix, *path, leaf]
                out.append(("/".join(key), layout, _members(owner, member)[i],
                            ("group", owner, i, member)))
    return out


def fsdp_plan(state, mesh: Mesh, min_bytes: int = DEFAULT_MIN_BYTES) -> dict:
    """{Flax path: Split or None} of every tensor of a GanState or SunState
    (parameters, BatchNorm buffers, moments, the float32 master) over
    `mesh`'s data axis: `skyhdr`'s `fsdp_state_sharding`, from shapes and
    dtypes alone (a state on the "meta" device will do)."""
    return {path: leaf_split(_flax_shape(t, layout), t.numel() * t.element_size(), mesh.data,
                             layout, min_bytes)
            for path, layout, t, _ in state_leaves(state)}


def _block(t: torch.Tensor, dim: int, rank: int, n: int) -> torch.Tensor:
    """A contiguous copy of rank `rank`'s block of `t` along `dim`, that
    dimension moved to the front."""
    size = t.shape[dim] // n
    return t.detach().narrow(dim, rank * size, size).movedim(dim, 0).clone(
        memory_format=torch.contiguous_format)


class _Group:
    """One parameter and its optimizer tensors: the members the plan
    shards ({member: path}), the members it keeps whole, and the dimension
    (None: the group is replicated)."""

    def __init__(self, opt, index: int):
        self.opt, self.index = opt, index
        self.param = opt.params[index]
        self.planned, self.whole, self.dim = {}, {}, None


class FsdpReduce(BatchReduce):
    """`BatchReduce` of an FSDP step: the gradients of a sharded group
    reduce-scattered over the data column (the rank's block of the mean, in
    float32; under `shard_width` summed over the width ring first), the
    rest all-reduced in buckets; and the all-gathers over the data column,
    timed as the other collectives. `layout` is the sharded state's, set
    for the step."""

    layout = None

    def _timed(self, fn, t, group="data"):
        if self.timed and t.is_cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        out = fn(t, self.mesh, group=self.mesh.data_group if group == "data" else group)
        self.comm_s += time.perf_counter() - t0
        return out

    def gather(self, block: torch.Tensor, dim: int) -> torch.Tensor:
        """The full tensor of the data column's blocks along `dim`."""
        return self._timed(all_gather_, block).movedim(0, dim).contiguous()

    def scatter(self, g: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's block along `dim` of `g` averaged over the data
        shards (summed over the width ring first under `shard_width`), in
        float32, the dimension moved to the front."""
        g = g.float().movedim(dim, 0)
        if self.shard_width and self.mesh.width > 1:
            g = self._timed(all_reduce_, g.contiguous(), self.mesh.width_group)
        return self._timed(reduce_scatter_, g).div_(self.data)

    def grads(self, grads, params=None):
        sharded = self.layout.sharded
        out = grads if isinstance(grads, list) else list(grads)
        whole = [i for i, p in enumerate(params) if id(p) not in sharded]
        for i, g in zip(whole, super().grads([out[i] for i in whole])):
            out[i] = g
        for i, p in enumerate(params):
            group = sharded.get(id(p))
            if group is not None:
                out[i] = self.scatter(out[i], group.dim).to(out[i].dtype)
        return out


class _Layout:
    """A sharded state's blocks: its groups and BatchNorm buffers, each
    tensor's path, and the gathers and releases of a step."""

    def __init__(self, state, mesh: Mesh, plan: dict, reduce: FsdpReduce):
        self.mesh, self.reduce = mesh, reduce
        self.n, self.rank = mesh.data, mesh.data_index
        self.buffers = []  # [(path, module, name, dim)] of the planned buffers
        self.whole_buffers = {}  # path -> (module, name) of the others
        groups = {}
        for path, _, _, slot in state_leaves(state):
            split = plan[path]
            if slot[0] == "buffer":
                if split is None:
                    self.whole_buffers[path] = slot[1:]
                else:
                    self.buffers.append((path, slot[1], slot[2], split.dim))
                continue
            _, opt, i, member = slot
            group = groups.setdefault((id(opt), i), _Group(opt, i))
            if split is None:
                group.whole[member] = path
            else:
                group.planned[member] = path
                group.dim = split.dim
        self.groups = list(groups.values())
        self.sharded = {id(g.param): g for g in self.groups if g.planned}

    @torch.no_grad()
    def shard(self) -> None:
        """Keep this rank's block of every planned tensor; drop the rest."""
        for g in self.sharded.values():
            for member in g.planned:
                lst = _members(g.opt, member)
                lst[g.index] = _block(lst[g.index], g.dim, self.rank, self.n)
            if "params" in g.planned:
                g.param.data = g.opt.params[g.index]
        for _, mod, name, dim in self.buffers:
            mod._buffers[name] = _block(mod._buffers[name], dim, self.rank, self.n)

    @torch.no_grad()
    def gather(self) -> None:
        """Give every planned parameter and buffer its full tensor."""
        for g in self.sharded.values():
            if "params" in g.planned:
                g.param.data = self.reduce.gather(g.opt.params[g.index], g.dim)
        for _, mod, name, dim in self.buffers:
            mod._buffers[name] = self.reduce.gather(mod._buffers[name], dim)

    def release(self, params=None) -> None:
        """Point the planned parameters among `params` (default: all) back
        at their blocks, dropping the full tensors."""
        for p in self.sharded if params is None else map(id, params):
            g = self.sharded.get(p)
            if g is not None and "params" in g.planned:
                g.param.data = g.opt.params[g.index]

    @torch.no_grad()
    def release_buffers(self) -> None:
        """Keep this rank's block of every planned buffer again (the step
        updated the full ones alike on every rank)."""
        for _, mod, name, dim in self.buffers:
            mod._buffers[name] = _block(mod._buffers[name], dim, self.rank, self.n)

    @torch.no_grad()
    def unshard(self) -> None:
        """Every planned tensor whole again (the inverse of `shard`)."""
        for g in self.sharded.values():
            for member in g.planned:
                lst = _members(g.opt, member)
                lst[g.index] = self.reduce.gather(lst[g.index], g.dim)
            if "params" in g.planned:
                g.param.data = g.opt.params[g.index]
                g.opt.params[g.index] = g.param
        for _, mod, name, dim in self.buffers:
            mod._buffers[name] = self.reduce.gather(mod._buffers[name], dim)

    def resident(self) -> dict:
        """{path: shape} of the tensor this rank holds for each tensor of
        the state."""
        out = {path: tuple(mod._buffers[name].shape)
               for path, (mod, name) in self.whole_buffers.items()}
        out.update({path: tuple(mod._buffers[name].shape) for path, mod, name, _ in self.buffers})
        for g in self.groups:
            for member, path in {**g.planned, **g.whole}.items():
                out[path] = tuple(_members(g.opt, member)[g.index].shape)
        return out

    def resident_bytes(self) -> int:
        """The bytes of every tensor this rank holds for the state."""
        seen, total = set(), 0
        tensors = [mod._buffers[name] for mod, name in self.whole_buffers.values()]
        tensors += [mod._buffers[name] for _, mod, name, _ in self.buffers]
        tensors += [_members(g.opt, m)[g.index] for g in self.groups for m in {**g.planned,
                                                                               **g.whole}]
        for t in tensors:
            if t.data_ptr() not in seen:
                seen.add(t.data_ptr())
                total += t.numel() * t.element_size()
        return total


class ShardedOptimizer:
    """The optimizer of a sharded state, as the train step sees it:
    `params` are the modules' parameters (autograd's targets) and
    `step(grads)` takes a sharded group's gradient as its block; `inner` is
    the optimizer over the blocks."""

    def __init__(self, inner, layout: _Layout):
        self.inner, self.layout = inner, layout
        self.params = list(inner.params)

    @torch.no_grad()
    def step(self, grads) -> None:
        lay = self.layout
        groups = [g for g in map(lay.sharded.get, map(id, self.params)) if g is not None]
        whole = []  # the members kept whole: their block for the update, gathered back after
        for g in groups:
            for member in g.whole:
                lst = _members(g.opt, member)
                whole.append((g, member, lst[g.index]))
                lst[g.index] = _block(lst[g.index], g.dim, lay.rank, lay.n)
        self.inner.step(grads)
        for g, member, full in whole:
            lst = _members(g.opt, member)
            new = lay.reduce.gather(lst[g.index], g.dim)
            if member == "params":
                full.copy_(new)
                lst[g.index] = full
            else:
                lst[g.index] = new
        lay.release(self.params)


def _fsdp(cfg, banks, mesh: Mesh, make, reduce: FsdpReduce, min_bytes: int):
    """(step, shard_state, shard_batch) of the single-process step `make(
    reduce.grads)` with the state sharded over `mesh`'s data axis."""
    single = make(reduce.grads)
    core = single.train_on

    def train_on(state, hdr_t, ldr, sunpose_gt):
        layout = state.fsdp
        reduce.layout = layout
        layout.gather()
        try:
            return core(state, hdr_t, ldr, sunpose_gt)
        finally:
            layout.release()
            layout.release_buffers()
            reduce.layout = None

    single.train_on = train_on
    step, shard_batch = _parallel(cfg, banks, mesh, single, reduce)
    return step, make_shard_state(mesh, min_bytes, reduce), shard_batch


def make_shard_state(mesh: Mesh, min_bytes: int = DEFAULT_MIN_BYTES,
                     reduce: Optional[FsdpReduce] = None):
    """The `shard_state` of an FSDP step over `mesh` at `min_bytes` (its
    collectives through `reduce`, default a new `FsdpReduce`)."""
    reduce = reduce or FsdpReduce(mesh)

    def shard_state(state):
        """Shard a replicated GanState / SunState (`dp.replicate_state`) in
        place over `mesh`'s data axis (`fsdp_plan` at `min_bytes`): this
        rank keeps its block of every planned tensor, the optimizers become
        `ShardedOptimizer`s, and `state.fsdp` holds the layout. Returns
        it."""
        layout = _Layout(state, mesh, fsdp_plan(state, mesh, min_bytes), reduce)
        for name, opt in state.optimizers().items():
            setattr(state, name, ShardedOptimizer(opt, layout))
        layout.shard()
        state.fsdp = layout
        return state

    return shard_state


def unshard_state(state):
    """The full, replicated state of a sharded one, in place (all-gathers
    of every planned tensor, the optimizers unwrapped): for digests,
    checkpoints and `dp.replicas_agree`. Returns it; `shard_state` shards
    it again."""
    state.fsdp.unshard()
    for name, opt in state.optimizers().items():
        setattr(state, name, opt.inner)
    del state.fsdp
    return state


def make_fsdp_gan_train_step(cfg, banks, vgg_weights, mesh: Mesh,
                             shard_width: bool = False,
                             min_bytes: int = DEFAULT_MIN_BYTES, *, ring_of_one: bool = False):
    """The GAN train step with the state sharded over `mesh`'s data axis
    (ZeRO-3) and the batch as `dp.make_parallel_gan_train_step`'s (with
    `shard_width`, its columns over the width axis too). Returns (step,
    shard_state, shard_batch): `step(state, shard, key)` and
    `step.train_on(...)` as the DP step's, on a state from `shard_state`;
    `step.reduce` its `FsdpReduce` (`timed`, `comm_s`, the all-gathers
    included); `ring_of_one` as the DP step's."""
    reduce = FsdpReduce(mesh, shard_width, ring_of_one)
    return _fsdp(cfg, banks, mesh, lambda r: make_gan_train_step(cfg, banks, vgg_weights, r),
                 reduce, min_bytes)


def make_fsdp_sun_train_step(cfg, banks, mesh: Mesh, min_bytes: int = DEFAULT_MIN_BYTES):
    """The sun-pretrain step with the state sharded over `data`: (step,
    shard_state, shard_batch), as `make_fsdp_gan_train_step`."""
    reduce = FsdpReduce(mesh)
    return _fsdp(cfg, banks, mesh, lambda r: make_sun_train_step(cfg, banks, r), reduce,
                 min_bytes)


def plan_bytes(state, plan: dict, n_shards: int) -> dict:
    """{"replicated": bytes of the whole state, "per_rank": the bytes a rank
    holds under `plan` (its blocks of the planned tensors, the rest whole)}
    of a state (on any device, "meta" included)."""
    rep = per = 0
    for path, _, t, _ in state_leaves(state):
        nbytes = t.numel() * t.element_size()
        rep += nbytes
        per += nbytes // n_shards if plan[path] is not None else nbytes
    return {"replicated": rep, "per_rank": per}

