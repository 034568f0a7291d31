"""Width-sharded spatial parallelism with a cyclic halo exchange
(`skyhdr.parallel.spatial`), over `torch.distributed`, and the width
context of the width-sharded train step.

The panorama's width is periodic (360 degrees), so the processes of one
data row of the mesh form a ring over it: process `width_index` holds
columns [width_index * w_local, (width_index + 1) * w_local) of every
image, and a conv needs its neighbours' edge columns. `skyhdr` exchanges
them with `lax.ppermute` inside `shard_map`; here each process sends its
last columns to its right neighbour and its first to its left with
point-to-point sends (`dist.batch_isend_irecv`), one message of each kind
to each neighbour (at a width of 2 both neighbours are one process; at a
width of 1 the halo is the shard's own opposite edge). Every exchange has
a backward: the gradient of a received halo goes back to its owner and is
added to the columns it sent (`halo_pad`).

  * ring_conv2d            — a plain SAME conv over the width shards:
    (kw - 1) // 2 halo columns, the height zero-padded, a VALID
    `F.conv2d` (`skyhdr`'s is `lax.conv_general_dilated`, not a Pallas
    kernel). padding="cyclic" wraps the seam, "zeros" zero-pads it as the
    reference's plain conv does.
  * ring_deformable_conv2d — the distortion-aware conv: `ring_da_plan`
    says whether every per-row column shift fits a halo of `halo` columns
    (then the halo is exchanged and the DA conv runs on the extended shard
    over the full panorama's shifts re-based by the halo:
    `deform_conv.da_conv_ring`, K1/K2/K3 at k = 3, K5/K7/K6 otherwise;
    the halos through `_Exchange`, whose backward returns their gradients), or
    not (then the width is all-gathered, the DA conv runs on the whole
    panorama and the process keeps its columns, as `skyhdr` gathers the
    width around every DA conv of its width-sharded step; the gradient of
    the gather is summed over the ring and each process keeps its columns).
  * WidthRing, width_across — the width context (`ops/width.py`) of the
    width-sharded train step (`dp.py`, `fsdp.py` with `shard_width=True`):
    the halos (`halo`), the differentiable sum over the ring (`sum`), the
    gather of a narrow tensor (`gather`) and the share of a global mean
    (`mean`) that the layers, resizes, pools, denses and losses of the
    port take on width shards.

Tensors are NHWC [b, h, w_local, c]; CUDA tensors under gloo travel through
host memory. On a CUDA tensor the DA conv launches its kernels or raises;
on a CPU tensor it runs their plain versions.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from skyhdr_torch.ops.distortion import gather_tables, signed_shifts
from skyhdr_torch.ops.width import width_across  # noqa: F401
from skyhdr_torch.parallel.mesh import Mesh, _via_host, all_gather_, all_reduce_, reduce_scatter_

# How a halo ends at the panorama's two ends (`halo_pad`): wrapped around
# the seam, zero columns, the edge column repeated, or no column.
ENDS = ("cyclic", "zeros", "edge", "drop")


def _p2p(send_right: torch.Tensor, send_left: torch.Tensor, mesh: Mesh, dim: int):
    """(from_left, from_right): `send_right` of the left neighbour and
    `send_left` of the right one, each the shape this process sends (every
    process of the ring sends blocks of the same shape)."""
    if mesh.width == 1:
        return send_right, send_left
    dev = send_right.device
    host = _via_host(mesh, send_right)
    src = [t.cpu() if host else t for t in (send_right, send_left)]
    to_right, to_left = (t.contiguous() for t in src)
    from_left, from_right = torch.empty_like(to_right), torch.empty_like(to_left)
    left, right = mesh.width_peer(-1), mesh.width_peer(1)
    # The bytes travel (gloo takes no 2-byte types). Tag 0 travels
    # rightwards, tag 1 leftwards: at a width of 2 the two messages between
    # one pair of processes are told apart (NCCL, which ignores tags,
    # matches them in this order). An empty block is not sent (its size is
    # the same on every process).
    ops = []
    if to_right.numel():
        ops += [dist.P2POp(dist.isend, to_right.view(torch.uint8), right, tag=0),
                dist.P2POp(dist.irecv, from_left.view(torch.uint8), left, tag=0)]
    if to_left.numel():
        ops += [dist.P2POp(dist.isend, to_left.view(torch.uint8), left, tag=1),
                dist.P2POp(dist.irecv, from_right.view(torch.uint8), right, tag=1)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if host:
        return from_left.to(dev), from_right.to(dev)
    return from_left, from_right


def _check_halo(x: torch.Tensor, lo: int, hi: int, dim: int) -> None:
    if lo < 0 or hi < 0 or max(lo, hi) > x.shape[dim]:
        raise ValueError(f"a halo of ({lo}, {hi}) columns around a width shard of "
                         f"{x.shape[dim]}: one neighbour's shard at most")


def _exchange_halos(xl: torch.Tensor, pad: int, mesh: Mesh, hi: int = None, dim: int = 2):
    """(from_left, from_right): the left neighbour's last `pad` columns and
    the right neighbour's first `hi` (default `pad`) columns of xl along
    `dim` (no gradient)."""
    hi = pad if hi is None else hi
    _check_halo(xl, pad, hi, dim)
    w = xl.shape[dim]
    return _p2p(xl.narrow(dim, w - pad, pad), xl.narrow(dim, 0, hi), mesh, dim)


class _Halo(torch.autograd.Function):
    """x extended by `lo` columns of the left neighbour and `hi` of the
    right one along `dim`, its two ends at the panorama's ends as `ends`
    says; the backward sends each halo's gradient back to its owner, which
    adds it to the columns it sent (and an edge halo's into the edge)."""

    @staticmethod
    def forward(ctx, x, lo: int, hi: int, ends: str, mesh: Mesh, dim: int):
        from_left, from_right = _exchange_halos(x, lo, mesh, hi, dim)
        first, last = mesh.width_index == 0, mesh.width_index == mesh.width - 1
        w = x.shape[dim]
        if ends != "cyclic":
            if first:
                from_left = {"zeros": lambda: torch.zeros_like(from_left),
                             "edge": lambda: x.narrow(dim, 0, 1).expand_as(from_left),
                             "drop": lambda: from_left.narrow(dim, 0, 0)}[ends]()
            if last:
                from_right = {"zeros": lambda: torch.zeros_like(from_right),
                              "edge": lambda: x.narrow(dim, w - 1, 1).expand_as(from_right),
                              "drop": lambda: from_right.narrow(dim, 0, 0)}[ends]()
        ctx.args = (lo, hi, ends, mesh, dim, w, from_left.shape[dim], from_right.shape[dim])
        return torch.cat([from_left, x, from_right], dim=dim)

    @staticmethod
    def backward(ctx, g):
        lo, hi, ends, mesh, dim, w, nl, nr = ctx.args
        first, last = mesh.width_index == 0, mesh.width_index == mesh.width - 1
        g_left, dx, g_right = g.narrow(dim, 0, nl), g.narrow(dim, nl, w), g.narrow(dim, nl + w, nr)
        dx = dx.clone()
        # At an end whose halo did not come from the neighbour, its gradient
        # does not go back there (an edge halo's goes into the edge column).
        back_left, back_right = g_left, g_right
        if ends != "cyclic" and first:
            if ends == "edge":
                dx.narrow(dim, 0, 1).add_(g_left.sum(dim, keepdim=True))
            back_left = g.new_zeros(g_left.shape[:dim] + (lo,) + g_left.shape[dim + 1:])
        if ends != "cyclic" and last:
            if ends == "edge":
                dx.narrow(dim, w - 1, 1).add_(g_right.sum(dim, keepdim=True))
            back_right = g.new_zeros(g_right.shape[:dim] + (hi,) + g_right.shape[dim + 1:])
        # My last `lo` columns went right, my first `hi` left: their
        # gradients come back from the right and the left neighbour.
        for_first, for_last = _p2p(back_right, back_left, mesh, dim)
        dx.narrow(dim, w - lo, lo).add_(for_last)
        dx.narrow(dim, 0, hi).add_(for_first)
        return dx, None, None, None, None, None


class _Exchange(torch.autograd.Function):
    """(from_left, from_right) of `_exchange_halos`, cyclic, with a
    backward: each halo's gradient goes back to its owner, which adds it to
    the columns it sent. Both outputs must reach the loss on every process
    (the backward's sends pair up across the ring)."""

    @staticmethod
    def forward(ctx, x, pad: int, mesh: Mesh, dim: int):
        ctx.args = (pad, mesh, dim, x.shape[dim])
        return _exchange_halos(x, pad, mesh, dim=dim)

    @staticmethod
    def backward(ctx, g_left, g_right):
        pad, mesh, dim, w = ctx.args
        for_first, for_last = _p2p(g_right, g_left, mesh, dim)
        shape = list(g_left.shape)
        shape[dim] = w
        dx = g_left.new_zeros(shape)
        dx.narrow(dim, w - pad, pad).add_(for_last)
        dx.narrow(dim, 0, pad).add_(for_first)
        return dx, None, None, None


def halo_pad(x: torch.Tensor, lo: int, hi: int, mesh: Mesh, ends: str = "cyclic",
             dim: int = 2) -> torch.Tensor:
    """The width shard x extended by `lo` columns of its left neighbour and
    `hi` of its right one along `dim` (at most one shard each), with a
    gradient. At the panorama's ends the halo wraps ("cyclic"), is zero
    ("zeros"), repeats the edge column ("edge") or is left out ("drop")."""
    if ends not in ENDS:
        raise ValueError(f"ends {ends!r}: one of {ENDS}")
    if lo == hi == 0:
        return x
    return _Halo.apply(x, lo, hi, ends, mesh, dim)


class _WidthSum(torch.autograd.Function):
    """y = the sum of x over the width ring; its gradient, the sum of the
    ring's cotangents."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh):
        ctx.mesh = mesh
        return all_reduce_(x.clone(), mesh, group=mesh.width_group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.mesh, group=ctx.mesh.width_group), None


class _WidthGather(torch.autograd.Function):
    """The whole panorama of the ring's shards along `dim`; its gradient,
    the ring's cotangents summed, this process's columns."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, dim: int):
        ctx.mesh, ctx.dim = mesh, dim
        return all_gather_(x.movedim(dim, 0), mesh, mesh.width_group).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, dim = ctx.mesh, ctx.dim
        return (reduce_scatter_(g.movedim(dim, 0), mesh, mesh.width_group).movedim(0, dim),
                None, None)


def _gather_width(xl: torch.Tensor, mesh: Mesh, dim: int = 2) -> torch.Tensor:
    """The whole panorama [b, h, w, c] of the width ring's shards, with a
    gradient."""
    if mesh.width == 1:
        return xl
    return _WidthGather.apply(xl, mesh, dim)


class WidthRing:
    """The width ring of `mesh` as the width-sharded step's ops see it
    (`ops/width.py`): this process holds columns [index * w_local,
    (index + 1) * w_local) of every map of width w_local * n."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.n, self.index = mesh.width, mesh.width_index

    def cols(self, w_full: int) -> slice:
        """This process's columns of a map of width `w_full`."""
        if w_full % self.n:
            raise ValueError(f"a width of {w_full} over {self.n} width shards")
        wl = w_full // self.n
        return slice(self.index * wl, (self.index + 1) * wl)

    def halo(self, x, lo: int, hi: int, ends: str = "cyclic", dim: int = 2):
        """`halo_pad` over this ring."""
        return halo_pad(x, lo, hi, self.mesh, ends, dim)

    def sum(self, t):
        """The sum of t over the ring, with a gradient (each process's
        cotangent its share: the backward sums them)."""
        return t if self.n == 1 else _WidthSum.apply(t, self.mesh)

    def gather(self, x, dim: int = 2):
        """The whole panorama of x's shards along `dim`, with a gradient."""
        return _gather_width(x, self.mesh, dim)

    def mean(self, x, w_full: int = None):
        """This process's share of the mean of x over the whole panorama:
        the sum of its elements over the whole panorama's count, of width
        `w_full` (default: x's width on every shard; the discriminator's
        VALID logits are narrower on the last shard), so that the shares
        sum to the mean."""
        w_full = x.shape[2] * self.n if w_full is None else w_full
        return x.sum() / (math.prod(x.shape[:2] + x.shape[3:]) * w_full)


def _ring_conv(xl, kernel, bias, mesh, padding):
    kh, kw = kernel.shape[:2]
    pad_w, pad_h = (kw - 1) // 2, (kh - 1) // 2
    if pad_w > 0:
        xl = halo_pad(xl, pad_w, pad_w, mesh, "zeros" if padding == "zeros" else "cyclic")
    xl = F.pad(xl, (0, 0, 0, 0, pad_h, pad_h))
    out = F.conv2d(xl.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
    return out if bias is None else out + bias


def ring_conv2d(x, kernel, bias=None, *, mesh: Mesh, padding: str = "cyclic"):
    """SAME conv of this process's width shard x [b, h, w_local, cin] of a
    panorama with kernel [kh, kw, cin, cout] (`skyhdr`'s layout) and bias
    [cout]: the (kw - 1) // 2 halo columns from the ring, the height
    zero-padded. Returns [b, h, w_local, cout], with a gradient."""
    if padding not in ("cyclic", "zeros"):
        raise ValueError(f"padding {padding!r}: cyclic or zeros")
    return _ring_conv(x, kernel, bias, mesh, padding)


@functools.lru_cache(maxsize=None)
def ring_da_plan(h: int, w: int, w_local: int, kernel_size: int = 3,
                 dilation_rate: int = 1, skydome: bool = True):
    """Static plan of the width-sharded DA conv (`skyhdr`'s `ring_da_plan`):
    ("halo", halo) when every per-row column shift and its x1 neighbour fit
    halo = max |signed shift| + 1 columns of one neighbour's shard
    (halo <= w_local), ("gather", halo) otherwise."""
    t = gather_tables(h, w, kernel_size, 1, dilation_rate, skydome)
    signed = signed_shifts(t.cx0, w)
    halo = int(np.maximum(np.abs(signed), np.abs(signed + 1)).max())
    return ("halo" if halo <= w_local else "gather"), halo


def ring_deformable_conv2d(x, kernel, bias, *, mesh: Mesh, kernel_size: int = 3,
                           dilation_rate: int = 1, skydome: bool = True,
                           force_gather: bool = False):
    """The DA conv of this process's width shard x [b, h, w_local, c] of a
    panorama of width w_local * mesh.width, kernel [k*k*c, f], bias [f]:
    `ring_da_plan`'s halo exchange and the DA conv on the extended shard
    (`deform_conv.da_conv_ring`), or (its "gather" plan, or `force_gather`)
    the whole panorama all-gathered and the DA conv run on it. Returns
    [b, h, w_local, f] in x's dtype, with a gradient: dx of the extended
    shard with its halo parts sent back to their owners, and this process's
    partial dK and db (its columns' terms; the step sums them over the
    ring with the other gradients)."""
    from skyhdr_torch.ops.kernels import deform_conv as dc

    b, h, wl, c = x.shape
    w = wl * mesh.width
    geom = dict(kernel_size=kernel_size, dilation_rate=dilation_rate, skydome=skydome)
    mode, halo = ring_da_plan(h, w, wl, **geom)
    if force_gather or mode == "gather":
        out = dc.da_conv(_gather_width(x, mesh), kernel, bias, **geom)
        return out[:, :, mesh.width_index * wl:(mesh.width_index + 1) * wl].contiguous()
    left, right = _Exchange.apply(x, halo, mesh, 2)
    return dc.da_conv_ring(x, left, right, kernel, bias, w=w, halo=halo, **geom)
