"""Width-sharded spatial parallelism with a cyclic halo exchange
(`skyhdr.parallel.spatial`), over `torch.distributed`.

The panorama's width is periodic (360 degrees), so the processes of one
data row of the mesh form a ring over it: process `width_index` holds
columns [width_index * w_local, (width_index + 1) * w_local) of every
image, and a conv needs its neighbours' edge columns. `skyhdr` exchanges
them with `lax.ppermute` inside `shard_map`; here each process sends its
last `pad` columns to its right neighbour and its first `pad` to its left
with point-to-point sends (`dist.batch_isend_irecv`), one message of each
kind to each neighbour (at a width of 2 both neighbours are one process;
at a width of 1 the halo is the shard's own opposite edge).

  * ring_conv2d            — a plain SAME conv over the width shards:
    (kw - 1) // 2 halo columns, the height zero-padded, a VALID
    `F.conv2d` (`skyhdr`'s is `lax.conv_general_dilated`, not a Pallas
    kernel). padding="cyclic" wraps the seam, "zeros" zero-pads it as the
    reference's plain conv does.
  * ring_deformable_conv2d — the distortion-aware conv: `ring_da_plan`
    says whether every per-row column shift fits a halo of `halo` columns
    (then the halo is exchanged and the forward kernel, K1 at k = 3 or K5,
    runs on the extended shard over `ring_window_tables`: the full
    panorama's shifts re-based by the halo), or not (then the width is
    all-gathered, the kernel runs on the whole panorama and the process
    keeps its columns; `skyhdr` computes only those).

Both are forward only: a gradient through the ring (K2/K3 on width shards)
comes with the width-sharded train step, and until then a backward raises.
Tensors are NHWC [b, h, w_local, c]; CUDA tensors under gloo travel through
host memory. On a CUDA tensor the DA conv launches its kernel or raises; on
a CPU tensor it runs its plain version.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from skyhdr_torch.ops.distortion import gather_tables, signed_shifts
from skyhdr_torch.parallel.mesh import Mesh, _via_host, all_gather_


class _ForwardOnly(torch.autograd.Function):
    """`fn(*tensors)` with no backward: a gradient through the ring raises."""

    @staticmethod
    def forward(ctx, fn, *tensors):
        return fn(*tensors)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "no gradient through the width ring: K2/K3 on width shards come with the "
            "width-sharded train step, which is not ported")


def _exchange_halos(xl: torch.Tensor, pad: int, mesh: Mesh):
    """(from_left, from_right): the left neighbour's last `pad` columns and
    the right neighbour's first `pad` columns of x [b, h, w_local, c]."""
    if mesh.width == 1:
        return xl[:, :, -pad:], xl[:, :, :pad]
    host = _via_host(mesh, xl)
    src = xl.cpu() if host else xl
    # The bytes travel (gloo takes no 2-byte types).
    to_right, to_left = (src[:, :, -pad:].contiguous(), src[:, :, :pad].contiguous())
    from_left, from_right = torch.empty_like(to_right), torch.empty_like(to_left)
    left, right = mesh.width_peer(-1), mesh.width_peer(1)
    # Tag 0 travels rightwards, tag 1 leftwards: at a width of 2 the two
    # messages between one pair of processes are told apart (NCCL, which
    # ignores tags, matches them in this order).
    ops = [dist.P2POp(dist.isend, to_right.view(torch.uint8), right, tag=0),
           dist.P2POp(dist.isend, to_left.view(torch.uint8), left, tag=1),
           dist.P2POp(dist.irecv, from_left.view(torch.uint8), left, tag=0),
           dist.P2POp(dist.irecv, from_right.view(torch.uint8), right, tag=1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if host:
        return from_left.to(xl.device), from_right.to(xl.device)
    return from_left, from_right


def _gather_width(xl: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The whole panorama [b, h, w, c] of the width ring's shards."""
    if mesh.width == 1:
        return xl
    return all_gather_(xl.movedim(2, 0), mesh, mesh.width_group).movedim(0, 2)


def _ring_conv(xl, kernel, bias, mesh, padding):
    kh, kw = kernel.shape[:2]
    pad_w, pad_h = (kw - 1) // 2, (kh - 1) // 2
    if pad_w > 0:
        from_left, from_right = _exchange_halos(xl, pad_w, mesh)
        if padding == "zeros":
            # The reference's seam is zero-padded, not wrapped.
            if mesh.width_index == 0:
                from_left = torch.zeros_like(from_left)
            if mesh.width_index == mesh.width - 1:
                from_right = torch.zeros_like(from_right)
        xl = torch.cat([from_left, xl, from_right], dim=2)
    xl = F.pad(xl, (0, 0, 0, 0, pad_h, pad_h))
    out = F.conv2d(xl.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1)).permute(0, 2, 3, 1)
    return out if bias is None else out + bias


def ring_conv2d(x, kernel, bias=None, *, mesh: Mesh, padding: str = "cyclic"):
    """SAME conv of this process's width shard x [b, h, w_local, cin] of a
    panorama with kernel [kh, kw, cin, cout] (`skyhdr`'s layout) and bias
    [cout]: the (kw - 1) // 2 halo columns from the ring, the height
    zero-padded. Returns [b, h, w_local, cout]."""
    if padding not in ("cyclic", "zeros"):
        raise ValueError(f"padding {padding!r}: cyclic or zeros")
    fn = lambda *t: _ring_conv(t[0], t[1], t[2] if len(t) > 2 else None, mesh, padding)
    return _ForwardOnly.apply(fn, x, kernel, *(() if bias is None else (bias,)))


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


def _ring_da(xl, kernel, bias, mesh, kernel_size, dilation_rate, skydome, force_gather):
    from skyhdr_torch.ops.kernels import deform_conv as dc

    b, h, wl, c = xl.shape
    w = wl * mesh.width
    geom = dict(kernel_size=kernel_size, dilation_rate=dilation_rate, skydome=skydome)
    mode, halo = ring_da_plan(h, w, wl, **geom)
    if force_gather or mode == "gather":
        full = _gather_width(xl, mesh)
        if full.is_cuda:
            out = (dc.da_conv_forward_k1(full, kernel, bias, dilation_rate=dilation_rate,
                                         skydome=skydome) if kernel_size == 3
                   else dc.da_conv_forward_k5(full, kernel, bias, **geom))
        else:
            out = dc.da_conv_forward_ref(full, kernel, bias, **geom)
        return out[:, :, mesh.width_index * wl:(mesh.width_index + 1) * wl].contiguous()
    from_left, from_right = _exchange_halos(xl, halo, mesh)
    xe = torch.cat([from_left, xl, from_right], dim=2)
    ring = dc.da_conv_forward_ring if xe.is_cuda else dc.da_conv_forward_ring_ref
    return ring(xe, kernel, bias, w=w, halo=halo, **geom)


def ring_deformable_conv2d(x, kernel, bias, *, mesh: Mesh, kernel_size: int = 3,
                           dilation_rate: int = 1, skydome: bool = True,
                           force_gather: bool = False):
    """The DA conv of this process's width shard x [b, h, w_local, c] of a
    panorama of width w_local * mesh.width, kernel [k*k*c, f], bias [f]:
    `ring_da_plan`'s halo exchange and the forward kernel on the extended
    shard, or (its "gather" plan, or `force_gather`) the whole panorama
    all-gathered and the kernel run on it. Returns [b, h, w_local, f] in
    x's dtype."""
    fn = lambda *t: _ring_da(*t, mesh, kernel_size, dilation_rate, skydome, force_gather)
    return _ForwardOnly.apply(fn, x, kernel, bias)
