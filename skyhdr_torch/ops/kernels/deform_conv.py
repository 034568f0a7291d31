"""The k=3 DA conv on Hopper: kernel wrappers, their plain PyTorch
versions, and the autograd glue.

  K1 `da_conv_forward_k1` — CUDA forward (csrc/deform_conv.cu), replacing
     `_kernel_k3` of skyhdr/ops/pallas/deform_conv.py. Plain version:
     `da_conv_forward_ref`.
  K2 `da_conv_dx_k2` — CUDA input gradient, replacing `_dx_k3_kernel`.
     Plain version: `da_conv_dx_ref`, the same slot formula vectorised in
     torch (not autograd of the forward, so the CPU tests hold the very
     algorithm K2 runs against `jax.vjp`).
  K3 `da_conv_dk_k3` — CUDA weight gradient, replacing `_dk_k3_kernel`.
     Plain version: `da_conv_dk_ref`, the same sample-times-cotangent sum
     vectorised in torch (again not autograd of the forward).
  K4 `DAConvFunction` — the custom-VJP wiring (`_da_conv_core` / `_da_fwd`
     / `_da_bwd`): K1 forward; K2 for dx when the input needs a gradient,
     K3 for dK and a plain sum for db when the weights do.

Dispatch is by device only: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel or raises. `K1_LAUNCHES` / `K2_LAUNCHES` /
`K3_LAUNCHES` count kernel launches, one per wrapper call that launches.
"""

from __future__ import annotations

import contextlib

import torch

from skyhdr_torch.ops.distortion import (deformable_conv2d, gather_tables_on,
                                         mm_dtype, scatter_tables_k3_on)

K1_LAUNCHES = 0
K2_LAUNCHES = 0
K3_LAUNCHES = 0
_WEIGHT_GRADS = True


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _ptrs(*tensors):
    for t in tensors:
        _require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                 "DA kernel operands must be contiguous and 16-byte aligned")
    return [t.data_ptr() for t in tensors]


def da_conv_forward_k1(x, kernel, bias, *, dilation_rate: int = 1,
                       skydome: bool = True) -> torch.Tensor:
    """K1: the k=3 DA forward on the card. x [b,h,w,c] f32 or bf16,
    kernel [9c,f] (cast to bf16 only when x is bf16), bias [f]; returns
    bias + conv in x.dtype."""
    global K1_LAUNCHES
    from skyhdr_torch.ops.kernels.build import check, library

    f = kernel.shape[-1]
    _require(x.is_cuda and kernel.device == x.device,
             "DA kernels take CUDA tensors on one device")
    _require(x.dim() == 4 and tuple(kernel.shape) == (9 * x.shape[-1], f),
             f"x [b,h,w,c] and kernel [9c,f] expected, got "
             f"{tuple(x.shape)} and {tuple(kernel.shape)}")
    _require(x.dtype in (torch.float32, torch.bfloat16),
             f"K1 takes float32 or bfloat16 x, got {x.dtype}")
    _require(bias.shape == (f,), f"bias must be [{f}]")
    b, h, w, c = x.shape
    x = x.contiguous()
    k = kernel.to(mm_dtype(x)).contiguous()
    bias32 = bias.to(device=x.device, dtype=torch.float32).contiguous()
    y0, y1, cx, wy, wx = gather_tables_on(x.device, h, w, 3, dilation_rate, skydome)
    out = torch.empty((b, h, w, f), dtype=x.dtype, device=x.device)
    code = library().skyhdr_da_fwd_k3(
        *_ptrs(x, k, bias32, y0, y1, cx, wy, wx, out), b, h, w, c, f,
        int(x.dtype == torch.bfloat16), x.device.index, _stream(x))
    check(code, "K1 (DA forward)")
    K1_LAUNCHES += 1
    return out


def da_conv_dx_k2(g, kernel, *, x_shape, dilation_rate: int = 1,
                  skydome: bool = True) -> torch.Tensor:
    """K2: the k=3 DA input gradient on the card. g [b,h,w,f] (taken as
    float32), kernel [9c,f]; returns dx [b,h,w,c] float32."""
    global K2_LAUNCHES
    from skyhdr_torch.ops.kernels.build import check, library

    b, h, w, c = x_shape
    f = kernel.shape[-1]
    _require(g.is_cuda and kernel.device == g.device,
             "DA kernels take CUDA tensors on one device")
    _require(tuple(kernel.shape) == (9 * c, f),
             f"kernel must be [{9 * c}, {f}], got {tuple(kernel.shape)}")
    _require(tuple(g.shape) == (b, h, w, f),
             f"g must be [{b},{h},{w},{f}], got {tuple(g.shape)}")
    g32 = g.float().contiguous()
    kt = kernel.float().reshape(9, c, f).transpose(1, 2).contiguous()  # [9, f, c]
    (si, sw, sky, scx, swx), nslots = scatter_tables_k3_on(
        g.device, h, w, dilation_rate, skydome)
    dx = torch.empty((b, h, w, c), dtype=torch.float32, device=g.device)
    code = library().skyhdr_da_dx_k3(
        *_ptrs(g32, kt, si, sw, sky, scx, swx), nslots, *_ptrs(dx),
        b, h, w, c, f, g.device.index, _stream(g))
    check(code, "K2 (DA input gradient)")
    K2_LAUNCHES += 1
    return dx


def da_conv_dk_k3(x, g, *, dilation_rate: int = 1,
                  skydome: bool = True) -> torch.Tensor:
    """K3: the k=3 DA weight gradient on the card. x [b,h,w,c] float32 or
    bfloat16 (read as float32), g [b,h,w,f] (taken as float32); returns
    dK [9c,f] float32, summed in a fixed order (deterministic)."""
    global K3_LAUNCHES
    from skyhdr_torch.ops.kernels.build import check, library

    _require(x.is_cuda and g.device == x.device,
             "DA kernels take CUDA tensors on one device")
    _require(x.dim() == 4 and g.dim() == 4 and g.shape[:3] == x.shape[:3],
             f"x [b,h,w,c] and g [b,h,w,f] expected, got {tuple(x.shape)} "
             f"and {tuple(g.shape)}")
    _require(x.dtype in (torch.float32, torch.bfloat16),
             f"K3 takes float32 or bfloat16 x, got {x.dtype}")
    b, h, w, c = x.shape
    f = g.shape[-1]
    x = x.contiguous()
    g32 = g.float().contiguous()
    lib = library()
    nsplit = lib.skyhdr_da_dk_k3_splits(b, h, c, f, x.device.index)
    _require(nsplit > 0, f"K3 does not tile C={c}, F={f} (code {nsplit})")
    y0, y1, cx, wy, wx = gather_tables_on(x.device, h, w, 3, dilation_rate, skydome)
    ws = torch.empty((nsplit, 9 * c, f), dtype=torch.float32, device=x.device)
    dk = torch.empty((9 * c, f), dtype=torch.float32, device=x.device)
    code = lib.skyhdr_da_dk_k3(
        *_ptrs(x, g32, y0, y1, cx, wy, wx, ws, dk), nsplit, b, h, w, c, f,
        int(x.dtype == torch.bfloat16), x.device.index, _stream(x))
    check(code, "K3 (DA weight gradient)")
    K3_LAUNCHES += 1
    return dk


def da_conv_forward_ref(x, kernel, bias, *, dilation_rate: int = 1,
                        skydome: bool = True) -> torch.Tensor:
    """Plain version of K1: the gather form (`deformable_conv2d`, k=3)."""
    return deformable_conv2d(x, kernel, bias, kernel_size=3,
                             dilation_rate=dilation_rate, skydome=skydome)


def da_conv_dx_ref(g, kernel, *, x_shape, dilation_rate: int = 1,
                   skydome: bool = True) -> torch.Tensor:
    """Plain version of K2: over the `scatter_tables_k3` slots,
    dx[y,j] = sum_slots sum_kx ((sw(1-wx)) g[si][(j-cx) mod w]
                                + (sw wx) g[si][(j-cx-1) mod w]) @ K_t^T,
    t = 3 ky + kx, in float32. Padding slots carry sw = 0."""
    b, h, w, c = x_shape
    f = kernel.shape[-1]
    dev = g.device
    (si, sw, sky, scx, swx), nslots = scatter_tables_k3_on(
        dev, h, w, dilation_rate, skydome)
    g = g.float()
    kt = kernel.float().reshape(9, c, f).transpose(1, 2)  # [9, f, c]
    jcols = torch.arange(w, device=dev)[None, :]
    dx = torch.zeros((b, h, w, c), dtype=torch.float32, device=dev)
    for s in range(nslots):
        rows = g[:, si[:, s].long()]  # [b, h, w, f]: cotangent row per input row
        wgt = sw[:, s]
        for kx in range(3):
            cx = scx[:, 3 * s + kx].long()[:, None]
            wx = swx[:, 3 * s + kx]
            i0 = ((jcols - cx) % w)[None, :, :, None].expand(b, h, w, f)
            i1 = ((jcols - cx - 1) % w)[None, :, :, None].expand(b, h, w, f)
            a0 = (wgt * (1 - wx))[None, :, None, None]
            a1 = (wgt * wx)[None, :, None, None]
            u = a0 * torch.gather(rows, 2, i0) + a1 * torch.gather(rows, 2, i1)
            dx = dx + torch.einsum("bhwf,hfc->bhwc", u,
                                   kt[3 * sky[:, s].long() + kx])
    return dx


def da_conv_dk_ref(x, g, *, dilation_rate: int = 1,
                   skydome: bool = True) -> torch.Tensor:
    """Plain version of K3: dK[t*c+ci, f] = sum_{b,i,j} sample_t[b,i,j,ci]
    g[b,i,j,f] with the forward's rebuilt sample
        rowY   = (1-wy)*xpad[y0] + wy*xpad[y1]
        sample = (1-wx)*rowY[(j+cx) mod w] + wx*rowY[(j+cx+1) mod w],
    all in float32 (x is read as float32 whatever its dtype)."""
    b, h, w, c = x.shape
    dev = x.device
    y0, y1, cx0, wys, wxs = gather_tables_on(dev, h, w, 3, dilation_rate, skydome)
    xp = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 1, 1))
    g = g.float()
    jcols = torch.arange(w, device=dev)
    taps = []
    for tap in range(9):
        wy = wys[:, tap][None, :, None, None]
        wx = wxs[:, tap][None, :, None, None]
        row_y = (1 - wy) * xp[:, y0[:, tap].long()] + wy * xp[:, y1[:, tap].long()]
        cols = (jcols[None, :] + cx0[:, tap].long()[:, None]) % w  # [h, w]
        s0 = torch.gather(row_y, 2, cols[None, :, :, None].expand(b, h, w, c))
        sample = (1 - wx) * s0 + wx * torch.roll(s0, -1, dims=2)
        taps.append(torch.einsum("bhwc,bhwf->cf", sample, g))
    return torch.cat(taps, dim=0)


@contextlib.contextmanager
def input_grads_only():
    """Within this block the DA backward computes dx only and returns no
    dK or db. For a gradient call that asks only for activations' gradients
    (Grad-CAM's pull, `torch.autograd.grad(sm, eps)`), where the weights'
    gradients would be thrown away: `ctx.needs_input_grad` is fixed at the
    forward, so the backward cannot see that the call discards them (JAX's
    dead-code elimination drops that work)."""
    global _WEIGHT_GRADS
    prev, _WEIGHT_GRADS = _WEIGHT_GRADS, False
    try:
        yield
    finally:
        _WEIGHT_GRADS = prev


class DAConvFunction(torch.autograd.Function):
    """k=3 DA conv with the kernels in both directions."""

    @staticmethod
    def forward(ctx, x, kernel, bias, dilation_rate: int, skydome: bool):
        ctx.save_for_backward(x, kernel, bias)
        ctx.dilation_rate, ctx.skydome = dilation_rate, skydome
        run = da_conv_forward_k1 if x.is_cuda else da_conv_forward_ref
        return run(x, kernel, bias, dilation_rate=dilation_rate, skydome=skydome)

    @staticmethod
    def backward(ctx, g):
        x, kernel, bias = ctx.saved_tensors
        dx = dk = db = None
        geom = dict(dilation_rate=ctx.dilation_rate, skydome=ctx.skydome)
        if ctx.needs_input_grad[1] and _WEIGHT_GRADS:
            run = da_conv_dk_k3 if g.is_cuda else da_conv_dk_ref
            dk = run(x, g, **geom).to(kernel.dtype)
        if ctx.needs_input_grad[2] and _WEIGHT_GRADS:
            db = g.float().sum((0, 1, 2)).to(bias.dtype)
        if ctx.needs_input_grad[0]:
            run = da_conv_dx_k2 if g.is_cuda else da_conv_dx_ref
            dx = run(g, kernel, x_shape=tuple(x.shape), **geom).to(x.dtype)
        return dx, dk, db, None, None


def da_conv(x, kernel, bias, *, kernel_size: int = 3, dilation_rate: int = 1,
            skydome: bool = True) -> torch.Tensor:
    """The DA conv as the layers call it (stride 1, x [b,h,w,c],
    kernel [k2*c, f], bias [f])."""
    if kernel_size != 3:
        if x.is_cuda:
            raise NotImplementedError(
                "odd-k DA conv kernels (K5-K7) are not ported yet")
        return deformable_conv2d(x, kernel, bias, kernel_size=kernel_size,
                                 dilation_rate=dilation_rate, skydome=skydome)
    return DAConvFunction.apply(x, kernel, bias, dilation_rate, skydome)
