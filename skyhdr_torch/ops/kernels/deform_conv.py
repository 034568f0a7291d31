"""The DA conv on Hopper: kernel wrappers, their plain PyTorch versions, and
the autograd glue.

k = 3 (skyhdr/ops/pallas/deform_conv.py's fast path):
  K1 `da_conv_forward_k1` — CUDA forward (csrc/deform_conv.cu), replacing
     `_kernel_k3`: one y-interpolated window per (output row, kernel row)
     over the `window_tables`, the kernel row's taps x-interpolated from it;
     `fwd_tiling` picks a block's rows and a thread's register tile.
     Plain version: `da_conv_forward_ref`.
  K2 `da_conv_dx_k2` — CUDA input gradient, replacing `_dx_k3_kernel`:
     one product per forward (row, tap) pair over the `strip_tables`.
     Plain version: `da_conv_dx_ref`, the TPU kernel's slot formula
     vectorised in torch (not autograd of the forward, so the CPU tests
     hold it against `jax.vjp`, and the pair tables against the slots).
  K3 `da_conv_dk_k3` — CUDA weight gradient, replacing `_dk_k3_kernel`:
     over K1's `window_tables`, a block per window group (a kernel row's
     taps) and chunk of channels, one y-interpolated window and one staged
     cotangent chunk shared by the group's taps; `dk_tiling` splits the
     reduction over one wave of blocks. Plain version: `da_conv_dk_ref`,
     the same sample-times-cotangent sum vectorised in torch (again not
     autograd of the forward).
Any other odd k (the generic kernels of the same file):
  K5 `da_conv_forward_k5` — CUDA forward, replacing `_kernel_body`: K1's
     kernel at that k. Plain version: `da_conv_forward_ref` at that k.
  K6 `da_conv_dk_k6` — CUDA weight gradient, replacing `_dk_kernel`. Plain
     version: `da_conv_dk_ref` at that k.
  K7 `da_conv_dx_k7` — CUDA input gradient, replacing `_dx_kernel`: K2's
     kernel at that k. Plain version: `da_conv_dx_ref_generic`, the TPU
     kernel's reference formula over the `scatter_tables` in torch.
K4 `DAConvFunction` — the custom-VJP wiring (`_da_conv_core` / `_da_fwd` /
  `_da_bwd`): the forward kernel of the kernel size; the input gradient
  when the input needs one, the weight gradient and a plain sum for db
  when the weights do.

Dispatch is by device only: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel or raises. `K1_LAUNCHES` ... `K7_LAUNCHES` count
kernel launches, one per wrapper call that launches.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from skyhdr_torch.ops.distortion import (deformable_conv2d, gather_tables_on,
                                         mm_dtype, scatter_tables_k3_on,
                                         scatter_tables_on, strip_tables_on,
                                         window_tables_on)

K1_LAUNCHES = 0
K2_LAUNCHES = 0
K3_LAUNCHES = 0
K5_LAUNCHES = 0
K6_LAUNCHES = 0
K7_LAUNCHES = 0
# The strip heights R of K2/K7, tallest first: a block forms every (output
# row, tap) product that reaches its strip of R input rows once, at most
# (R + 1) / R times the forward's products, so the tallest strip that still
# fills the card wins (`dx_strip_rows`).
DX_STRIP_ROWS = (8, 4, 2)
# The output rows R of a K1/K5 block, most first, and the output channels
# of a thread's register tile (8 columns x 8 or 4), widest first
# (`fwd_tiling`).
FWD_ROWS = (8, 4, 2, 1)
FWD_CHANS = (8, 4)
# K3/K6 split their (b, row, column chunk) stages over as few splits as
# give a grid that fills this share of the waves of resident blocks it
# takes (`dk_tiling`): each split adds a partial [k*k*c, f] to sum.
DK_FILL = 0.95
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


def _odd_other_than_3(k: int, name: str) -> None:
    _require(k % 2 == 1 and k != 3,
             f"{name} takes an odd kernel size other than 3, got {k}")


def _forward(x, kernel, bias, k: int, dilation_rate: int, skydome: bool,
             name: str) -> torch.Tensor:
    """Checks, then launches the forward kernel at kernel size k (K1 at
    k = 3, K5 otherwise) over the `window_tables` with the rows and
    register tile `fwd_tiling` picks."""
    from skyhdr_torch.ops.kernels.build import check, library

    f = kernel.shape[-1]
    _require(x.is_cuda and kernel.device == x.device,
             "DA kernels take CUDA tensors on one device")
    _require(x.dim() == 4 and tuple(kernel.shape) == (k * k * x.shape[-1], f),
             f"x [b,h,w,c] and kernel [{k * k}c,f] expected, got "
             f"{tuple(x.shape)} and {tuple(kernel.shape)}")
    _require(x.dtype in (torch.float32, torch.bfloat16),
             f"{name} takes float32 or bfloat16 x, got {x.dtype}")
    _require(bias.shape == (f,), f"bias must be [{f}]")
    b, h, w, c = x.shape
    kk = kernel.to(mm_dtype(x))
    # The kernel copies 4 channels at a time: zero channels pad x and the
    # kernel's rows to a multiple of 4 (the 3-channel sun-pose input).
    cp = -(-c // 4) * 4
    if cp != c:
        x = torch.nn.functional.pad(x, (0, cp - c))
        kk = torch.nn.functional.pad(kk.reshape(k * k, c, f), (0, 0, 0, cp - c))
    x, kk = x.contiguous(), kk.reshape(k * k * cp, f).contiguous()
    bias32 = bias.to(device=x.device, dtype=torch.float32).contiguous()
    rows_t, taps_t, taps, span = window_tables_on(x.device, h, w, k, dilation_rate, skydome)
    rows, chans = fwd_launch_tiling(b, h, w, f, x.device.index)
    out = torch.empty((b, h, w, f), dtype=x.dtype, device=x.device)
    code = library().skyhdr_da_fwd(*_ptrs(x, kk, bias32, rows_t, taps_t, out), b, h, w, cp, f, k,
                             taps, span, rows, chans, int(x.dtype == torch.bfloat16),
                             x.device.index, _stream(x))
    check(code, f"{name} (DA forward, k={k})")
    return out


def da_conv_forward_k1(x, kernel, bias, *, dilation_rate: int = 1,
                       skydome: bool = True) -> torch.Tensor:
    """K1: the k=3 DA forward on the card. x [b,h,w,c] f32 or bf16,
    kernel [9c,f] (cast to bf16 only when x is bf16), bias [f]; returns
    bias + conv in x.dtype."""
    global K1_LAUNCHES
    out = _forward(x, kernel, bias, 3, dilation_rate, skydome, "K1")
    K1_LAUNCHES += 1
    return out


def da_conv_forward_k5(x, kernel, bias, *, kernel_size: int,
                       dilation_rate: int = 1, skydome: bool = True) -> torch.Tensor:
    """K5: the DA forward at an odd kernel size k other than 3 on the card;
    as K1, with kernel [k*k*c, f]."""
    global K5_LAUNCHES
    _odd_other_than_3(kernel_size, "K5")
    out = _forward(x, kernel, bias, kernel_size, dilation_rate, skydome, "K5")
    K5_LAUNCHES += 1
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def fwd_tiling(b: int, h: int, tiles: dict, sms: int) -> tuple:
    """(rows, chans) of a K1/K5 launch: the widest register tile of
    FWD_CHANS, then the most output rows of FWD_ROWS, that tile the shape
    (`tiles[rows, chans]`, the blocks per image and row group, > 0) with a
    grid (b x row groups x tiles) that still gives each of `sms` SMs 1.5
    blocks; one row of 4-channel tiles otherwise. A wider tile and more
    rows share each staged sample and chunk of K among more products;
    below ~1.5 blocks per SM the idle SMs cost more."""
    for chans in FWD_CHANS:
        for rows in FWD_ROWS:
            n = tiles[rows, chans]
            if n > 0 and b * -(-h // rows) * n >= 1.5 * sms:
                return rows, chans
    return FWD_ROWS[-1], FWD_CHANS[-1]


@functools.lru_cache(maxsize=None)
def fwd_launch_tiling(b: int, h: int, w: int, f: int, index: int) -> tuple:
    """`fwd_tiling` of a K1/K5 launch of x [b, h, w, *] -> F = f on card
    `index`, from the kernel library's tiles; once per shape."""
    from skyhdr_torch.ops.kernels.build import library

    lib = library()
    tiles = {(r, n): lib.skyhdr_da_fwd_tiles(w, f, r, n) for n in FWD_CHANS for r in FWD_ROWS}
    return fwd_tiling(b, h, tiles, _sm_count(index))


def dx_strip_rows(b: int, h: int, tiles: int, sms: int) -> int:
    """The strip height of a K2/K7 launch: the tallest of DX_STRIP_ROWS whose
    grid (b x strips x `tiles` blocks per strip) still gives each of `sms`
    SMs 1.5 blocks; the shortest otherwise. Fewer, taller strips do fewer
    products; below ~1.5 blocks per SM the idle SMs cost more than that."""
    for rows in DX_STRIP_ROWS:
        if b * -(-h // rows) * tiles >= 1.5 * sms:
            return rows
    return DX_STRIP_ROWS[-1]


def _dx(g, kernel, x_shape, k: int, dilation_rate: int, skydome: bool,
        name: str) -> torch.Tensor:
    """Checks, then launches the input-gradient kernel at kernel size k
    (K2 at k = 3, K7 otherwise) over the `strip_tables` of the strip height
    `dx_strip_rows` picks."""
    from skyhdr_torch.ops.kernels.build import check, library

    b, h, w, c = x_shape
    f = kernel.shape[-1]
    _require(g.is_cuda and kernel.device == g.device,
             "DA kernels take CUDA tensors on one device")
    _require(tuple(kernel.shape) == (k * k * c, f),
             f"kernel must be [{k * k * c}, {f}], got {tuple(kernel.shape)}")
    _require(tuple(g.shape) == (b, h, w, f),
             f"g must be [{b},{h},{w},{f}], got {tuple(g.shape)}")
    # The kernel stages F and tiles C in 16-byte vectors: zero channels pad
    # both to a multiple of 4 (never at the model's shapes); the padded
    # channels of dx are not stored.
    cp, fp = -(-c // 4) * 4, -(-f // 4) * 4
    _require(k != 3 or cp == c, f"{name} takes C % 4 == 0, got C={c}")
    g32 = g.float()
    kt = kernel.float().reshape(k * k, c, f).transpose(1, 2)  # [k2, f, c]
    if fp != f:
        g32 = torch.nn.functional.pad(g32, (0, fp - f))
    if (cp, fp) != (c, f):
        kt = torch.nn.functional.pad(kt, (0, cp - c, 0, fp - f))
    g32, kt = g32.contiguous(), kt.contiguous()
    lib = library()
    tiles = lib.skyhdr_da_dx_tiles(w, cp, fp)
    _require(tiles > 0, f"{name} does not tile W={w}, C={c}, F={f}")
    rows = dx_strip_rows(b, h, tiles, _sm_count(g.device.index))
    pint, pflt, start = strip_tables_on(g.device, h, w, k, rows, dilation_rate, skydome)
    dx = torch.empty((b, h, w, c), dtype=torch.float32, device=g.device)
    code = lib.skyhdr_da_dx(
        *_ptrs(g32, kt, pint, pflt, start), start.numel() - 1, rows, *_ptrs(dx),
        b, h, w, c, cp, fp, k, g.device.index, _stream(g))
    check(code, f"{name} (DA input gradient, k={k})")
    return dx


def da_conv_dx_k2(g, kernel, *, x_shape, dilation_rate: int = 1,
                  skydome: bool = True) -> torch.Tensor:
    """K2: the k=3 DA input gradient on the card. g [b,h,w,f] (taken as
    float32), kernel [9c,f]; returns dx [b,h,w,c] float32."""
    global K2_LAUNCHES
    dx = _dx(g, kernel, x_shape, 3, dilation_rate, skydome, "K2")
    K2_LAUNCHES += 1
    return dx


def da_conv_dx_k7(g, kernel, *, x_shape, kernel_size: int,
                  dilation_rate: int = 1, skydome: bool = True) -> torch.Tensor:
    """K7: the DA input gradient at an odd kernel size k other than 3 on the
    card; as K2, with kernel [k*k*c, f]."""
    global K7_LAUNCHES
    _odd_other_than_3(kernel_size, "K7")
    dx = _dx(g, kernel, x_shape, kernel_size, dilation_rate, skydome, "K7")
    K7_LAUNCHES += 1
    return dx


def dk_tiling(stages: int, tiles: int, resident: int, sms: int) -> int:
    """The row splits of a K3/K6 launch: the fewest (at most `stages`,
    the reduction's (b, i, column chunk) stages) whose grid of `tiles`
    blocks a split fills DK_FILL of the waves it takes on `sms` SMs of
    `resident` blocks each; the best fill when none does. Every block of a
    split does the same work, so a full last wave is what counts; fewer
    splits mean a smaller workspace to sum."""
    slots = sms * max(resident, 1)
    best, best_fill = 1, 0.0
    for n in range(1, stages + 1):
        blocks = tiles * n
        fill = blocks / (-(-blocks // slots) * slots)
        if fill >= DK_FILL:
            return n
        if fill > best_fill:
            best, best_fill = n, fill
    return best


@functools.lru_cache(maxsize=None)
def dk_launch_tiling(b: int, h: int, w: int, cp: int, f: int, k: int, taps: int, span: int,
                     bf16: bool, index: int) -> tuple:
    """(splits, blocks per split, threads a block, resident blocks per SM)
    of a K3/K6 launch of x [b, h, w, cp] -> F = f at kernel size k over
    window tables of `taps` taps a group and this span, on card `index`:
    the kernel library's tiles (`skyhdr_da_dk_tiles`), split by
    `dk_tiling`; once per shape."""
    from skyhdr_torch.ops.kernels.build import library

    out = (ctypes.c_int * 4)()
    code = library().skyhdr_da_dk_tiles(w, cp, f, k, taps, span, int(bf16), index,
                                        ctypes.addressof(out))
    _require(code == 0, f"the DA weight gradient does not tile W={w}, C={cp}, F={f}, "
             f"k={k} (code {code})")
    tiles, threads, resident, chunks = out
    return dk_tiling(b * h * chunks, tiles, resident, _sm_count(index)), tiles, threads, resident


def _dk(x, g, k: int, dilation_rate: int, skydome: bool, name: str) -> torch.Tensor:
    """Checks, then launches K3 (k = 3) or K6 (any other odd k) over the
    `window_tables` with the splits `dk_tiling` picks, and its fixed-order
    reduction."""
    from skyhdr_torch.ops.kernels.build import check, library

    _require(x.is_cuda and g.device == x.device,
             "DA kernels take CUDA tensors on one device")
    _require(x.dim() == 4 and g.dim() == 4 and g.shape[:3] == x.shape[:3],
             f"x [b,h,w,c] and g [b,h,w,f] expected, got {tuple(x.shape)} "
             f"and {tuple(g.shape)}")
    _require(x.dtype in (torch.float32, torch.bfloat16),
             f"{name} takes float32 or bfloat16 x, got {x.dtype}")
    b, h, w, c0 = x.shape
    f = g.shape[-1]
    # The kernel copies 4 channels at a time: a zero channel pads the
    # 3-channel input, and its rows of dK are dropped.
    c = -(-c0 // 4) * 4
    if c != c0:
        x = torch.nn.functional.pad(x, (0, c - c0))
    x = x.contiguous()
    g32 = g.float().contiguous()
    bf16 = x.dtype == torch.bfloat16
    rows_t, taps_t, taps, span = window_tables_on(x.device, h, w, k, dilation_rate, skydome)
    nsplit = dk_launch_tiling(b, h, w, c, f, k, taps, span, bf16, x.device.index)[0]
    ws = torch.empty((nsplit, k * k * c, f), dtype=torch.float32, device=x.device)
    dk = torch.empty((k * k * c, f), dtype=torch.float32, device=x.device)
    code = library().skyhdr_da_dk(*_ptrs(x, g32, rows_t, taps_t, ws, dk), nsplit, b, h, w, c,
                                  f, k, taps, span, int(bf16), x.device.index, _stream(x))
    check(code, f"{name} (DA weight gradient, k={k})")
    return dk if c == c0 else dk.view(k * k, c, f)[:, :c0].reshape(k * k * c0, f)


def da_conv_dk_k3(x, g, *, dilation_rate: int = 1,
                  skydome: bool = True) -> torch.Tensor:
    """K3: the k=3 DA weight gradient on the card. x [b,h,w,c] float32 or
    bfloat16 (read as float32), g [b,h,w,f] (taken as float32); returns
    dK [9c,f] float32, summed in a fixed order (deterministic)."""
    global K3_LAUNCHES
    dk = _dk(x, g, 3, dilation_rate, skydome, "K3")
    K3_LAUNCHES += 1
    return dk


def da_conv_dk_k6(x, g, *, kernel_size: int, dilation_rate: int = 1,
                  skydome: bool = True) -> torch.Tensor:
    """K6: the DA weight gradient at an odd kernel size k other than 3 on
    the card; as K3, returning dK [k*k*c, f] float32."""
    global K6_LAUNCHES
    _odd_other_than_3(kernel_size, "K6")
    dk = _dk(x, g, kernel_size, dilation_rate, skydome, "K6")
    K6_LAUNCHES += 1
    return dk


def da_conv_forward_ref(x, kernel, bias, *, kernel_size: int = 3,
                        dilation_rate: int = 1, skydome: bool = True) -> torch.Tensor:
    """Plain version of K1 (k = 3) and K5: the gather form
    (`deformable_conv2d`)."""
    return deformable_conv2d(x, kernel, bias, kernel_size=kernel_size,
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


def da_conv_dx_ref_generic(g, kernel, *, x_shape, kernel_size: int,
                           dilation_rate: int = 1, skydome: bool = True) -> torch.Tensor:
    """Plain version of K7: over the `scatter_tables` references,
    dx[y,j] = sum_r rw ((1-rwx) g[ri][(j-rcx) mod w]
                        + rwx g[ri][(j-rcx-1) mod w]) @ K_rt^T,
    in float32. Padding references carry rw = 0."""
    b, h, w, c = x_shape
    k2 = kernel_size * kernel_size
    f = kernel.shape[-1]
    dev = g.device
    (ri, rt, rw, rcx, rwx), nrefs = scatter_tables_on(
        dev, h, w, kernel_size, dilation_rate, skydome)
    g = g.float()
    kt = kernel.float().reshape(k2, c, f).transpose(1, 2)  # [k2, f, c]
    jcols = torch.arange(w, device=dev)[None, :]
    dx = torch.zeros((b, h, w, c), dtype=torch.float32, device=dev)
    for r in range(nrefs):
        rows = g[:, ri[:, r].long()]  # [b, h, w, f]: cotangent row per input row
        cx = rcx[:, r].long()[:, None]
        i0 = ((jcols - cx) % w)[None, :, :, None].expand(b, h, w, f)
        i1 = ((jcols - cx - 1) % w)[None, :, :, None].expand(b, h, w, f)
        wx = rwx[:, r][None, :, None, None]
        u = rw[:, r][None, :, None, None] * (
            (1 - wx) * torch.gather(rows, 2, i0) + wx * torch.gather(rows, 2, i1))
        dx = dx + torch.einsum("bhwf,hfc->bhwc", u, kt[rt[:, r].long()])
    return dx


def da_conv_dk_ref(x, g, *, kernel_size: int = 3, dilation_rate: int = 1,
                   skydome: bool = True) -> torch.Tensor:
    """Plain version of K3 (k = 3) and K6: dK[t*c+ci, f] =
    sum_{b,i,j} sample_t[b,i,j,ci] g[b,i,j,f] with the forward's rebuilt
    sample
        rowY   = (1-wy)*xpad[y0] + wy*xpad[y1]      (k // 2 pad rows)
        sample = (1-wx)*rowY[(j+cx) mod w] + wx*rowY[(j+cx+1) mod w],
    all in float32 (x is read as float32 whatever its dtype)."""
    b, h, w, c = x.shape
    dev = x.device
    pad = kernel_size // 2
    y0, y1, cx0, wys, wxs = gather_tables_on(dev, h, w, kernel_size,
                                             dilation_rate, skydome)
    xp = torch.nn.functional.pad(x.float(), (0, 0, 0, 0, pad, pad))
    g = g.float()
    jcols = torch.arange(w, device=dev)
    taps = []
    for tap in range(kernel_size * kernel_size):
        wy = wys[:, tap][None, :, None, None]
        wx = wxs[:, tap][None, :, None, None]
        row_y = (1 - wy) * xp[:, y0[:, tap].long()] + wy * xp[:, y1[:, tap].long()]
        cols = (jcols[None, :] + cx0[:, tap].long()[:, None]) % w  # [h, w]
        s0 = torch.gather(row_y, 2, cols[None, :, :, None].expand(b, h, w, c))
        sample = (1 - wx) * s0 + wx * torch.roll(s0, -1, dims=2)
        taps.append(torch.einsum("bhwc,bhwf->cf", sample, g))
    return torch.cat(taps, dim=0)


def _forward_of(x, k: int):
    """The forward for x's device at kernel size k, k bound."""
    if not x.is_cuda:
        return functools.partial(da_conv_forward_ref, kernel_size=k)
    return da_conv_forward_k1 if k == 3 else functools.partial(da_conv_forward_k5,
                                                               kernel_size=k)


def _dk_of(g, k: int):
    if not g.is_cuda:
        return functools.partial(da_conv_dk_ref, kernel_size=k)
    return da_conv_dk_k3 if k == 3 else functools.partial(da_conv_dk_k6, kernel_size=k)


def _dx_of(g, k: int):
    if k == 3:
        return da_conv_dx_k2 if g.is_cuda else da_conv_dx_ref
    return functools.partial(da_conv_dx_k7 if g.is_cuda else da_conv_dx_ref_generic,
                             kernel_size=k)


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
    """DA conv at an odd kernel size with the kernels in both directions:
    K1/K2/K3 at k = 3, K5/K7/K6 at any other odd k."""

    @staticmethod
    def forward(ctx, x, kernel, bias, kernel_size: int, dilation_rate: int,
                skydome: bool):
        ctx.save_for_backward(x, kernel, bias)
        ctx.kernel_size = kernel_size
        ctx.dilation_rate, ctx.skydome = dilation_rate, skydome
        return _forward_of(x, kernel_size)(x, kernel, bias, dilation_rate=dilation_rate,
                                           skydome=skydome)

    @staticmethod
    def backward(ctx, g):
        x, kernel, bias = ctx.saved_tensors
        k = ctx.kernel_size
        dx = dk = db = None
        geom = dict(dilation_rate=ctx.dilation_rate, skydome=ctx.skydome)
        if ctx.needs_input_grad[1] and _WEIGHT_GRADS:
            dk = _dk_of(g, k)(x, g, **geom).to(kernel.dtype)
        if ctx.needs_input_grad[2] and _WEIGHT_GRADS:
            db = g.float().sum((0, 1, 2)).to(bias.dtype)
        if ctx.needs_input_grad[0]:
            dx = _dx_of(g, k)(g, kernel, x_shape=tuple(x.shape), **geom).to(x.dtype)
        return dx, dk, db, None, None, None


def da_conv(x, kernel, bias, *, kernel_size: int = 3, dilation_rate: int = 1,
            skydome: bool = True) -> torch.Tensor:
    """The DA conv as the layers call it (stride 1, x [b,h,w,c],
    kernel [k2*c, f], bias [f], k odd)."""
    _require(kernel_size % 2 == 1, f"the DA conv takes an odd kernel size, got {kernel_size}")
    return DAConvFunction.apply(x, kernel, bias, kernel_size, dilation_rate, skydome)
