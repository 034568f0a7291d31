"""The DA-conv probe kernels on Hopper: wrappers, their plain PyTorch
versions and the launch counters (csrc/probes.cu). They carry the probe
tools under `skyhdr_torch/tools/`, not the model.

  K10 `da_probe_k10` — the k=3 DA forward in one of the design variants of
      tools/exp_daconv.py (`PROBES`: storage, gather, taps per tile, row
      dedup, tensor cores, diag mode). Plain version: `da_probe_ref`, the
      variant's function in torch on `gather_tables`.
  K11 `pack_samples_k11` — the sample-packing copy [B,H,W,C] ->
      [B/P,H,W,P*C] of tools/exp_pack.py. Plain version: `pack_samples_ref`
      (a concatenation of strided slices); `pack_samples_library` is the one
      PyTorch call that does the same (a permute and a copy), a yardstick.
  K12 `mm_shape_k12` — the dot-shape microbench of tools/exp_mmshape.py:
      `steps` blocks, each computing ndots * (lhs @ rhs). Plain version:
      `mm_shape_ref`, the same products as batched matmuls.

Dispatch is by device only (`da_probe`, `pack_samples`, `mm_shape`): a CPU
tensor takes the plain version, a CUDA tensor launches the kernel or
raises. `K10_LAUNCHES` ... `K12_LAUNCHES` count launches, one per wrapper
call that launches; `K10_BY_PROBE` counts K10's by instantiation.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from skyhdr_torch.ops.distortion import gather_tables, gather_tables_on

K10_LAUNCHES = 0
K11_LAUNCHES = 0
K12_LAUNCHES = 0
K10_BY_PROBE: dict = {}

# Diag modes whose output is the first F channels of a sum of samples (no product).
SUM_MODES = ("nomm", "loadonly", "load1only")


class Probe(NamedTuple):
    """One K10 instantiation: the design choices it makes, which
    `skyhdr_probe_fwd` (csrc/probes.cu) takes to pick it."""

    store: torch.dtype   # storage of x
    gather: str          # "direct" (A) or "staged" (the sample tile in shared memory)
    taps: int            # taps contracted per staged tile: 1, 2 or 9
    dedup: bool          # one y-interpolation per (row, kernel row)
    mma: bool            # bf16 tensor cores (else f32 FMA)
    diag: str            # "" (the whole forward) or a stage isolated, as in
                         # `_kernel_diag`: noroll, nomm, mmonly, mmhoist,
                         # loadonly, load1only


# The codes of `gather` and `diag` in csrc/probes.cu (enums Gather, Diag).
GATHERS = ("direct", "staged")
DIAGS = ("", "noroll", "nomm", "mmonly", "mmhoist", "loadonly", "load1only")

_F, _B = torch.float32, torch.bfloat16
# name -> Probe; csrc/probes.cu instantiates each of these (SKYHDR_PROBES).
PROBES = {
    "a": Probe(_F, "direct", 1, False, False, ""),
    "a_bf16": Probe(_B, "direct", 1, False, False, ""),
    "c": Probe(_F, "staged", 1, False, False, ""),
    "c_bf16": Probe(_B, "staged", 1, False, False, ""),
    "cs": Probe(_F, "staged", 9, False, False, ""),
    "cs_bf16": Probe(_B, "staged", 9, False, False, ""),
    "pair_bf16": Probe(_B, "staged", 2, False, False, ""),
    "mma_bf16": Probe(_B, "staged", 1, False, True, ""),
    "dedup_bf16": Probe(_B, "staged", 1, True, False, ""),
    "mma": Probe(_F, "staged", 1, False, True, ""),
    "noroll_bf16": Probe(_B, "staged", 1, False, False, "noroll"),
    "nomm_bf16": Probe(_B, "staged", 1, False, False, "nomm"),
    "mmonly_bf16": Probe(_B, "staged", 1, False, False, "mmonly"),
    "mmhoist_bf16": Probe(_B, "staged", 1, False, False, "mmhoist"),
    "loadonly_bf16": Probe(_B, "staged", 1, False, False, "loadonly"),
    "load1only_bf16": Probe(_B, "staged", 1, False, False, "load1only"),
    "mmonly_mma_bf16": Probe(_B, "staged", 1, False, True, "mmonly"),
    "noroll": Probe(_F, "staged", 1, False, False, "noroll"),
    "nomm": Probe(_F, "staged", 1, False, False, "nomm"),
    "mmonly": Probe(_F, "staged", 1, False, False, "mmonly"),
    "mmhoist": Probe(_F, "staged", 1, False, False, "mmhoist"),
    "loadonly": Probe(_F, "staged", 1, False, False, "loadonly"),
    "load1only": Probe(_F, "staged", 1, False, False, "load1only"),
}


def probe_named(name: str) -> Probe:
    if name not in PROBES:
        raise ValueError(f"no K10 instantiation {name!r}; have {sorted(PROBES)}")
    return PROBES[name]


def find_probe(store: torch.dtype, *, gather: str = "staged", taps: int = 1,
               dedup: bool = False, mma: bool = False, diag: str = "") -> str:
    """The name of the instantiation with these choices; raises if none."""
    want = (store, gather, taps, dedup, mma, diag)
    for name, p in PROBES.items():
        if tuple(p) == want:
            return name
    raise ValueError(f"no K10 instantiation for {want}")


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptrs(*tensors):
    for t in tensors:
        _require(t.is_contiguous() and t.data_ptr() % 16 == 0,
                 "probe kernel operands must be contiguous and 16-byte aligned")
    return [t.data_ptr() for t in tensors]


@functools.lru_cache(maxsize=None)
def dedup_span(h: int, w: int) -> int:
    """The largest spread of the three column shifts of one kernel row
    (cyclic, in columns) over the rows of a k=3 map: K10's row-dedup
    window is the column tile plus this plus one."""
    cx = gather_tables(h, w, 3, 1, 1, True).cx0.reshape(h, 3, 3).astype(np.int64)
    rel = (cx - cx[:, :, :1]) % w
    rel = np.where(rel > w // 2, rel - w, rel)
    lo = np.minimum(rel.min(-1), 0)
    hi = np.maximum(rel.max(-1), 0)
    return int((hi - lo).max())


def _check_x(x, kernel, name):
    _require(x.dim() == 4, f"{name}: x must be [b,h,w,c], got {tuple(x.shape)}")
    _require(tuple(kernel.shape[:1]) == (9 * x.shape[-1],) and kernel.dim() == 2,
             f"{name}: kernel must be [9c, f], got {tuple(kernel.shape)}")


def da_probe_k10(x, kernel, probe: str, *, rblk: int = 2, mblk: int = 1) -> torch.Tensor:
    """K10: the k=3 DA forward of instantiation `probe` on the card.
    x [b,h,w,c] (cast to the probe's storage type), kernel [9c,f] (f32, or
    bf16 into the tensor cores); returns out [b,h,w,f] float32, no bias.
    rblk output rows per block (h % rblk == 0); mblk rows stacked in M
    (dedup only)."""
    global K10_LAUNCHES
    from skyhdr_torch.ops.kernels.build import check, library

    p = probe_named(probe)
    _check_x(x, kernel, "K10")
    _require(x.is_cuda and kernel.device == x.device,
             "K10 takes CUDA tensors on one device")
    b, h, w, c = x.shape
    f = kernel.shape[-1]
    _require(h % rblk == 0 and rblk % mblk == 0 and (p.dedup or mblk == 1),
             f"K10 {probe}: h={h}, rblk={rblk}, mblk={mblk} do not tile")
    xs = x.to(p.store).contiguous()
    if p.mma:
        kk = kernel.to(torch.bfloat16).t().contiguous()  # [f, 9c]
    else:
        kk = kernel.float().contiguous()
    y0, y1, cx, wy, wx = gather_tables_on(x.device, h, w, 3, 1, True)
    out = torch.empty((b, h, w, f), dtype=torch.float32, device=x.device)
    span = dedup_span(h, w) if p.dedup else 0
    code = library().skyhdr_probe_fwd(*_ptrs(xs, kk, y0, y1, cx, wy, wx, out),
                                      int(p.store == torch.bfloat16), GATHERS.index(p.gather),
                                      p.taps, int(p.dedup), int(p.mma), DIAGS.index(p.diag),
                                      b, h, w, c, f, rblk, mblk, span,
                                      x.device.index, _stream(x))
    check(code, f"K10 {probe} (x {tuple(x.shape)}, F={f}, rblk={rblk}, mblk={mblk})")
    K10_LAUNCHES += 1
    K10_BY_PROBE[probe] = K10_BY_PROBE.get(probe, 0) + 1
    return out


def da_probe_ref(x, kernel, probe: str, *, rblk: int = 2, mblk: int = 1) -> torch.Tensor:
    """Plain version of K10: the variant's function in float32 torch.
        xpad   = x padded by one zero row above and below, rounded to the
                 probe's storage type
        rowY_t = (1-wy) xpad[y0] + wy xpad[y1]
        s_t    = (1-wx) rowY_t[(j+cx) mod w] + wx rowY_t[(j+cx+1) mod w]
        out    = sum_t s_t @ K_t,
    with s_t and K_t rounded to bf16 for the tensor cores; the dedup
    variant takes every tap's y0, y1, wy from its kernel row's first tap, as
    `_kernel_dedup` does; a diag mode replaces s_t (noroll: rowY_t at
    column j; mmonly, load1only: xpad[y0] at column j; mmhoist: xpad[y0] of
    tap 0 for all nine products; loadonly: xpad[y0] + xpad[y1]) and the sum
    modes (nomm, loadonly, load1only) add the s_t and keep the first f
    channels. rblk and mblk change no value."""
    p = probe_named(probe)
    _check_x(x, kernel, "K10 plain")
    b, h, w, c = x.shape
    f = kernel.shape[-1]
    dev = x.device
    y0, y1, cx0, wys, wxs = gather_tables_on(dev, h, w, 3, 1, True)
    if p.dedup:  # every tap reads its kernel row's first tap's y tables
        y0, y1, wys = (t.reshape(h, 3, 3)[:, :, :1].expand(h, 3, 3).reshape(h, 9)
                       for t in (y0, y1, wys))
    xp = torch.nn.functional.pad(x.to(p.store).float(), (0, 0, 0, 0, 1, 1))
    kern = kernel.float()
    if p.mma:
        kern = kern.to(torch.bfloat16).float()
    kern = kern.reshape(9, c, f)
    jcols = torch.arange(w, device=dev)
    summing = p.diag in SUM_MODES
    acc = torch.zeros((b, h, w, c if summing else f), dtype=torch.float32, device=dev)
    for tap in range(9):
        ts = 0 if p.diag == "mmhoist" else tap
        row0 = xp[:, y0[:, ts].long()]
        if p.diag in ("mmonly", "mmhoist", "load1only"):
            s = row0
        else:
            row1 = xp[:, y1[:, ts].long()]
            if p.diag == "loadonly":
                s = row0 + row1
            else:
                wy = wys[:, tap][None, :, None, None]
                row_y = (1 - wy) * row0 + wy * row1
                if p.diag == "noroll":
                    s = row_y
                else:
                    cols = (jcols[None, :] + cx0[:, tap].long()[:, None]) % w  # [h, w]
                    g0 = torch.gather(row_y, 2, cols[None, :, :, None].expand(b, h, w, c))
                    g1 = torch.roll(g0, -1, dims=2)
                    wx = wxs[:, tap][None, :, None, None]
                    s = (1 - wx) * g0 + wx * g1
        if summing:
            acc = acc + s
        else:
            if p.mma:
                s = s.to(torch.bfloat16).float()
            acc = acc + torch.einsum("bhwc,cf->bhwf", s, kern[tap])
    return acc[..., :f].contiguous() if summing else acc


def da_probe(x, kernel, probe: str, *, rblk: int = 2, mblk: int = 1) -> torch.Tensor:
    """K10 on a CUDA tensor, its plain version on a CPU tensor."""
    fn = da_probe_k10 if x.is_cuda else da_probe_ref
    return fn(x, kernel, probe, rblk=rblk, mblk=mblk)


# ------------------------------------------------------------------ packing

def pack_samples_k11(x, p: int) -> torch.Tensor:
    """K11: [B,H,W,C] -> [B/P,H,W,P*C], out[i,..., s*C:(s+1)*C] = x[i*P+s],
    on the card (any dtype whose C elements fill whole 16-byte vectors)."""
    global K11_LAUNCHES
    from skyhdr_torch.ops.kernels.build import check, library

    _require(x.is_cuda and x.dim() == 4, "K11 takes a CUDA tensor [b,h,w,c]")
    b, h, w, c = x.shape
    _require(b % p == 0 and (c * x.element_size()) % 16 == 0,
             f"K11: b={b} must be a multiple of p={p} and c*itemsize of 16 bytes")
    x = x.contiguous()
    out = torch.empty((b // p, h, w, p * c), dtype=x.dtype, device=x.device)
    code = library().skyhdr_pack_samples(*_ptrs(x, out), b, h, w, c, p, x.element_size(),
                                         x.device.index, _stream(x))
    check(code, f"K11 (pack x {tuple(x.shape)}, p={p})")
    K11_LAUNCHES += 1
    return out


def pack_samples_ref(x, p: int) -> torch.Tensor:
    """Plain version of K11: the P strided slices side by side along the
    channels (the probe's `pack_concat`)."""
    return torch.cat([x[s::p] for s in range(p)], dim=-1)


def pack_samples_library(x, p: int) -> torch.Tensor:
    """One PyTorch call for K11's function (a strided view made contiguous;
    the probe's `pack_transpose`): the yardstick of the copy."""
    b, h, w, c = x.shape
    return x.view(b // p, p, h, w, c).permute(0, 2, 3, 1, 4).reshape(b // p, h, w, p * c)


def pack_samples(x, p: int) -> torch.Tensor:
    """K11 on a CUDA tensor, its plain version on a CPU tensor."""
    return pack_samples_k11(x, p) if x.is_cuda else pack_samples_ref(x, p)


def unpack_samples(y, p: int) -> torch.Tensor:
    """[B/P,H,W,P*F] -> [B,H,W,F], the inverse of the packing."""
    bp, h, w, pf = y.shape
    f = pf // p
    return y.view(bp, h, w, p, f).permute(0, 3, 1, 2, 4).reshape(bp * p, h, w, f)


def blockdiag_kernel(kernel, p: int) -> torch.Tensor:
    """[9c, f] -> [9 p c, p f]: per tap, K_t repeated p times on the block
    diagonal, so that P packed samples are contracted independently."""
    c9, f = kernel.shape
    c = c9 // 9
    kt = kernel.reshape(9, c, f)
    kb = torch.zeros((9, p * c, p * f), dtype=kernel.dtype, device=kernel.device)
    for i in range(p):
        kb[:, i * c:(i + 1) * c, i * f:(i + 1) * f] = kt
    return kb.reshape(9 * p * c, p * f)


# ------------------------------------------------------------ dot shapes

def _pad_to(t, rows: int, cols: int):
    if tuple(t.shape) == (rows, cols):
        return t
    return torch.nn.functional.pad(t, (0, cols - t.shape[1], 0, rows - t.shape[0]))


# K12's block tiles (rows, columns of the output; csrc/probes.cu), by the
# index `skyhdr_mm_shape` takes, and the depth of a staged chunk.
MM_TILES = ((256, 64), (128, 128), (64, 256))
MM_CHUNK = 32


def mm_tiling(m: int, k: int, f: int, bf16: bool) -> tuple:
    """(padded m, k, f, tile index) of a K12 launch: the block tile of
    MM_TILES whose padding of [m, f] leaves the fewest outputs (the first
    of equals), m and f padded to its sides and k to the staged chunk. The
    zero padding adds zero products. `bf16` picks the tensor-core kernel,
    which takes the same tiles."""
    def up(n, q):
        return -(-n // q) * q

    tile = min(range(len(MM_TILES)),
               key=lambda t: up(m, MM_TILES[t][0]) * up(f, MM_TILES[t][1]))
    bm, bf = MM_TILES[tile]
    return up(m, bm), up(k, MM_CHUNK), up(f, bf), tile


def mm_shape_k12(lhs, rhs, *, ndots: int, steps: int) -> torch.Tensor:
    """K12: `steps` blocks each computing ndots * (lhs @ rhs) (f32
    accumulation of ndots products) on the card; lhs [m,k], rhs [k,f], both
    float32 (CUDA-core FMA) or both bfloat16 (tensor cores). Returns [m,f]
    float32. The shapes are zero-padded to what the kernel tiles
    (`mm_tiling`)."""
    global K12_LAUNCHES
    from skyhdr_torch.ops.kernels.build import check, library

    _require(lhs.is_cuda and rhs.device == lhs.device, "K12 takes CUDA tensors on one device")
    _require(lhs.dtype == rhs.dtype and lhs.dtype in (torch.float32, torch.bfloat16),
             "K12 takes lhs and rhs both float32 or both bfloat16")
    m, k = lhs.shape
    k2, f = rhs.shape
    _require(k == k2, f"K12: lhs {tuple(lhs.shape)} and rhs {tuple(rhs.shape)} do not chain")
    bf16 = lhs.dtype == torch.bfloat16
    mp, kp, fp, tile = mm_tiling(m, k, f, bf16)
    a = _pad_to(lhs, mp, kp).contiguous()
    # bf16 takes rhs^T [f, k]: the mma's B fragments are K-contiguous rows.
    b = (_pad_to(rhs.t(), fp, kp) if bf16 else _pad_to(rhs, kp, fp)).contiguous()
    out = torch.empty((mp, fp), dtype=torch.float32, device=lhs.device)
    code = library().skyhdr_mm_shape(*_ptrs(a, b, out), mp, kp, fp, ndots, steps, int(bf16),
                                     tile, lhs.device.index, _stream(lhs))
    check(code, f"K12 ({m}x{k}@{k}x{f} x{ndots} x{steps}, {lhs.dtype})")
    K12_LAUNCHES += 1
    return out[:m, :f]


def mm_shape_ref(lhs, rhs, *, ndots: int, steps: int) -> torch.Tensor:
    """Plain version of K12: the same steps*ndots products, as ndots
    batched matmuls over the steps, summed in float32 (bf16 operands are
    taken exactly in float32); returns [m,f]."""
    a = lhs.float().expand(steps, *lhs.shape)
    b = rhs.float()
    acc = torch.zeros((steps, lhs.shape[0], rhs.shape[1]), dtype=torch.float32,
                      device=lhs.device)
    for _ in range(ndots):
        acc = acc + torch.matmul(a, b)
    return acc[0]


def mm_shape_library(lhs, rhs, *, ndots: int, steps: int) -> torch.Tensor:
    """One PyTorch call doing the same steps*ndots products at this shape
    (a batched matmul in the operands' type), the yardstick of K12."""
    return torch.matmul(lhs.expand(steps * ndots, *lhs.shape), rhs)


def mm_shape(lhs, rhs, *, ndots: int, steps: int) -> torch.Tensor:
    """K12 on CUDA tensors, its plain version on CPU tensors."""
    fn = mm_shape_k12 if lhs.is_cuda else mm_shape_ref
    return fn(lhs, rhs, ndots=ndots, steps=steps)
