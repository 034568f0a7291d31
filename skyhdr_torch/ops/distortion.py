"""Distortion-aware (DA) equirectangular conv: sampling tables, the plain
gather form, and the DAConv / DADeconv layers.

The NumPy table builders are copies of `skyhdr.ops.distortion`
(`distortion_offsets`, `gather_tables`, `scatter_tables`,
`scatter_tables_k3`); the tests hold them `np.array_equal` to the originals.
`strip_tables` (the pair lists of the input-gradient kernels K2/K7) and
`window_tables` (the grouped rows of the forward kernels K1/K5) are the
port's own; the tests hold them to `scatter_tables` and the k=3 slots, and
to `gather_tables`.
Geometry: every panorama row projects
the k x k kernel grid onto the sphere's tangent plane at that row's
elevation, so the sampling offsets depend on the row and the tap, never on
the column. Width wraps cyclically (a true 360 degrees); height is
zero-padded by k // 2 and the sample row is clipped into the padded range.

`deformable_conv2d` is the plain PyTorch form of the op, the oracle of the
CUDA kernels in `skyhdr_torch.ops.kernels.deform_conv`. The layers call
`da_conv` there, which launches the kernels on CUDA tensors.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from skyhdr_torch.ops import width

PI = np.pi


@functools.lru_cache(maxsize=None)
def distortion_offsets(h: int, w: int, kernel_size: int = 3,
                       dilation_rate: int = 1, skydome: bool = True) -> np.ndarray:
    """[h, k^2, 2] per-row (dy, dx) sampling offsets relative to the window's
    own tap position."""
    k = kernel_size
    assert k % 2 == 1, "kernel_size must be odd"
    middle = (k // 2) * (k + 1)

    unit_w = 2.0 * PI / w
    unit_h = PI / (h * 2 if skydome else h)
    rho = np.tan(unit_w) * dilation_rate

    # Tap grid, y (slow) and x (fast) both from +r to -r.
    r = k // 2
    gy, gx = np.meshgrid(np.arange(r, -r - 1, -1), np.arange(r, -r - 1, -1),
                         indexing="ij")
    grid = np.stack([gx.ravel(), gy.ravel()], axis=-1).astype(np.float64)  # [k2,(x,y)]

    x_c = int(w * 0.5)
    y_rows = np.arange(h, dtype=np.float64)
    theta = (x_c - 0.5 * w) * unit_w  # == 0 at the center column
    phi = (h - y_rows) * unit_h if skydome else (h * 0.5 - y_rows) * unit_h

    # Unit sphere point per row and its tangent basis (t_x = v x p, t_y = p x t_x).
    p_u = np.stack([np.cos(phi) * np.cos(theta), np.sin(phi),
                    np.cos(phi) * np.sin(theta)], axis=-1)  # [h, 3]
    v = np.array([0.0, 1.0, 0.0])
    t_x = np.cross(np.broadcast_to(v, p_u.shape), p_u)
    t_y = np.cross(p_u, t_x)

    # Tangent-plane displacement per (row, tap) and re-projection.
    disp = rho * (grid[None, :, 0:1] * t_x[:, None, :] +
                  grid[None, :, 1:2] * t_y[:, None, :])  # [h, k2, 3]
    p_ur = p_u[:, None, :] + disp

    ux, uy, uz = p_ur[..., 0], p_ur[..., 1], p_ur[..., 2]
    theta_r = np.arctan2(uz, ux)
    theta_r = np.where(ux < 0, np.where(uz >= 0, theta_r + PI, theta_r - PI), theta_r)
    phi_r = np.arcsin(np.clip(uy, -1.0, 1.0))

    x_r = (theta_r / PI + 1.0) * 0.5 * w
    y_r = (1.0 - 2.0 * phi_r / PI) * h if skydome else (0.5 - phi_r / PI) * h

    kpts = np.stack([y_r, x_r], axis=-1)  # [h, k2, (y, x)]
    offset = kpts - kpts[:, middle:middle + 1, :]
    return offset.astype(np.float32)


class GatherTables(NamedTuple):
    """Static per-(row, tap) sampling tables."""

    y0: np.ndarray  # [h_out, k2] int32, padded-row index of the floor sample
    y1: np.ndarray  # [h_out, k2] int32
    cx0: np.ndarray  # [h_out, k2] int32, column shift of the floor sample
    cx1: np.ndarray  # [h_out, k2] int32
    wy: np.ndarray  # [h_out, k2] f32, fractional weight toward y1
    wx: np.ndarray  # [h_out, k2] f32, fractional weight toward x1
    pad: int
    h_pad: int


@functools.lru_cache(maxsize=None)
def gather_tables(h: int, w: int, kernel_size: int = 3, stride: int = 1,
                  dilation_rate: int = 1, skydome: bool = True) -> GatherTables:
    """Integer gather indices and bilinear weights from the offset table."""
    k = kernel_size
    pad = (k - 1) // 2
    h_out = (h + stride - 1) // stride
    off = distortion_offsets(h_out, w, k, dilation_rate, skydome).astype(np.float64)
    dy, dx = off[..., 0], off[..., 1]  # [h_out, k2]

    ty = np.repeat(np.arange(k), k)[None, :].astype(np.float64)  # tap row 0..k-1
    tx = np.tile(np.arange(k), k)[None, :].astype(np.float64)

    i = np.arange(h_out, dtype=np.float64)[:, None]
    # Absolute padded-row coordinate of the sample for output row i, tap t.
    yf = i * stride + ty + dy
    h_pad = h + 2 * pad
    yf = np.clip(yf, 0.0, h_pad - 1)
    y0 = np.floor(yf)
    wy = yf - y0
    y1 = np.minimum(y0 + 1, h_pad - 1)

    # Column shift relative to j*stride (column-independent).
    xf = tx - pad + dx
    x0 = np.floor(xf)
    wx = xf - x0
    x1 = x0 + 1.0  # wrapped modulo w at apply time

    return GatherTables(
        y0=y0.astype(np.int32), y1=y1.astype(np.int32),
        cx0=(x0 % w).astype(np.int32), cx1=(x1 % w).astype(np.int32),
        wy=wy.astype(np.float32), wx=wx.astype(np.float32),
        pad=pad, h_pad=h_pad,
    )


class ScatterTables(NamedTuple):
    """The gather inverted per input row, any odd k: for input row y, the
    padded list of forward references (output row i, tap) that read it,
    with the row weight and the tap's column shift and fraction."""

    ri: np.ndarray   # [h, R] int32 — forward output row i
    rt: np.ndarray   # [h, R] int32 — tap index
    rw: np.ndarray   # [h, R] f32 — row weight: (1-wy) if y==y0 else wy; 0=pad
    rcx: np.ndarray  # [h, R] int32 — column shift cx0(i, tap)
    rwx: np.ndarray  # [h, R] f32 — column fraction wx(i, tap)
    nrefs: int


@functools.lru_cache(maxsize=None)
def scatter_tables(h: int, w: int, kernel_size: int = 3, stride: int = 1,
                   dilation_rate: int = 1, skydome: bool = True) -> ScatterTables:
    t = gather_tables(h, w, kernel_size, stride, dilation_rate, skydome)
    h_out = t.y0.shape[0]
    k2 = kernel_size * kernel_size
    refs = [[] for _ in range(h)]  # unpadded row index
    for i in range(h_out):
        for tap in range(k2):
            wy = float(t.wy[i, tap])
            for y_pad, wgt in ((int(t.y0[i, tap]), 1.0 - wy),
                               (int(t.y1[i, tap]), wy)):
                y = y_pad - t.pad
                if 0 <= y < h and wgt != 0.0:
                    refs[y].append((i, tap, wgt,
                                    int(t.cx0[i, tap]), float(t.wx[i, tap])))
    nrefs = max(len(r) for r in refs)
    ri = np.zeros((h, nrefs), np.int32)
    rt = np.zeros((h, nrefs), np.int32)
    rw = np.zeros((h, nrefs), np.float32)
    rcx = np.zeros((h, nrefs), np.int32)
    rwx = np.zeros((h, nrefs), np.float32)
    for y, lst in enumerate(refs):
        for r, (i, tap, wgt, cx, wx) in enumerate(lst):
            ri[y, r], rt[y, r], rw[y, r], rcx[y, r], rwx[y, r] = (
                i, tap, wgt, cx, wx)
    return ScatterTables(ri=ri, rt=rt, rw=rw, rcx=rcx, rwx=rwx, nrefs=nrefs)


class ScatterTablesK3(NamedTuple):
    """The k=3 gather inverted per input row: for input row y, the "slots"
    (forward output row i, kernel row ky) that read it, with the row weight
    and the three kx column shifts and fractions of the slot."""

    si: np.ndarray   # [h, S] int32 — forward output row i (0 = pad)
    sw: np.ndarray   # [h, S] f32 — row weight; 0 marks slot padding
    sky: np.ndarray  # [h, S] int32 — kernel row ky of the slot
    scx: np.ndarray  # [h, S*3] int32 — column shift, kx-major per slot
    swx: np.ndarray  # [h, S*3] f32 — column fraction, kx-major per slot
    nslots: int


@functools.lru_cache(maxsize=None)
def scatter_tables_k3(h: int, w: int, stride: int = 1,
                      dilation_rate: int = 1,
                      skydome: bool = True) -> ScatterTablesK3:
    t = gather_tables(h, w, 3, stride, dilation_rate, skydome)
    h_out = t.y0.shape[0]
    slots = [[] for _ in range(h)]
    for i in range(h_out):
        for ky in range(3):
            tap0 = 3 * ky
            wy = float(t.wy[i, tap0])
            for y_pad, wgt in ((int(t.y0[i, tap0]), 1.0 - wy),
                               (int(t.y1[i, tap0]), wy)):
                y = y_pad - t.pad
                if 0 <= y < h and wgt != 0.0:
                    slots[y].append((i, wgt, ky,
                                     t.cx0[i, tap0:tap0 + 3],
                                     t.wx[i, tap0:tap0 + 3]))
    nslots = max(len(s) for s in slots)
    si = np.zeros((h, nslots), np.int32)
    sw = np.zeros((h, nslots), np.float32)
    sky = np.zeros((h, nslots), np.int32)
    scx = np.zeros((h, nslots, 3), np.int32)
    swx = np.zeros((h, nslots, 3), np.float32)
    for y, lst in enumerate(slots):
        for s, (i, wgt, ky, cxs, wxs) in enumerate(lst):
            si[y, s], sw[y, s], sky[y, s] = i, wgt, ky
            scx[y, s], swx[y, s] = cxs, wxs
    return ScatterTablesK3(si=si, sw=sw, sky=sky,
                           scx=scx.reshape(h, nslots * 3),
                           swx=swx.reshape(h, nslots * 3), nslots=nslots)


class StripTables(NamedTuple):
    """The gather inverted per strip of `rows` consecutive input rows, any
    odd k: for strip s (input rows [s*rows, s*rows + rows)), the forward's
    (output row i, tap) pairs whose floor row y0 or ceiling row y1 lies in
    the strip, each listed once, sorted by y0. Pair n adds w0 * P to input
    row y0 and w1 * P to row y0 + 1, where P = U @ K_t^T and
    U[j] = (1-wx) g[i][(j-cx) mod w] + wx g[i][(j-cx-1) mod w]; a weight
    whose row lies outside the strip (or is a zero pad row) is 0, and the
    pole clamp (y1 == y0) gives its whole weight to w0."""

    pint: np.ndarray   # [n, 4] int32 — (i, tap, cx, y0 - s*rows), the last in [-1, rows)
    pflt: np.ndarray   # [n, 4] f32 — (wx, w0, w1, 0)
    start: np.ndarray  # [strips + 1] int32 — strip s holds pairs start[s]:start[s+1]
    rows: int


@functools.lru_cache(maxsize=None)
def strip_tables(h: int, w: int, kernel_size: int = 3, rows: int = 4,
                 dilation_rate: int = 1, skydome: bool = True) -> StripTables:
    """The pair lists of the input-gradient kernels K2/K7 (stride 1), from
    `gather_tables`. The row weights are `scatter_tables`' (f32 of
    1 - wy and wy), so a strip's pairs give each (input row, output row,
    tap) the weight its references there carry."""
    t = gather_tables(h, w, kernel_size, 1, dilation_rate, skydome)
    k2 = kernel_size * kernel_size
    strips = -(-h // rows)
    pint = [[] for _ in range(strips)]
    pflt = [[] for _ in range(strips)]
    for i in range(h):
        for tap in range(k2):
            wy = float(t.wy[i, tap])
            y0, y1 = int(t.y0[i, tap]) - t.pad, int(t.y1[i, tap]) - t.pad
            for s in {y0 // rows, y1 // rows}:
                lo = s * rows
                wgt = [0.0, 0.0]  # to rows y0 and y0 + 1
                for y, wr in ((y0, 1.0 - wy), (y1, wy)):
                    if 0 <= y < h and lo <= y < lo + rows and wr != 0.0:
                        wgt[y - y0] += wr
                if wgt != [0.0, 0.0]:
                    pint[s].append((i, tap, int(t.cx0[i, tap]), y0 - lo))
                    pflt[s].append((float(t.wx[i, tap]), *wgt, 0.0))
    order = [sorted(range(len(p)), key=lambda n, p=p: p[n][3]) for p in pint]
    start = np.cumsum([0] + [len(p) for p in pint]).astype(np.int32)
    return StripTables(
        pint=np.array([pint[s][n] for s in range(strips) for n in order[s]],
                      np.int32).reshape(-1, 4),
        pflt=np.array([pflt[s][n] for s in range(strips) for n in order[s]],
                      np.float32).reshape(-1, 4),
        start=start, rows=rows)


# A group's window grows by its span; past this many columns the forward
# takes one group per tap (span 0) instead.
WINDOW_SPAN_MAX = 32


class WindowTables(NamedTuple):
    """The sampling tables of the forward kernels K1/K5, grouped. A group
    is a kernel row when every tap of each kernel row reads the same two
    source rows with the same weight (`gather_tables` then has y0, y1 and
    wy constant across kx), else a single tap. Per output row i and group
    g: the group's source rows and row weight, and `base`, the column shift
    of its window's first column. The kernel y-interpolates that window
    (`span` + 1 columns more than its tile) once, and each tap of the
    group x-interpolates from it at its offset `d` (in [0, span]):
        window[c]  = (1-wy) xpad[y0][(j0 + base + c) mod w] + wy xpad[y1][...]
        sample[j]  = (1-wx) window[j - j0 + d] + wx window[j - j0 + d + 1],
    the gather form's sample, since (base + d) mod w is the tap's cx0."""

    y0: np.ndarray    # [h, G] int32 — padded row of the floor sample (gather y0)
    y1: np.ndarray    # [h, G] int32
    wy: np.ndarray    # [h, G] f32 — weight toward y1
    base: np.ndarray  # [h, G] int32 — window start, a column shift in [0, w)
    d: np.ndarray     # [h, k2] int32 — the tap's offset into its group's window
    wx: np.ndarray    # [h, k2] f32 — the tap's weight toward column x1
    taps: int         # taps per group: k (a kernel row) or 1
    span: int         # max of d over the table
    pad: int


def _rows_shared(t: GatherTables, k: int) -> bool:
    """Whether y0, y1 and wy are constant across kx in every kernel row."""
    h = t.y0.shape[0]
    for a in (t.y0, t.y1, t.wy):
        rows = a.reshape(h, k, k)
        if not np.array_equal(rows, np.broadcast_to(rows[:, :, :1], rows.shape)):
            return False
    return True


def _arcs(cx: np.ndarray, w: int):
    """Per group (last axis: its taps' column shifts in [0, w)), the
    shortest cyclic arc holding them all: its first shift and its length."""
    s = np.sort(cx, -1)
    gaps = np.diff(s, append=s[..., :1] + w, axis=-1)  # the last wraps around
    m = gaps.argmax(-1)[..., None]
    base = np.take_along_axis(s, (m + 1) % cx.shape[-1], -1)[..., 0]
    return base, w - np.take_along_axis(gaps, m, -1)[..., 0]


@functools.lru_cache(maxsize=None)
def window_tables(h: int, w: int, kernel_size: int = 3, dilation_rate: int = 1,
                  skydome: bool = True, dedup: bool = True) -> WindowTables:
    """`gather_tables` (stride 1) grouped for K1/K5: one group per kernel
    row where the rows are shared and the span stays within
    WINDOW_SPAN_MAX, one per tap otherwise (or when `dedup` is False)."""
    k = kernel_size
    t = gather_tables(h, w, k, 1, dilation_rate, skydome)
    n = k if dedup and _rows_shared(t, k) else 1
    base, span = _arcs(t.cx0.reshape(h, k * k // n, n), w)
    if n > 1 and span.max() > WINDOW_SPAN_MAX:
        n = 1
        base, span = _arcs(t.cx0.reshape(h, k * k, 1), w)
    d = (t.cx0.reshape(h, -1, n) - base[..., None]) % w
    return WindowTables(
        y0=t.y0[:, ::n].copy(), y1=t.y1[:, ::n].copy(), wy=t.wy[:, ::n].copy(),
        base=base.astype(np.int32), d=d.reshape(h, k * k).astype(np.int32),
        wx=t.wx, taps=n, span=int(span.max()), pad=t.pad)


def signed_shifts(cx: np.ndarray, w: int) -> np.ndarray:
    """Column shifts in [0, w) as signed shifts in [-w/2, w/2)."""
    return ((cx + w // 2) % w) - w // 2


@functools.lru_cache(maxsize=None)
def ring_window_tables(h: int, w: int, halo: int, kernel_size: int = 3,
                       dilation_rate: int = 1, skydome: bool = True) -> WindowTables:
    """`window_tables` of the panorama of width `w` for a width shard
    extended by `halo` columns on each side (`parallel.spatial`): each
    group's `base` is its signed shift plus `halo`, so that output column j
    of the extended shard reads extended column j + base + d, the full
    panorama's sample for the shard's column j (j < the shard's width): no
    read of a kept column wraps, since every |shift| (and the x1
    neighbour's) is at most `halo`. Raises ValueError where a group's window
    does not stay within that bound."""
    t = window_tables(h, w, kernel_size, dilation_rate, skydome)
    base = signed_shifts(t.base, w) + halo
    group_base = np.repeat(base, t.taps, axis=1)  # [h, k2]
    cx0 = gather_tables(h, w, kernel_size, 1, dilation_rate, skydome).cx0
    if base.min() < 0 or not np.array_equal(group_base + t.d - halo,
                                            signed_shifts(cx0, w)):
        raise ValueError(f"a halo of {halo} columns does not hold the column shifts of a "
                         f"{h}x{w} panorama at k={kernel_size}, dilation {dilation_rate}")
    if (group_base + t.d).max() + 1 > 2 * halo:
        raise ValueError(f"a halo of {halo} columns is narrower than the shifts of a "
                         f"{h}x{w} panorama at k={kernel_size}, dilation {dilation_rate}")
    return t._replace(base=base.astype(np.int32))


@functools.lru_cache(maxsize=None)
def ring_strip_tables(h: int, w: int, halo: int, kernel_size: int = 3, rows: int = 4,
                      dilation_rate: int = 1, skydome: bool = True) -> StripTables:
    """`strip_tables` of the panorama of width `w` for a width shard
    extended by `halo` columns on each side (`parallel.spatial`): each
    pair's column shift re-based to halo + its signed shift, in
    [0, 2 halo). The input-gradient walk over the extended shard, its
    cotangent zero outside the shard's own columns [0, w_local) and read
    modulo the extended width w_local + 2 halo, then forms dx of every
    extended column, the two halos' included (they go back to the
    neighbours that sent them): a read (j - cx) or (j - cx - 1) that wraps
    lands in the 2 halo zero columns. Raises ValueError where a shift (or
    its x1 neighbour) exceeds the halo."""
    t = strip_tables(h, w, kernel_size, rows, dilation_rate, skydome)
    cx = signed_shifts(t.pint[:, 2], w) + halo
    if cx.size and (cx.min() < 0 or cx.max() > 2 * halo - 1):
        raise ValueError(f"a halo of {halo} columns does not hold the column shifts of a "
                         f"{h}x{w} panorama at k={kernel_size}, dilation {dilation_rate}")
    pint = t.pint.copy()
    pint[:, 2] = cx
    return t._replace(pint=pint)


def _on(device, arr) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


@functools.lru_cache(maxsize=None)
def gather_tables_on(device: torch.device, h: int, w: int,
                     kernel_size: int = 3, dilation_rate: int = 1,
                     skydome: bool = True):
    """`gather_tables` (stride 1) as device tensors (y0, y1, cx0, wy, wx),
    built once per shape and device."""
    t = gather_tables(h, w, kernel_size, 1, dilation_rate, skydome)
    return tuple(_on(device, a) for a in (t.y0, t.y1, t.cx0, t.wy, t.wx))


@functools.lru_cache(maxsize=None)
def window_tables_on(device: torch.device, h: int, w: int, kernel_size: int = 3,
                     dilation_rate: int = 1, skydome: bool = True, dedup: bool = True,
                     halo: int = None):
    """`window_tables` packed for the forward kernels as device tensors:
    rows int32 [h, G, 4] (y0 - pad, y1 - pad, base, the bits of wy) and
    taps int32 [h, k2, 2] (d, the bits of wx); plus the taps per group and
    the span. With `halo`, `ring_window_tables`' (an extended width
    shard's)."""
    t = (window_tables(h, w, kernel_size, dilation_rate, skydome, dedup) if halo is None
         else ring_window_tables(h, w, halo, kernel_size, dilation_rate, skydome))
    rows = np.stack([t.y0 - t.pad, t.y1 - t.pad, t.base, t.wy.view(np.int32)], -1)
    taps = np.stack([t.d, t.wx.view(np.int32)], -1)
    return _on(device, rows), _on(device, taps), t.taps, t.span


@functools.lru_cache(maxsize=None)
def scatter_tables_k3_on(device: torch.device, h: int, w: int,
                         dilation_rate: int = 1, skydome: bool = True):
    """`scatter_tables_k3` (stride 1) as device tensors
    (si, sw, sky, scx, swx) plus the slot count."""
    st = scatter_tables_k3(h, w, 1, dilation_rate, skydome)
    return (tuple(_on(device, a) for a in (st.si, st.sw, st.sky, st.scx, st.swx)),
            st.nslots)


@functools.lru_cache(maxsize=None)
def scatter_tables_on(device: torch.device, h: int, w: int, kernel_size: int,
                      dilation_rate: int = 1, skydome: bool = True):
    """`scatter_tables` (stride 1) as device tensors (ri, rt, rw, rcx, rwx)
    plus the reference count."""
    st = scatter_tables(h, w, kernel_size, 1, dilation_rate, skydome)
    return (tuple(_on(device, a) for a in (st.ri, st.rt, st.rw, st.rcx, st.rwx)),
            st.nrefs)


@functools.lru_cache(maxsize=None)
def strip_tables_on(device: torch.device, h: int, w: int, kernel_size: int,
                    rows: int, dilation_rate: int = 1, skydome: bool = True,
                    halo: int = None):
    """`strip_tables` (stride 1) as device tensors (pint, pflt, start); with
    `halo`, `ring_strip_tables`' (an extended width shard's)."""
    st = (strip_tables(h, w, kernel_size, rows, dilation_rate, skydome) if halo is None
          else ring_strip_tables(h, w, halo, kernel_size, rows, dilation_rate, skydome))
    return tuple(_on(device, a) for a in (st.pint, st.pflt, st.start))


def mm_dtype(x: torch.Tensor) -> torch.dtype:
    """Matmul operand dtype of the DA conv: bf16 only when x is bf16
    (`skyhdr/ops/pallas/deform_conv.py:_mm_dtype`). Interpolation and
    accumulation stay float32 either way."""
    return torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32


def deformable_conv2d(x, kernel, bias, *, kernel_size: int = 3,
                      dilation_rate: int = 1, skydome: bool = True, ring=None):
    """Plain DA conv (stride 1) of x [b, h, w, c] with kernel [k2*c, f],
    tap-major, and bias [f]; returns [b, h, w, f] in x.dtype.

    The gather form of `skyhdr.ops.distortion.deformable_conv2d`:
        rowY   = (1-wy)*xpad[y0] + wy*xpad[y1]
        sample = (1-wx)*rowY[(j+cx) mod w] + wx*rowY[(j+cx+1) mod w]
        out    = bias + sum_t sample_t @ K_t
    in float32, with the matmul operands rounded to bf16 when x is bf16
    (the kernels' precision contract).

    `ring=(w_full, halo)`: x is a width shard of a panorama of width w_full
    extended by `halo` columns on each side (`parallel.spatial`); the
    result is the shard's own w - 2 halo columns, column j sampled at
    extended column j + halo + s with s the full panorama's signed shift
    (no wrap)."""
    b, h, w, c = x.shape
    k2 = kernel_size * kernel_size
    pad = kernel_size // 2
    dev = x.device
    w_tab, halo = (w, 0) if ring is None else ring
    y0, y1, cx0, wys, wxs = gather_tables_on(dev, h, w_tab, kernel_size,
                                             dilation_rate, skydome)
    mmdt = mm_dtype(x)
    f = kernel.shape[-1]
    w_out = w - 2 * halo

    xp = nn.functional.pad(x.float(), (0, 0, 0, 0, pad, pad))
    kern = kernel.to(mmdt).float().reshape(k2, c, f)
    jcols = torch.arange(w_out, device=dev)
    out = torch.zeros((b, h, w_out, f), dtype=torch.float32, device=dev)
    for tap in range(k2):
        wy = wys[:, tap][None, :, None, None]
        wx = wxs[:, tap][None, :, None, None]
        row0 = xp[:, y0[:, tap].long()]
        row1 = xp[:, y1[:, tap].long()]
        row_y = (1 - wy) * row0 + wy * row1  # [b, h, w, c]
        cx = cx0[:, tap].long()[:, None]
        if ring is None:
            xmat0 = (jcols[None, :] + cx) % w  # [h, w]
            g0 = torch.gather(row_y, 2, xmat0[None, :, :, None].expand(b, h, w, c))
            g1 = torch.roll(g0, -1, dims=2)
        else:
            xmat0 = jcols[None, :] + halo + ((cx + w_tab // 2) % w_tab - w_tab // 2)
            g0, g1 = (torch.gather(row_y, 2, (xmat0 + e)[None, :, :, None].expand(
                b, h, w_out, c)) for e in (0, 1))
        sample = (1 - wx) * g0 + wx * g1
        out = out + torch.einsum("bhwc,cf->bhwf",
                                 sample.to(mmdt).float(), kern[tap])
    return (out + bias.float()).to(x.dtype)


class DAConv(nn.Module):
    """Distortion-aware conv layer, stride 1, parameters `kernel` [k2*c, f]
    and `bias` [f] as in `skyhdr.ops.distortion.DAConv`."""

    def __init__(self, in_features: int, filters: int, kernel_size: int = 3,
                 dilation_rate: int = 1, skydome: bool = True, device=None):
        super().__init__()
        k2 = kernel_size * kernel_size
        self.kernel_size = kernel_size
        self.dilation_rate = dilation_rate
        self.skydome = skydome
        self.kernel = nn.Parameter(torch.empty(k2 * in_features, filters, device=device))
        self.bias = nn.Parameter(torch.empty(filters, device=device))

    def flax_leaves(self):
        return [("params", "kernel", self.kernel, "same", "glorot"),
                ("params", "bias", self.bias, "same", "zeros")]

    def forward(self, x):
        """On a width shard (`ops.width`), `parallel.spatial.
        ring_deformable_conv2d` over the ring."""
        from skyhdr_torch.ops.kernels.deform_conv import da_conv

        geom = dict(kernel_size=self.kernel_size, dilation_rate=self.dilation_rate,
                    skydome=self.skydome)
        ring = width.current()
        if ring is not None:
            from skyhdr_torch.parallel.spatial import ring_deformable_conv2d

            return ring_deformable_conv2d(x, self.kernel, self.bias, mesh=ring.mesh, **geom)
        return da_conv(x, self.kernel, self.bias, **geom)


class DADeconv(DAConv):
    """Bilinear resize to `out_hw`, then a DA conv
    (`skyhdr.ops.distortion.DADeconv`)."""

    def __init__(self, in_features: int, filters: int,
                 out_hw: Tuple[int, int], kernel_size: int = 3,
                 dilation_rate: int = 1, skydome: bool = True, device=None):
        super().__init__(in_features, filters, kernel_size, dilation_rate,
                         skydome, device=device)
        self.out_hw = tuple(out_hw)

    def forward(self, x):
        from skyhdr_torch.ops.resize import resize_bilinear

        return super().forward(resize_bilinear(x, self.out_hw))
