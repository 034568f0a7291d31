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
call that launches; `K10_BY_PROBE` counts K10's by instantiation. K10's
launch plan is `probe_tiling`, pure Python: what it refuses, the wrapper
refuses with ValueError before any launch.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

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


# ------------------------------------------------------------ K10's plan

# The fields of csrc/probes.cu's DirectPlan and StagedPlan, in their order.
DIRECT_FIELDS = ("rows", "wpr", "vec", "fb", "ldg", "threads", "smem")
STAGED_FIELDS = ("g", "tw", "fb", "cc", "ts", "lead", "nslot", "wn", "nrow", "ks", "ch", "ld",
                 "ldk", "threads", "smem", "off_raw", "off_ywin", "off_k", "off_red",
                 "raw_slot", "ywin_slot", "tile_slot", "k_slot")
K10_SMEM = 232448 - 4096   # dynamic shared memory a block may take beside its tables (kMaxSmem)
K10_STATIC = 4096          # K10's static tables, at most
SM_SMEM = 233472           # shared memory of an H100 SM (228 KB), 1 KB of it reserved per block
K10_MAX_ROWS = 16          # output rows a block (rblk), at most
ONE_ROW_MODES = ("mmonly", "mmhoist", "load1only")  # read only xpad[y0]
H100_SMS = 132


class ProbeTiling(NamedTuple):
    """A K10 launch plan: the plan's fields (`DIRECT_FIELDS` or
    `STAGED_FIELDS` by name), the grid and the blocks an SM holds."""

    plan: dict
    grid: tuple      # (column tiles x F tiles, h / rblk, b)
    resident: int    # blocks an SM holds at once (the occupancy API's count on the card)

    @property
    def fields(self) -> tuple:
        return _fields(self.plan)

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def _fields(plan: dict) -> tuple:
    """The plan's fields in the order its C struct declares them."""
    return tuple(int(plan[n]) for n in (DIRECT_FIELDS if "wpr" in plan else STAGED_FIELDS))


def _c_plan(plan: dict):
    """The plan as the C int array skyhdr_probe_fwd / _resident take."""
    fields = _fields(plan)
    return (ctypes.c_int * len(fields))(*fields)


def resident_model(threads: int, smem: int) -> int:
    """Blocks of a K10 launch an SM holds by its shared memory (the plan's,
    the static tables and the 1 KB reserved a block), its 2048 threads and
    its 65536 registers at the 128 a thread the kernels keep at most (the
    occupancy API counts the same on the card)."""
    return min(SM_SMEM // (smem + K10_STATIC + 1024), 2048 // threads,
               65536 // (128 * threads), 32)


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def _halvings(n: int, least: int):
    while n >= least:
        yield n
        if n % 2:
            return
        n //= 2


def _direct_plans(p: Probe, h, w, c, f, rblk):
    """The direct plans, most warps a row first. A lane reads VEC channels
    at once (16 bytes; bf16 where C is not a multiple of 64: 8 bytes),
    8 lanes along C, 4 along F of 4 FT channels (FT 16 where F % 64 == 0,
    else 8); K's two taps in shared memory."""
    elem = p.store.itemsize
    vec = 16 // elem if c % (8 * 16 // elem) == 0 else 4
    _require(c % (8 * vec) == 0, f"K10 {p.gather}: C={c} must be a multiple of {8 * vec}")
    _require(f % 32 == 0, f"K10 direct: F={f} must be a multiple of 32")
    fb = 64 if f % 64 == 0 else 32
    ldg = vec * fb + 16
    smem = 2 * (c // vec) * ldg * 4
    _require(smem <= K10_SMEM, f"K10 direct: K's two taps ({smem} bytes) exceed shared memory")
    for wpr in _halvings(max(1, 8 // rblk), 1):
        plan = dict(rows=rblk, wpr=wpr, vec=vec, fb=fb, ldg=ldg, threads=32 * rblk * wpr,
                    smem=smem)
        yield plan, (-(-w // (4 * wpr)) * (f // fb), h // rblk)


def _staged_plan(p: Probe, c, f, g, tw, fb, cc, ks, span) -> dict:
    """The staged plan's fields at these tiles: strides, slots (16-byte
    aligned) and the shared-memory layout, in csrc/probes.cu's order."""
    elem = p.store.itemsize
    ts = 3 if p.dedup else 2 if p.taps == 2 else 1
    nch = c // cc
    cs = p.taps == 9
    summing = p.diag in SUM_MODES
    m = g * tw
    d = ts * cc
    if p.mma:
        ch, ld, ldk = 8, d + 8, d + 8
        tile, k_slot = _up16(m * ld * 2), _up16(fb * ldk * 2)
        threads = m * fb // 32
    else:
        ch = 8 if fb >= 64 else 4
        ld, ldk = m + 4, fb
        tile, k_slot = _up16(d * ld * 4), 0 if summing else _up16(d * fb * 4)
        threads = m // 8 * (fb // ch) * ks
    wn = tw + span + 1 if p.dedup else tw if p.diag not in ("", "nomm") else tw + 1
    nrow = 1 if p.diag in ONE_ROW_MODES else 2
    nslot = 2 * nch if p.diag == "mmhoist" else 9 * nch if cs else 2
    raw = _up16((1 if p.dedup else ts) * g * nrow * wn * cc * elem)
    ywin = _up16(g * wn * cc * 4) if p.dedup else 0
    off_raw = nslot * tile
    off_ywin = off_raw + 2 * raw
    off_k = off_ywin + 2 * ywin
    off_red = off_k + 2 * k_slot
    smem = off_red + (ks - 1) * m * fb * 4
    if cs and (ks - 1) * m * fb * 4 <= (6 * nch - 2) * tile:
        # The split sums fit the nine-tap tile's slots 3 nch + 1 .., idle
        # from a row group's last phase to the next one's.
        off_red, smem = (3 * nch + 1) * tile, off_red
    return dict(g=g, tw=tw, fb=fb, cc=cc, ts=ts, lead=3 * nch if cs else 1, nslot=nslot, wn=wn,
                nrow=nrow, ks=ks, ch=ch, ld=ld, ldk=ldk, threads=threads, smem=smem,
                off_raw=off_raw, off_ywin=off_ywin, off_k=off_k, off_red=off_red,
                raw_slot=raw, ywin_slot=ywin, tile_slot=tile, k_slot=k_slot)


def staged_candidates(p: Probe, w: int, c: int, f: int, rblk: int, mblk: int, span: int):
    """Every staged plan the kernel takes at this shape, widest tile first:
    (tw, fb, cc, ks) of M = g tw tile rows (the f32 tile in 8-row register
    tiles, tw a multiple of 8, M <= 128; the tensor cores' M and F tile
    multiples of 32, a warp's 32 x 32, at most 8 warps), cc channels a
    step (16-byte rows) and ks depth splits of at least 8 rows, within the
    shared memory and 32-256 threads. The F tile is the largest power of
    two up to 128 (tensor cores: 256) dividing F."""
    elem = p.store.itemsize
    summing = p.diag in SUM_MODES
    g = mblk if p.dedup else 1
    _require(p.dedup or mblk == 1, f"K10: mblk={mblk} is for the dedup variant only")
    _require(1 <= g <= K10_MAX_ROWS and rblk % g == 0,
             f"K10 dedup: mblk={mblk} must divide rblk={rblk} and be at most {K10_MAX_ROWS}")
    _require(not summing or c >= f, f"K10 {p.diag}: the sum modes need C >= F, got C={c}, F={f}")
    if p.mma:
        _require(c % 16 == 0 and f % 32 == 0,
                 f"K10 tensor cores: C={c} must be a multiple of 16, F={f} of 32")
        unit, fbs, ccs = 32, [next(q for q in (256, 128, 64, 32) if f % q == 0)], (128, 64, 32, 16)
    else:
        fb0 = next((q for q in (128, 64, 32, 16, 8, 4) if f % q == 0), 0)
        _require(fb0 > 0, f"K10 staged: F={f} must be a multiple of 4")
        unit, fbs, ccs = 8, [fb0], (128, 64, 32, 16, 8)
    ccs = [q for q in ccs if c % q == 0 and q * elem % 16 == 0 and (not summing or q % 8 == 0)]
    _require(bool(ccs), f"K10 staged: C={c} has no chunk of 16-byte rows")
    tw_max = min(-(-w // unit) * unit, 128 // g // unit * unit)
    _require(tw_max >= unit, f"K10 staged: mblk={mblk} leaves no {unit}-column tile")
    for tw in _halvings(tw_max, unit):
        if tw % unit:
            break
        for fb in fbs:
            if p.mma and g * tw * fb // 32 > 256:
                continue
            for cc in ccs:
                for ks in (1,) if summing or p.mma else (1, 2, 4, 8):
                    if cc % ks or cc // ks < 8:
                        continue
                    plan = _staged_plan(p, c, f, g, tw, fb, cc, ks, span)
                    if plan["smem"] <= K10_SMEM and 32 <= plan["threads"] <= 256:
                        yield plan


def _staged_plans(p: Probe, h, w, c, f, rblk, mblk, span, resident):
    """The staged plans `probe_tiling` tries, one a column tile, widest
    first, each the best of that tile's candidates: steps of >= 16
    channels, then 2 blocks and 8 warps on an SM, else 8 warps, else the
    most warps, then cc largest and ks smallest. Tiles whose best leaves
    fewer than 4 warps on an SM come last. (The order is the fastest of
    those swept on the H100: tools/sweep_torch_probes.py, PERF.md.)"""
    by_tw = {}
    for plan in staged_candidates(p, w, c, f, rblk, mblk, span):
        by_tw.setdefault(plan["tw"], []).append(plan)

    def key(e):
        i, plan = e
        n = resident(plan)
        warps = n * plan["threads"] // 32
        tier = 0 if n >= 2 and warps >= 8 else 1 if warps >= 8 else 2
        return plan["cc"] < 16, tier, -warps if tier == 2 else 0, i

    weak = []
    for tw, plans in by_tw.items():
        plan = min(enumerate(plans), key=key)[1]
        grid = (-(-w // tw) * (f // plan["fb"]), h // rblk)
        if resident(plan) * plan["threads"] >= 128:
            yield plan, grid
        else:
            weak.append((plan, grid))
    yield from weak


def probe_tiling(probe: str, b: int, h: int, w: int, c: int, f: int, *, rblk: int = 2,
                 mblk: int = 1, span: int = 0, sms: int = H100_SMS,
                 resident: Callable = None) -> ProbeTiling:
    """The launch plan of K10 instantiation `probe` on x [b,h,w,c] -> F = f:
    of the plans the kernel takes (`_direct_plans`, `_staged_plans`, the
    widest block first), the first whose grid gives each of the `sms` SMs
    a block (one wave), else the one whose first wave holds the most
    threads (the widest of equals).
    `resident(plan)` counts the blocks an SM holds (on the card, the
    occupancy API; by default `resident_model`). `span` is the dedup
    window's (`dedup_span`). Raises ValueError for what the kernel does not
    tile."""
    p = probe_named(probe)
    if resident is None:
        def resident(plan):
            return resident_model(plan["threads"], plan["smem"])
    _require(1 <= rblk <= K10_MAX_ROWS and h % rblk == 0,
             f"K10 {probe}: h={h}, rblk={rblk} do not tile (rblk 1..{K10_MAX_ROWS} dividing h)")
    _require(min(b, h, w, c, f) >= 1, f"K10 {probe}: empty shape")
    if p.gather == "direct":
        _require(mblk == 1, f"K10 {probe}: mblk={mblk} is for the dedup variant only")
        plans = _direct_plans(p, h, w, c, f, rblk)
    else:
        plans = _staged_plans(p, h, w, c, f, rblk, mblk, span, resident)
    best, best_threads = None, 0
    for plan, (gx, gy) in plans:
        n = resident(plan)
        _require(n >= 1, f"K10 {probe}: the plan {plan} leaves no block on an SM")
        t = ProbeTiling(plan, (gx, gy, b), n)
        if t.blocks >= sms:
            return t
        first_wave = min(t.blocks, sms * n) * plan["threads"]
        if first_wave > best_threads:
            best, best_threads = t, first_wave
    _require(best is not None, f"K10 {probe}: no tile fits x {(b, h, w, c)} -> F={f}")
    return best


@functools.lru_cache(maxsize=None)
def k10_launch_tiling(probe: str, b: int, h: int, w: int, c: int, f: int, rblk: int,
                      mblk: int, index: int) -> tuple:
    """(`probe_tiling` on card `index`, its fields as a C int array), once
    per shape; the blocks an SM holds come from the library's occupancy
    count for the instantiation and plan."""
    from skyhdr_torch.ops.kernels.build import library

    lib = library()
    p = probe_named(probe)
    choices = (int(p.store == torch.bfloat16), GATHERS.index(p.gather), p.taps, int(p.dedup),
               int(p.mma), DIAGS.index(p.diag))

    def resident(plan):
        arr = _c_plan(plan)
        n = lib.skyhdr_probe_resident(*choices, h, w, c, f, rblk, arr, len(arr), index)
        if n < 0:
            raise RuntimeError(f"K10 {probe}: the library refused the plan {plan} (CUDA error "
                               f"{-n})")
        return n

    span = dedup_span(h, w) if p.dedup else 0
    t = probe_tiling(probe, b, h, w, c, f, rblk=rblk, mblk=mblk, span=span,
                     sms=_sm_count(index), resident=resident)
    return t, _c_plan(t.plan)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def da_probe_k10(x, kernel, probe: str, *, rblk: int = 2, mblk: int = 1,
                 plan: dict = None) -> torch.Tensor:
    """K10: the k=3 DA forward of instantiation `probe` on the card, one
    launch. x [b,h,w,c] (cast to the probe's storage type), kernel [9c,f]
    (taken as float32; the tensor-core variants round it to bf16 in the
    kernel); returns out [b,h,w,f] float32, no bias. rblk output rows per
    block (h % rblk == 0); mblk rows stacked in M (dedup only). The launch
    plan is `probe_tiling`'s, or `plan` (one of `staged_candidates`, for
    sweeps)."""
    global K10_LAUNCHES
    from skyhdr_torch.ops.kernels.build import check, library

    p = probe_named(probe)
    _check_x(x, kernel, "K10")
    _require(x.is_cuda and kernel.device == x.device,
             "K10 takes CUDA tensors on one device")
    b, h, w, c = x.shape
    f = kernel.shape[-1]
    if plan is None:
        fields = k10_launch_tiling(probe, b, h, w, c, f, rblk, mblk, x.device.index)[1]
    else:
        fields = _c_plan(plan)
    xs = x.to(p.store).contiguous()
    kk = kernel.float().contiguous()
    y0, y1, cx, wy, wx = gather_tables_on(x.device, h, w, 3, 1, True)
    out = torch.empty((b, h, w, f), dtype=torch.float32, device=x.device)
    code = library().skyhdr_probe_fwd(*_ptrs(xs, kk, y0, y1, cx, wy, wx, out),
                                      int(p.store == torch.bfloat16), GATHERS.index(p.gather),
                                      p.taps, int(p.dedup), int(p.mma), DIAGS.index(p.diag),
                                      b, h, w, c, f, rblk, fields, len(fields),
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
