"""K10's launch plan on the CPU: `probes.probe_tiling` (pure Python) held to
what the kernels in csrc/probes.cu take (a mirror of `launch_direct` and
`launch_staged`'s checks), to the card's limits (227 KB of shared memory,
1024 threads), to tiles that cover W (ragged last tiles included) and F,
to a grid that gives every SM a block wherever the work allows, and to
refusing exactly what the kernels cannot tile; the staged kernel's step
schedule and rings emulated (every (row, tap, channel) contracted once, no
slot overwritten before it is read); and the direct kernel's butterfly
reduce-scatter emulated lane by lane."""

import numpy as np
import pytest
import torch

from skyhdr_torch.ops.kernels import probes as tp

# The suite runs in several worker processes that share the CPU.
torch.set_num_threads(1)

SMS = tp.H100_SMS
# x [b, h, w, c], F: both probe shapes, then the card tests' shapes
# (tests/test_torch_gpu.py: PROBE_SHAPES and K10_CASES).
SHAPES = [((32, 64, 256, 64), 64), ((32, 16, 64, 128), 128),
          ((2, 8, 32, 64), 64), ((2, 4, 16, 128), 128), ((1, 8, 40, 32), 32),
          ((1, 16, 36, 32), 32), ((1, 16, 38, 64), 64), ((1, 8, 200, 128), 128),
          ((2, 8, 44, 64), 64)]
ROWS = (1, 2, 4, 8, 16)


def _tiling(name, shape, f, rblk):
    b, h, w, c = shape
    p = tp.PROBES[name]
    mblk = rblk if p.dedup else 1
    span = tp.dedup_span(h, w) if p.dedup else 0
    return tp.probe_tiling(name, b, h, w, c, f, rblk=rblk, mblk=mblk, span=span, sms=SMS)


def _kernel_takes(p, h, w, c, f, rblk, plan):
    """launch_direct / launch_staged's checks (csrc/probes.cu), in Python."""
    elem = p.store.itemsize
    if p.gather == "direct":
        return (plan["rows"] == rblk and 1 <= rblk <= tp.K10_MAX_ROWS and h % rblk == 0
                and plan["wpr"] >= 1 and plan["threads"] == 32 * rblk * plan["wpr"] <= 512
                and plan["vec"] in (4, 16 // elem) and c % (8 * plan["vec"]) == 0
                and plan["fb"] in (32, 64) and f % plan["fb"] == 0
                and plan["ldg"] == plan["vec"] * plan["fb"] + 16
                and plan["smem"] == 8 * (c // plan["vec"]) * plan["ldg"] <= tp.K10_SMEM)
    g, tw, fb, cc, ks = plan["g"], plan["tw"], plan["fb"], plan["cc"], plan["ks"]
    m = g * tw
    ok = (1 <= rblk <= tp.K10_MAX_ROWS and h % rblk == 0 and g >= 1 and rblk % g == 0
          and (p.dedup or g == 1) and tw >= 8 and tw % 8 == 0 and f % fb == 0 and c % cc == 0
          and plan["ts"] == (3 if p.dedup else 2 if p.taps == 2 else 1)
          and plan["lead"] >= 1 and plan["nslot"] >= plan["lead"] + 1 and ks >= 1
          and 32 <= plan["threads"] <= 256 and plan["smem"] <= tp.K10_SMEM
          and cc * elem % 16 == 0)
    if p.mma:
        return ok and m % 32 == 0 and fb % 32 == 0 and fb & (fb - 1) == 0 and cc % 16 == 0 \
            and plan["threads"] == m * fb // 32
    return ok and plan["ch"] in (4, 8) and fb % plan["ch"] == 0 and cc % ks == 0 and \
        plan["threads"] == m // 8 * (fb // plan["ch"]) * ks and \
        (p.diag not in tp.SUM_MODES or (c >= f and ks == 1))


def _check_layout(p, c, span, plan):
    """Each region of the staged plan's shared memory holds its slots,
    16-byte aligned, in order, and the strides keep the reads conflict-free."""
    elem = p.store.itemsize
    g, tw, cc, ts = plan["g"], plan["tw"], plan["cc"], plan["ts"]
    m, d = g * tw, ts * cc
    for key in ("off_raw", "off_ywin", "off_k", "off_red", "raw_slot", "ywin_slot",
                "tile_slot", "k_slot"):
        assert plan[key] % 16 == 0, key
    if p.mma:
        assert plan["tile_slot"] >= m * plan["ld"] * 2 and plan["ld"] == d + 8
        assert plan["k_slot"] >= plan["fb"] * plan["ldk"] * 2
        assert (plan["ld"] * 2 // 16) % 2 == 1  # ldmatrix rows an odd number of 16 bytes apart
    else:
        assert plan["tile_slot"] >= d * plan["ld"] * 4 and plan["ld"] == m + 4
        assert (plan["ld"] // 4) % 2 == 1  # 8 builders' float4 rows in distinct banks
        assert p.diag in tp.SUM_MODES or plan["k_slot"] >= d * plan["fb"] * 4
    want_wn = tw + span + 1 if p.dedup else tw if p.diag not in ("", "nomm") else tw + 1
    assert plan["wn"] == want_wn
    assert plan["raw_slot"] >= (1 if p.dedup else ts) * g * plan["nrow"] * plan["wn"] * cc * elem
    assert not p.dedup or plan["ywin_slot"] >= g * plan["wn"] * cc * 4
    assert plan["off_raw"] >= plan["nslot"] * plan["tile_slot"]
    assert plan["off_ywin"] >= plan["off_raw"] + 2 * plan["raw_slot"]
    assert plan["off_k"] >= plan["off_ywin"] + 2 * plan["ywin_slot"]
    red = (plan["ks"] - 1) * m * plan["fb"] * 4
    nch = c // cc
    if p.taps == 9 and plan["off_red"] < plan["off_raw"]:
        # cs: the split sums in the tile slots 3 nch + 1 .. 9 nch - 2
        assert plan["off_red"] == (3 * nch + 1) * plan["tile_slot"]
        assert plan["off_red"] + red <= (9 * nch - 1) * plan["tile_slot"]
        assert plan["smem"] >= plan["off_k"] + 2 * plan["k_slot"]
    else:
        assert plan["off_red"] >= plan["off_k"] + 2 * plan["k_slot"]
        assert plan["smem"] >= plan["off_red"] + red
    if p.diag == "mmhoist":
        assert plan["nslot"] == 2 * nch
    elif p.taps == 9:  # the nine taps' [9C, M] tile, built a kernel row ahead
        assert plan["nslot"] == 9 * nch and plan["lead"] == 3 * nch
    else:
        assert plan["nslot"] == 2 and plan["lead"] == 1


@pytest.mark.parametrize("shape,f", SHAPES, ids=[f"{s}-{f}" for s, f in SHAPES])
@pytest.mark.parametrize("name", sorted(tp.PROBES))
def test_plan_fits_the_card_and_covers_the_output(name, shape, f):
    """At every rblk the shape takes: a plan the kernel takes, within the
    card's shared memory and threads, whose tiles cover W (the last one
    ragged where W is not a multiple) and F, and whose grid gives every
    SM a block wherever some plan's grid does."""
    p = tp.PROBES[name]
    b, h, w, c = shape
    if p.diag in tp.SUM_MODES and c < f:
        pytest.fail("the shapes all have C >= F")
    for rblk in ROWS:
        if h % rblk:
            with pytest.raises(ValueError):
                _tiling(name, shape, f, rblk)
            continue
        t = _tiling(name, shape, f, rblk)
        plan = t.plan
        assert _kernel_takes(p, h, w, c, f, rblk, plan), plan
        assert plan["smem"] + tp.K10_STATIC <= 232448 and plan["threads"] <= 1024
        assert t.resident == tp.resident_model(plan["threads"], plan["smem"]) >= 1
        cols = 4 * plan["wpr"] if p.gather == "direct" else plan["tw"]
        tiles = -(-w // cols)
        assert (tiles - 1) * cols < w <= tiles * cols and f % plan["fb"] == 0
        assert t.grid == (tiles * (f // plan["fb"]), h // rblk, b)
        assert len(t.fields) == len(tp.DIRECT_FIELDS if p.gather == "direct"
                                    else tp.STAGED_FIELDS)
        if p.gather == "direct":
            most = b * (h // rblk) * -(-w // 4) * (f // plan["fb"])  # a warp a block
            assert plan["vec"] == (16 // p.store.itemsize if c % (128 // p.store.itemsize) == 0
                                   else 4)
        else:
            span = tp.dedup_span(h, w) if p.dedup else 0
            _check_layout(p, c, span, plan)
            mblk = rblk if p.dedup else 1
            most = max(b * (h // rblk) * -(-w // q["tw"]) * (f // q["fb"])
                       for q in tp.staged_candidates(p, w, c, f, rblk, mblk, span))
        assert t.blocks >= SMS or most < SMS, (t.blocks, most)


def test_direct_plans_fill_the_card_at_every_rblk():
    """At the default shape every rblk takes 8-warp blocks of 32 outputs
    (16 rows: 16 warps), the grid many waves deep."""
    for name in ("a", "a_bf16"):
        for rblk in ROWS:
            t = _tiling(name, (32, 64, 256, 64), 64, rblk)
            assert t.plan["threads"] == 32 * max(8, rblk) and t.blocks >= 8 * SMS


# (name, x shape, F, rblk, mblk): what the kernels cannot tile.
REFUSED = [
    ("c", (2, 8, 32, 64), 64, 3, 1),          # rblk does not divide h
    ("c", (2, 32, 32, 64), 64, 32, 1),        # more than 16 rows a block
    ("a", (2, 8, 32, 64), 64, 0, 1),          # no rows
    ("a", (2, 8, 32, 16), 32, 2, 1),          # 8 lanes along C need C % 32 (f32)
    ("a_bf16", (2, 8, 32, 48), 32, 2, 1),     # ... and C % 32 with bf16's 8-byte runs
    ("a", (2, 8, 32, 64), 48, 2, 1),          # 4 lanes x 8 or 16 outputs: F % 32
    ("a", (2, 8, 32, 64), 64, 2, 2),          # mblk is dedup's
    ("nomm", (2, 8, 32, 16), 32, 2, 1),       # the sum modes need C >= F
    ("loadonly_bf16", (2, 8, 32, 32), 64, 2, 1),
    ("mma_bf16", (2, 8, 32, 64), 48, 2, 1),   # a warp's 32 x 32: F % 32
    ("mma", (2, 8, 32, 8), 32, 2, 1),         # mma's depth 16: C % 16
    ("dedup_bf16", (2, 8, 32, 64), 64, 4, 3),  # mblk does not divide rblk
    ("c_bf16", (2, 8, 32, 4), 64, 2, 1),      # no 16-byte channel chunk in bf16
    ("c", (2, 8, 32, 64), 6, 2, 1),           # F % 4
    ("nomm", (1, 2, 9, 8), 4, 1, 1),          # no block of 32 threads: 2 x 1 tiles
]


@pytest.mark.parametrize("name,shape,f,rblk,mblk", REFUSED)
def test_plan_refuses_what_the_kernel_cannot_tile(name, shape, f, rblk, mblk):
    b, h, w, c = shape
    with pytest.raises(ValueError):
        tp.probe_tiling(name, b, h, w, c, f, rblk=rblk, mblk=mblk, sms=SMS)


# Edges the kernels do take: 16 rows, 16 stacked rows, bf16 direct at
# C = 32 (8-byte runs), F = 32, widths below one tile.
TAKEN = [("a", (1, 16, 8, 32), 32, 16, 1), ("a_bf16", (1, 8, 40, 32), 32, 8, 1),
         ("dedup_bf16", (1, 16, 38, 64), 64, 16, 16), ("c", (1, 4, 5, 32), 32, 4, 1),
         ("mma_bf16", (1, 4, 5, 16), 32, 1, 1), ("cs", (1, 2, 3, 32), 32, 2, 1),
         ("nomm", (1, 2, 40, 32), 32, 1, 1)]


@pytest.mark.parametrize("name,shape,f,rblk,mblk", TAKEN)
def test_plan_takes_the_edges(name, shape, f, rblk, mblk):
    b, h, w, c = shape
    p = tp.PROBES[name]
    span = tp.dedup_span(h, w) if p.dedup and h > 1 else 0
    t = tp.probe_tiling(name, b, h, w, c, f, rblk=rblk, mblk=mblk, span=span, sms=SMS)
    assert _kernel_takes(p, h, w, c, f, rblk, t.plan)


def _steps(p, plan, c, rblk):
    """The staged kernel's steps, decoded as `step` does: (row group, tap
    group, first channel, first tap, taps)."""
    g, cc, ts = plan["g"], plan["cc"], plan["ts"]
    nch = c // cc
    spg = -(-9 // ts) * nch
    for s in range(rblk // g * spg):
        gi, rem = divmod(s, spg)
        tg, ch = divmod(rem, nch)
        t0 = tg * ts
        yield s, gi, tg, ch * cc, t0, min(ts, 9 - t0)


@pytest.mark.parametrize("name", sorted(n for n, p in tp.PROBES.items() if p.gather == "staged"))
@pytest.mark.parametrize("shape,f", SHAPES[:2] + SHAPES[4:5], ids=["default", "trunk", "c32"])
def test_staged_schedule_contracts_each_tap_once_and_rings_hold(name, shape, f):
    """Emulates the kernel's phases: every (row, tap, channel) is
    contracted exactly once (mmhoist: tap 0's samples, built once a row,
    into all nine); the tile of step s + lead is built into a slot no
    pending product reads, and each ring (raw, window, K) is written in a
    phase where its other half is the one read."""
    p = tp.PROBES[name]
    b, h, w, c = shape
    for rblk in (2, 4):
        t = _tiling(name, shape, f, rblk)
        plan = t.plan
        steps = list(_steps(p, plan, c, rblk))
        nch = c // plan["cc"]

        def slot(s):
            _, gi, _, c0, _, _ = steps[s]
            return (gi & 1) * nch + c0 // plan["cc"] if p.diag == "mmhoist" else s % plan["nslot"]

        seen = np.zeros((rblk, 9, c), np.int64)
        for s, gi, tg, c0, t0, ntap in steps:
            for r in range(plan["g"]):
                seen[gi * plan["g"] + r, t0:t0 + ntap, c0:c0 + plan["cc"]] += 1
        assert (seen == 1).all()
        lead, S = plan["lead"], len(steps)
        written = {}  # slot -> the step whose tile it holds
        for s in range(-(lead + 2), S + 1):
            sb = s + lead
            if 0 <= sb < S and (p.diag != "mmhoist" or steps[sb][2] == 0):
                pending = {slot(q) for q in range(max(s, 0), min(sb, S))}
                assert slot(sb) not in pending, (s, sb)
                written[slot(sb)] = sb
            if 0 <= s < S:
                held = written[slot(s)]
                assert steps[held][1] == steps[s][1] and steps[held][3] == steps[s][3]
                assert p.diag == "mmhoist" or held == s
            if p.taps == 9 and plan["ks"] > 1 and plan["off_red"] < plan["off_raw"] and \
                    0 <= s < S and s % (9 * nch) == 9 * nch - 1:
                # the row group's last phase and the next: the split sums'
                # slots are neither built nor contracted
                red_slots = set(range(3 * nch + 1, 9 * nch - 1))
                busy = {slot(q) for q in (s, s + 1, s + lead, s + lead + 1) if q < S}
                assert not red_slots & busy, (s, busy)
            # rings of two: this phase copies raw(s + lead + 1 [+1]) and K(s + 1)
            # while reading raw(s + lead [+1]) and K(s): other halves.
            y = 1 if p.dedup else 0
            assert (s + lead + 1 + y) % 2 != (s + lead + y) % 2 and (s + 1) % 2 != s % 2


@pytest.mark.parametrize("ft", [8, 16])
def test_direct_reduce_scatter_sums_the_lanes_along_c(ft):
    """The direct kernel's epilogue: 8 lanes along C (cs, lane bits 2-4)
    each hold 4 x FT partial sums acc[m * FT + 4 n + w]; three `halve`
    steps with partners lane ^ (4 << st) leave lane cs the sums of flat
    indices base + e, which it stores as column m = 2 cs0 + cs1 and
    float4s n = cs2 FT / 8 + q."""
    rng = np.random.default_rng(0)
    na = 4 * ft
    acc = rng.normal(size=(8, na))
    want = acc.sum(0)
    cur = acc.copy()
    for st in range(3):
        n = na >> (st + 1)
        nxt = cur.copy()
        for cs in range(8):
            up = (cs >> st) & 1
            mate = cs ^ (1 << st)
            send = cur[mate, :n] if (mate >> st) & 1 else cur[mate, n:2 * n]
            keep = cur[cs, n:2 * n] if up else cur[cs, :n]
            nxt[cs, :n] = keep + send
        cur = nxt
    for cs in range(8):
        m = 2 * (cs & 1) + ((cs >> 1) & 1)
        n0 = ((cs >> 2) & 1) * (ft // 8)
        for q in range(ft // 8):
            for w in range(4):
                flat = m * ft + 4 * (n0 + q) + w
                assert np.isclose(cur[cs, 4 * q + w], want[flat])
