"""The width-aware ops of the port's width-sharded GAN step, one at a time, on
the CPU: gloo rank processes of `tools/make_torch_golden.py dp-rank` (the
"width-ops" job, which imports no JAX) on width rings of 1, 2 and 4, each
running every op of `CASES` on its width shard of seeded inputs inside the
width context (`parallel.spatial.WidthRing`, `ops/width.py`) and its
backward for its block of a seeded cotangent. Each op is held to the same
op of the port on the whole panorama in this process, within 1e-5 of the
largest value (f32):

  * the output: the ranks' blocks put side by side (the VALID conv's of
    uneven widths), or rank 0's where the output is whole on every rank
    (the Dense layers over a flattened map), or the ranks' loss shares
    summed (the losses);
  * the input gradient: the ranks' blocks side by side;
  * every parameter gradient: the ranks' partials summed (the step sums
    them over the ring).

Every `Conv2D` shape class of the GAN step (k7 s1, k3 s2, k4 s2, k4 s1,
k3 s1, the discriminator's VALID k4), InstanceNorm, train-mode BatchNorm,
the two Dense forms, the bilinear resize (the 2-d upsample with >= 8
channels, the one-axis form of the CAMs, x2 and x4), the 2x2 pool, the DA
conv on the halo plan (k=3 and 5) and on the gather plan, the perceptual,
DoG, L1 and LSGAN losses (the last also on the discriminator's VALID
logits, whose shards differ in width), and the degradation (its draws and the JPEG model,
on the shard and gathered). Each planted fault of
`make_torch_golden.WIDTH_OP_FAULTS` makes its op miss the whole panorama's.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
spec_ = importlib.util.spec_from_file_location(
    "make_torch_golden", os.path.join(ROOT, "tools", "make_torch_golden.py"))
G = importlib.util.module_from_spec(spec_)
spec_.loader.exec_module(G)

RANK_TIMEOUT_S = 240
RTOL = 1e-5
WIDTHS = (2, 4)
CASES = [
    {"name": "conv_k7s1", "op": "conv", "k": 7, "s": 1, "shape": [2, 8, 32, 3], "seed": 1},
    {"name": "conv_k3s2", "op": "conv", "k": 3, "s": 2, "shape": [2, 8, 32, 5], "seed": 2},
    {"name": "conv_k4s2", "op": "conv", "k": 4, "s": 2, "shape": [2, 8, 32, 6], "seed": 3},
    {"name": "conv_k4s1", "op": "conv", "k": 4, "s": 1, "shape": [2, 4, 32, 8], "seed": 4},
    {"name": "conv_k3s1", "op": "conv", "k": 3, "s": 1, "shape": [2, 8, 32, 4], "seed": 5},
    {"name": "valid_k4", "op": "conv", "k": 4, "s": 1, "padding": "VALID",
     "shape": [2, 4, 32, 8], "seed": 6},
    {"name": "in", "op": "in", "shape": [2, 8, 32, 6], "seed": 7},
    {"name": "in_fused_config", "op": "in", "fuse": True, "shape": [2, 8, 32, 6], "seed": 8},
    {"name": "bn", "op": "bn", "shape": [2, 8, 32, 6], "seed": 9},
    {"name": "spatial_dense", "op": "spatial_dense", "f": 5, "shape": [2, 2, 16, 8],
     "seed": 10},
    {"name": "map_dense", "op": "map_dense", "shape": [2, 2, 16, 8], "seed": 11},
    {"name": "resize_2d_x2", "op": "resize", "scale": 2, "shape": [2, 4, 16, 8], "seed": 12},
    {"name": "resize_cam_x2", "op": "resize", "scale": 2, "shape": [2, 4, 16, 1], "seed": 13},
    {"name": "resize_cam_x4", "op": "resize", "scale": 4, "shape": [2, 4, 16, 1], "seed": 14},
    {"name": "pool", "op": "pool", "shape": [2, 8, 32, 4], "seed": 15},
    {"name": "da3_halo", "op": "da", "k": 3, "shape": [2, 16, 64, 8], "seed": 16},
    {"name": "da3_gather", "op": "da", "k": 3, "force_gather": True, "shape": [2, 16, 64, 8],
     "seed": 16},
    {"name": "da5_halo", "op": "da", "k": 5, "shape": [2, 16, 64, 4], "seed": 17},
    # 10 samples: the shard's VGG convs run in chunks of 8 (WIDTH_CONV_BATCH).
    {"name": "perceptual", "op": "perceptual", "shape": [10, 16, 32, 3], "seed": 18},
    {"name": "dog", "op": "dog", "shape": [2, 16, 64, 3], "seed": 19},
    {"name": "l1", "op": "l1", "shape": [2, 8, 32, 3], "seed": 20},
    {"name": "lsgan", "op": "lsgan", "shape": [2, 4, 32, 1], "seed": 21},
    # d4's map is 4x16: the VALID logits' shards differ in width.
    {"name": "disc_lsgan", "op": "disc_lsgan", "shape": [1, 32, 128, 6], "seed": 24,
     "scale_w": 0.05},
    {"name": "degrade", "op": "degrade", "shape": [4, 16, 64, 3], "seed": 22},
    # Local widths of 24 and 12: not whole 16-column JPEG blocks, gathered.
    {"name": "degrade_gathered", "op": "degrade", "shape": [4, 16, 48, 3], "seed": 23},
]
FAULT_CASES = [dict(next(c for c in CASES if c["name"] == op), name=f"fault_{fault}",
                    fault=fault) for fault, op in G.WIDTH_OP_FAULTS.items()]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({width: each rank's results}, {case: the whole-panorama op}); the
    whole ops computed while the ranks run."""
    rings = {}
    try:
        for n in (1,) + WIDTHS:
            spec = {"job": "width-ops", "world": n, "width": n, "device": "cpu",
                    "cases": CASES + (FAULT_CASES if n > 1 else [])}
            rings[n] = G.DPRanks(spec, str(tmp_path_factory.mktemp(f"w{n}")))
        whole = {c["name"]: (G._degrade_block(c, None) if c["op"] == "degrade"
                             else G.width_op_whole(c)) for c in CASES}
        return {n: ring.results(RANK_TIMEOUT_S) for n, ring in rings.items()}, whole
    finally:
        for ring in rings.values():
            ring.stop()


def _gap(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        return np.inf
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _gaps(results, whole, name) -> dict:
    """The largest relative gap of each quantity of case `name` on the ring
    (its blocks put together) against the whole panorama's."""
    blocks = [r[name] for r in results]
    if blocks[0].get("kind") == "degrade":
        return {f"out{i}": _gap(np.concatenate([b["out"][i] for b in blocks], axis=2),
                                whole["out"][i]) for i in range(2)}
    kind = blocks[0]["kind"]
    if kind == "sharded":
        out = np.concatenate([b["out"] for b in blocks], axis=2)
    elif kind == "whole":
        out = blocks[0]["out"]
        if not all(np.array_equal(b["out"], out) for b in blocks):
            return {"ranks_disagree": np.inf}
    else:
        out = sum(b["out"] for b in blocks)
    gaps = {"out": _gap(out, whole["out"])}
    if whole["dx"] is not None:
        gaps["dx"] = _gap(np.concatenate([b["dx"] for b in blocks], axis=2), whole["dx"])
    for i, want in enumerate(whole["dparams"]):
        gaps[f"dparam{i}"] = _gap(sum(b["dparams"][i] for b in blocks), want)
    return gaps


@pytest.mark.parametrize("n", (1,) + WIDTHS)
@pytest.mark.parametrize("case", CASES, ids=lambda c: c["name"])
def test_op_on_width_shards_matches_the_whole_panorama(runs, case, n):
    """The op's output and gradients on n width shards against the port's op
    on the whole panorama, within 1e-5 of the largest value (on a ring of
    one each halo is the shard's own opposite edge)."""
    results, whole = runs
    gaps = _gaps(results[n], whole[case["name"]], case["name"])
    assert max(gaps.values()) <= RTOL, gaps


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("case", FAULT_CASES, ids=lambda c: c["name"])
def test_planted_fault_misses_the_whole_panorama(runs, case, n):
    """InstanceNorm over the shard, a halo's gradient dropped, fc1 not
    summed over the ring, the VALID conv without its right halo, the noise
    drawn at the shard's width: each op then misses the whole panorama's."""
    results, whole = runs
    base = G.WIDTH_OP_FAULTS[case["fault"]]
    gaps = _gaps(results[n], whole[base], case["name"])
    assert max(gaps.values()) > 10 * RTOL, gaps


def test_ranks_import_no_jax(runs):
    """The rank processes ran the port alone: no JAX, Flax or `skyhdr`."""
    results, _ = runs
    for ranks in results.values():
        for r in ranks:
            assert not set(r["imported"]) & {"jax", "jaxlib", "flax", "skyhdr"}
            assert "skyhdr_torch" in r["imported"]


def _ring_strip_walk(g_ext, kernel, k, st, tw=16):
    """K2/K7's walk (tests/test_torch_tables.py's emulation) over the pair
    lists `st` on an extended shard: the cotangent g_ext [b, h, we, f] read
    modulo its width we, every extended column's dx formed."""
    b, h, we, _ = g_ext.shape
    rows = st.rows
    c = kernel.shape[0] // (k * k)
    kt = kernel.reshape(k * k, c, -1).transpose(1, 2)
    dx = torch.full((b, h, we, c), float("nan"))
    for s in range(len(st.start) - 1):
        for j0 in range(0, we, tw):
            acc, nxt, r_cur = torch.zeros(b, tw, c), torch.zeros(b, tw, c), -1
            pairs = range(st.start[s], st.start[s + 1])
            for n in [*pairs, None]:
                r = rows if n is None else int(st.pint[n][3])
                while r_cur < r:
                    y = s * rows + r_cur
                    if r_cur >= 0 and y < h:
                        dx[:, y, j0:j0 + tw] = acc[:, :we - j0]
                    acc, nxt, r_cur = nxt, torch.zeros(b, tw, c), r_cur + 1
                if n is None:
                    break
                i, t, cx, _ = (int(v) for v in st.pint[n])
                wx, w0, w1, _ = (float(v) for v in st.pflt[n])
                win = g_ext[:, i, (j0 - cx - 1 + torch.arange(tw + 1)) % we]
                p = ((1 - wx) * win[:, 1:] + wx * win[:, :-1]) @ kt[t]
                acc, nxt = acc + w0 * p, nxt + w1 * p
    return dx


@pytest.mark.parametrize("k", [3, 5])
def test_ring_backward_plain_versions_and_tables(k):
    """In this process, on one shard of 2 cut from the whole panorama: the
    plain versions of the ring K2/K7 (`da_conv_dx_ring_ref`) and K3/K6
    (`da_conv_dk_ring_ref`) equal autograd of the ring forward's plain
    version, and K2/K7's walk over `ring_strip_tables` (the strip tables
    with shifts re-based by the halo, read modulo the extended width) gives
    the plain ring dx, within 1e-5 of the max."""
    from skyhdr_torch.ops.distortion import ring_strip_tables
    from skyhdr_torch.ops.kernels import deform_conv as dc
    from skyhdr_torch.parallel.spatial import ring_da_plan

    b, h, w, c, f = 2, 9, 32, 4, 6
    wl = w // 2
    _, halo = ring_da_plan(h, w, wl, k)
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.normal(size=(b, h, w, c)).astype(np.float32))
    kernel = torch.from_numpy((rng.normal(size=(k * k * c, f)) * 0.2).astype(np.float32))
    bias = torch.zeros(f)
    g = torch.from_numpy(rng.normal(size=(b, h, wl, f)).astype(np.float32))
    xe = x[:, :, [(wl - halo + j) % w for j in range(wl + 2 * halo)]].requires_grad_()
    geom = dict(w=w, halo=halo, kernel_size=k)
    dxe, dk = torch.autograd.grad(dc.da_conv_forward_ring_ref(xe, kernel.requires_grad_(), bias,
                                                              **geom), (xe, kernel), g)
    got_dx = dc.da_conv_dx_ring_ref(g, kernel.detach(), x_shape=tuple(xe.shape), **geom)
    got_dk = dc.da_conv_dk_ring_ref(xe.detach(), g, **geom)
    assert _gap(got_dx.numpy(), dxe.numpy()) <= RTOL
    assert _gap(got_dk.numpy(), dk.numpy()) <= RTOL
    g_ext = torch.nn.functional.pad(g, (0, 0, 0, 2 * halo))
    walk = _ring_strip_walk(g_ext, kernel.detach(), k, ring_strip_tables(h, w, halo, k, 4))
    assert not torch.isnan(walk).any()
    assert _gap(walk.numpy(), got_dx.numpy()) <= RTOL
