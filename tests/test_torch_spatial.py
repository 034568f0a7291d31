"""Width-sharded spatial parallelism of the port (`skyhdr_torch.parallel.
spatial`) on the CPU: gloo rank processes of `tools/make_torch_golden.py
dp-rank` (the "spatial" job, which imports no JAX) on a width ring of 4
(data=1, width=4), of 2, and on a 2x2 mesh, each running `ring_conv2d`
(cyclic and zero seams, k = 3 and 5) and `ring_deformable_conv2d` (the halo
plan and `force_gather`, k = 3 and 5, a dilation whose plan is "gather" on
4 shards) on its block of inputs drawn from a numpy seed. The blocks,
put together, are held to `skyhdr.parallel.spatial`'s ops on
`make_mesh(data, width)` of the virtual CPU devices within 1e-5 of the
largest output (`skyhdr`'s own test uses rtol 1e-3; the port needs no more
than 1e-5 here): `ring_conv2d` everywhere, `ring_deformable_conv2d` at k = 3
on 4 shards in the tier-1 run and everywhere under `-m slow` (each of
`skyhdr`'s shard_map DA convs compiles for 40-140 s on this CPU); the
tier-1 run holds every DA case to `skyhdr`'s DA conv of the whole panorama. `ring_da_plan` is held to `skyhdr`'s over a grid, the
world-size-1 ring (the halo is the shard's own opposite edge) runs in this
process, and `make_mesh(data=2, width=2)` places ranks and rows as
`skyhdr`'s mesh does. On the CPU the DA conv runs its plain version (the
gather form on the extended shard); the card's run is `chip_smoke.py`'s
spatial phase.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from skyhdr_torch.ops.distortion import (deformable_conv2d, gather_tables, ring_window_tables,
                                         signed_shifts)
from skyhdr_torch.parallel import spatial
from skyhdr_torch.parallel.mesh import Mesh, batch_sharding

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
spec_ = importlib.util.spec_from_file_location(
    "make_torch_golden", os.path.join(ROOT, "tools", "make_torch_golden.py"))
G = importlib.util.module_from_spec(spec_)
spec_.loader.exec_module(G)

RANK_TIMEOUT_S = 120
RTOL = 1e-5
DA_SHAPE = [2, 16, 64, 8]
CASES = [
    {"name": "conv3_cyclic", "op": "conv", "padding": "cyclic", "k": 3, "f": 5,
     "shape": [2, 8, 64, 3], "seed": 1},
    {"name": "conv3_zeros", "op": "conv", "padding": "zeros", "k": 3, "f": 4,
     "shape": [2, 8, 64, 3], "seed": 2},
    {"name": "conv5_cyclic", "op": "conv", "padding": "cyclic", "k": 5, "f": 4,
     "shape": [2, 8, 64, 3], "seed": 3},
    {"name": "da3", "op": "da", "k": 3, "f": 4, "shape": DA_SHAPE, "seed": 4},
    {"name": "da3_gather", "op": "da", "k": 3, "f": 4, "shape": DA_SHAPE, "seed": 4,
     "force_gather": True},
    {"name": "da5", "op": "da", "k": 5, "f": 4, "shape": DA_SHAPE, "seed": 5},
    {"name": "da5_gather", "op": "da", "k": 5, "f": 4, "shape": DA_SHAPE, "seed": 5,
     "force_gather": True},
    {"name": "da3_d16", "op": "da", "k": 3, "dilation": 16, "f": 4, "shape": DA_SHAPE,
     "seed": 6},
]
MESHES = {"w4": (1, 4), "w2": (1, 2), "d2w2": (2, 2)}


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    """Every mesh's ranks, started with the module's first test."""
    started = {}
    try:
        for name, (data, width) in MESHES.items():
            spec = {"job": "spatial", "world": data * width, "data": data, "width": width,
                    "device": "cpu", "cases": CASES}
            started[name] = G.DPRanks(spec, str(tmp_path_factory.mktemp(name)))
        yield started
    finally:
        for r in started.values():
            r.stop()


@pytest.fixture(scope="module")
def runs(ranks):
    """{mesh: each rank's results}."""
    return {name: r.results(RANK_TIMEOUT_S) for name, r in ranks.items()}


def _jax_op(case, data, width, whole=False):
    """`skyhdr.parallel.spatial`'s op of a case on make_mesh(data, width)
    of the virtual CPU devices, or with `whole` `skyhdr.ops.distortion.
    deformable_conv2d` on the whole panorama: the whole output as numpy."""
    import jax.numpy as jnp

    from skyhdr.ops.distortion import deformable_conv2d as jdeformable_conv2d
    from skyhdr.parallel import spatial as jspatial
    from skyhdr.parallel.mesh import make_mesh

    mesh = make_mesh(data=data, width=width)
    x, kernel, bias = (jnp.asarray(a) for a in G.spatial_inputs(case))
    geom = dict(kernel_size=case["k"], dilation_rate=case.get("dilation", 1))
    if case["op"] == "conv":
        out = jspatial.ring_conv2d(x, kernel, bias, mesh=mesh, padding=case["padding"])
    elif whole:
        out = jdeformable_conv2d(x, kernel, bias, **geom)
    else:
        out = jspatial.ring_deformable_conv2d(x, kernel, bias, mesh=mesh,
                                              force_gather=case.get("force_gather", False),
                                              **geom)
    return np.asarray(out)


def _assembled(results, name):
    """The ranks' blocks of case `name` put together: data rows over the
    batch, width shards over the width."""
    blocks = {tuple(r["coords"]): r[name]["out"] for r in results}
    data = 1 + max(d for d, _ in blocks)
    width = 1 + max(w for _, w in blocks)
    return np.concatenate([np.concatenate([blocks[d, w] for w in range(width)], axis=2)
                           for d in range(data)], axis=0)


def _gap(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _check(runs, mesh, case, whole=False):
    got = _assembled(runs[mesh], case["name"])
    want = _jax_op(case, *MESHES[mesh], whole=whole)
    assert got.shape == want.shape
    assert _gap(got, want) <= RTOL, _gap(got, want)
    if case["op"] == "da":
        b, h, w, c = case["shape"]
        plan = spatial.ring_da_plan(h, w, w // MESHES[mesh][1], case["k"],
                                    case.get("dilation", 1))
        for r in runs[mesh]:
            assert (r[case["name"]]["mode"], r[case["name"]]["halo"]) == plan
            assert r[case["name"]]["launches"] == {"K1": 0, "K5": 0}


CONV = [c for c in CASES if c["op"] == "conv"]
DA = [c for c in CASES if c["op"] == "da"]
# `skyhdr`'s shard_map DA conv takes 40-55 s to compile on this CPU at
# k = 3 and 110-140 s at k = 5, per mesh and plan: the tier-1 run holds one
# of them (k = 3, the halo plan, 4 shards) to it and every DA case to
# `skyhdr`'s `deformable_conv2d` on the whole panorama (which `skyhdr`'s
# ring ops equal, tests/test_parallel.py); `-m slow` holds every case.
RING_TIER1 = [("w4", "da3")]


@pytest.mark.parametrize("case", CONV, ids=lambda c: c["name"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_ring_conv_matches_skyhdr(runs, mesh, case):
    """`ring_conv2d`'s blocks equal `skyhdr`'s `ring_conv2d` within 1e-5 of
    its largest value."""
    _check(runs, mesh, case)


@pytest.mark.parametrize("case", DA, ids=lambda c: c["name"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_ring_da_matches_the_whole_panorama(runs, mesh, case):
    """`ring_deformable_conv2d`'s blocks equal `skyhdr`'s DA conv of the
    whole panorama within 1e-5 of its largest value; each rank ran the plan
    `ring_da_plan` gives and, on the CPU, no kernel."""
    _check(runs, mesh, case, whole=True)


@pytest.mark.parametrize("mesh,name", RING_TIER1)
def test_ring_da_matches_skyhdr(runs, mesh, name):
    """`ring_deformable_conv2d`'s blocks equal `skyhdr`'s
    `ring_deformable_conv2d` on the same mesh within 1e-5."""
    _check(runs, mesh, next(c for c in DA if c["name"] == name))


@pytest.mark.slow
@pytest.mark.parametrize("case", DA, ids=lambda c: c["name"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_ring_da_matches_skyhdr_everywhere(runs, mesh, case):
    """Every DA case on every mesh against `skyhdr`'s ring op (~15 min of
    JAX compiles)."""
    _check(runs, mesh, case)


def test_dilated_plan_gathers_on_four_shards(runs):
    """The dilation-16 case takes the halo plan on 2 shards (halo 17 of 32
    columns) and the all-gather on 4 (17 of 16)."""
    assert runs["w2"][0]["da3_d16"]["mode"] == "halo"
    assert runs["w4"][0]["da3_d16"]["mode"] == "gather"
    assert runs["w4"][0]["da3_d16"]["halo"] == 17


GRID = [(h, w, wl, k, d) for h, w in ((8, 64), (16, 64), (32, 128), (64, 256))
        for wl in (2, 8, 16, 32) for k in (3, 5) for d in (1, 2, 16)] + [(8, 64, 2, 3, 16)]


def test_ring_da_plan_matches_skyhdr():
    """The plan equals `skyhdr`'s over (h, w, w_local, k, dilation), the
    gather case of tests/test_parallel.py among them."""
    from skyhdr.parallel.spatial import ring_da_plan

    for h, w, wl, k, d in GRID:
        assert spatial.ring_da_plan(h, w, wl, k, d) == ring_da_plan(h, w, wl, k, d), (h, w,
                                                                                     wl, k, d)
    assert spatial.ring_da_plan(8, 64, 2, dilation_rate=16)[0] == "gather"


@pytest.mark.parametrize("hw,wl,k", [((16, 64), 16, 3), ((16, 64), 16, 5), ((64, 256), 64, 3),
                                     ((64, 256), 32, 5), ((32, 128), 8, 3)])
def test_ring_window_tables_read_the_panoramas_samples(hw, wl, k):
    """K1/K5's reads over `ring_window_tables` on an extended shard: for
    every kept column j of every shard, row and tap, the window column
    j + base + d and its x1 neighbour lie inside the extended shard
    (no wrap) and are the full panorama's columns (j_global + cx0) mod w
    and the next, as `gather_tables` has them."""
    h, w = hw
    _, halo = spatial.ring_da_plan(h, w, wl, k)
    t = ring_window_tables(h, w, halo, k)
    cx0 = gather_tables(h, w, k).cx0
    col = np.repeat(t.base, t.taps, axis=1) + t.d  # [h, k2]: extended column of j = 0
    j = np.arange(wl)[:, None, None]
    for r in range(w // wl):
        ext = j + col[None]  # [wl, h, k2]
        assert ext.min() >= 0 and ext.max() + 1 < wl + 2 * halo
        glob = (r * wl - halo + ext) % w
        np.testing.assert_array_equal(glob, (r * wl + j + cx0[None]) % w)


def test_ring_window_tables_refuse_a_narrow_halo():
    with pytest.raises(ValueError, match="halo"):
        ring_window_tables(16, 64, 2, 3)


def test_ring_plain_form_is_the_whole_panoramas():
    """The plain form on extended shards (`deformable_conv2d(..., ring=)`)
    gives the whole panorama's gather form bit for bit."""
    x, kernel, bias = (torch.from_numpy(a) for a in G.spatial_inputs(CASES[3]))
    want = deformable_conv2d(x, kernel, bias)
    w, wl = 64, 16
    _, halo = spatial.ring_da_plan(16, w, wl)
    blocks = [deformable_conv2d(x[:, :, [(r * wl - halo + c) % w for c in range(wl + 2 * halo)]],
                                kernel, bias, ring=(w, halo)) for r in range(w // wl)]
    assert torch.equal(torch.cat(blocks, dim=2), want)
    np.testing.assert_array_equal(signed_shifts(np.array([0, 1, 63, 32]), 64), [0, 1, -1, -32])


@pytest.mark.parametrize("case", [CASES[0], CASES[1], CASES[3], CASES[5], CASES[7]],
                         ids=lambda c: c["name"])
def test_world_size_one_ring(case):
    """A ring of one process (no process group): the halo is the shard's own
    opposite edge; the conv equals `skyhdr`'s `ring_conv2d` on a 1x1 mesh,
    the DA conv `skyhdr`'s DA conv."""
    mesh = Mesh(1, 1, 0, "gloo")
    x, kernel, bias = (torch.from_numpy(a) for a in G.spatial_inputs(case))
    if case["op"] == "conv":
        got = spatial.ring_conv2d(x, kernel, bias, mesh=mesh, padding=case["padding"])
    else:
        got = spatial.ring_deformable_conv2d(x, kernel, bias, mesh=mesh, kernel_size=case["k"],
                                             dilation_rate=case.get("dilation", 1))
    want = _jax_op(case, 1, 1, whole=True)
    assert _gap(got.numpy(), want) <= RTOL


def test_a_gradient_through_the_ring_raises():
    """The ring ops have a gradient now (the width-sharded train step's
    backward): on a ring of one process (the halo is the shard's own
    opposite edge, its gradient added back there) the gradients of x, the
    kernel and the bias equal those of the whole-panorama op (`F.conv2d`
    on the cyclically padded panorama; the port's DA conv), within 1e-5 of
    the largest; the multi-rank gradients are tests/test_torch_width_ops.py's."""
    import torch.nn.functional as F

    from skyhdr_torch.ops.kernels.deform_conv import da_conv

    mesh = Mesh(1, 1, 0, "gloo")
    for case in (CASES[0], CASES[3]):
        x, kernel, bias = (torch.from_numpy(a).requires_grad_() for a in
                           G.spatial_inputs(case))
        g = torch.from_numpy(np.random.default_rng(7).normal(
            size=(*case["shape"][:3], case["f"])).astype(np.float32))
        if case["op"] == "conv":
            out = spatial.ring_conv2d(x, kernel, bias, mesh=mesh)
            p = (case["k"] - 1) // 2
            wrap = F.pad(torch.cat([x[:, :, -p:], x, x[:, :, :p]], dim=2), (0, 0, 0, 0, p, p))
            want = F.conv2d(wrap.permute(0, 3, 1, 2), kernel.permute(3, 2, 0, 1),
                            bias).permute(0, 2, 3, 1)
        else:
            out = spatial.ring_deformable_conv2d(x, kernel, bias, mesh=mesh)
            want = da_conv(x, kernel, bias)
        got = torch.autograd.grad(out, (x, kernel, bias), g)
        ref = torch.autograd.grad(want, (x, kernel, bias), g)
        for a, b in zip(got, ref):
            assert _gap(a.numpy(), b.numpy()) <= RTOL


def test_mesh_places_ranks_and_rows_as_skyhdr():
    """make_mesh(data=2, width=2): rank r sits at divmod(r, 2), as
    `skyhdr.parallel.mesh.make_mesh` places device r; and
    `batch_sharding(shard_width=True)` gives each rank the block of rows
    and columns that `skyhdr`'s batch sharding gives that device."""
    import jax

    from skyhdr.parallel.mesh import batch_sharding as jbatch_sharding
    from skyhdr.parallel.mesh import make_mesh

    jmesh = make_mesh(data=2, width=2)
    x = np.arange(4 * 2 * 8 * 3, dtype=np.float32).reshape(4, 2, 8, 3)
    placed = jax.device_put(x, jbatch_sharding(jmesh, shard_width=True))
    blocks = {s.device.id: np.asarray(s.data) for s in placed.addressable_shards}
    for rank in range(4):
        mesh = Mesh(2, 2, rank, "gloo")
        assert jmesh.devices[mesh.data_index, mesh.width_index].id == rank
        np.testing.assert_array_equal(batch_sharding(mesh, shard_width=True)(x), blocks[rank])
        assert [mesh.width_peer(s) for s in (-1, 1)] == [2 * (rank // 2) + (rank + 1) % 2] * 2


def test_ranks_import_no_jax(runs):
    """The rank processes ran the port alone: no JAX, Flax or `skyhdr`."""
    for results in runs.values():
        for r in results:
            assert not set(r["imported"]) & {"jax", "jaxlib", "flax", "skyhdr"}
            assert "skyhdr_torch" in r["imported"]
