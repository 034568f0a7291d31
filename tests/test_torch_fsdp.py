"""ZeRO-3 sharded training of the port (`skyhdr_torch.parallel.fsdp`) on the
CPU: two gloo ranks, each a process of `tools/make_torch_golden.py dp-rank`
(which imports no JAX), at DA 16x64, a global batch of 4 (2 a rank).

  (a) the plan: `fsdp_plan` equals `skyhdr.parallel.fsdp.fsdp_state_sharding`
      leaf by leaf (which leaves, which Flax dimension) for GAN and sun
      states at 16x64 and 64x256 (from shapes alone), at min_bytes 1 MiB and
      64 KiB, under float32 storage, bf16 moments and bf16 parameters;
  (b) against `skyhdr.parallel.fsdp`: one GAN step and one sun step of
      `make_fsdp_*_train_step` on the stored JAX-degraded global batch, held
      to tests/fixtures/torch_golden_fsdp_16x64.npz (`make_torch_golden.
      make_fsdp_golden`: `skyhdr`'s FSDP steps on two of the 8 virtual CPU
      devices, at both min_bytes) at the train golden's tolerances
      (`DP_RTOL["golden"]`);
  (c) against the port's DP step: two steps from the same replicated state
      and generator seeds, bit-equal after unsharding (every parameter,
      buffer, moment and master), under float32, bf16 moments, bf16
      gradients, bf16 parameters with the float32 master and bf16 compute;
  (d) residency: each rank holds its block of every planned tensor and the
      rest whole, and its at-rest bytes are the plan's;
  (e) planted faults: an unreduced gradient, a summed reduce-scatter and a
      stale gather fail (c); moments left whole fail (d); a plan on Flax
      dimension 0 fails (a).

The ranks run every case in one launch while this process checks the plans;
`DPRanks.results` stops them all and fails after RANK_TIMEOUT_S.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from skyhdr_torch.config import Config, ModelConfig, TrainConfig
from skyhdr_torch.parallel import fsdp
from skyhdr_torch.parallel.mesh import Mesh
from skyhdr_torch.train.engine import empty_gan_state, empty_sun_state

# The suite runs in several worker processes that share the CPU; torch's
# default of one thread per core in each of them oversubscribes it.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
spec_ = importlib.util.spec_from_file_location(
    "make_torch_golden", os.path.join(ROOT, "tools", "make_torch_golden.py"))
G = importlib.util.module_from_spec(spec_)
spec_.loader.exec_module(G)

RANK_TIMEOUT_S = 300
BIG, SMALL = G.FSDP_MIN_BYTES
# The bf16 settings of (c): the sun step under each alone (cheap), the GAN
# step under all three storage knobs and under bf16 compute.
SETTINGS = {"opt": {"knobs": G.KNOB_CONFIGS["opt"], "kinds": ["sun"]},
            "grad": {"knobs": G.KNOB_CONFIGS["grad"], "kinds": ["sun"]},
            "param": {"knobs": G.KNOB_CONFIGS["param"], "kinds": ["sun"]},
            "bf16": {"compute": "bfloat16", "kinds": ["sun"]},
            "all_gan": {"knobs": G.KNOB_CONFIGS["all"], "kinds": ["gan"]},
            "bf16_gan": {"compute": "bfloat16", "kinds": ["gan"]}}
STEADY = {"clean": {"fsdp": BIG}, "clean_small": {"fsdp": SMALL},
          **{n: dict(s, fsdp=SMALL) for n, s in SETTINGS.items()}}
# The faults on the sun step at 1 MiB, where its FC kernels are sharded.
FAULTS = {f: {"fsdp": BIG, "kinds": ["sun"], "fault": f} for f in G.FSDP_FAULTS}
CASES = ([{"name": f"jax_{m}", "path": "fixture", "fsdp": m} for m in G.FSDP_MIN_BYTES]
         + [{"name": n, "path": "batch", "vs_dp": True, **c}
            for n, c in {**STEADY, **FAULTS}.items()])
SPEC = {"world": G.DP_WORLD, "device": "cpu", "h": G.H, "w": G.W, "batch": G.DP_BATCH,
        "seed": 0, "fixture": G.FSDP_FIXTURE, "cases": CASES}


@pytest.fixture(scope="module")
def stored():
    with np.load(G.FSDP_FIXTURE) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module", autouse=True)
def ranks(tmp_path_factory):
    """The ranks, started with the module's first test: the plan tests run
    while they step."""
    with G.DPRanks(SPEC, str(tmp_path_factory.mktemp("fsdp"))) as r:
        yield r


@pytest.fixture(scope="module")
def runs(ranks):
    """Each rank's results by case."""
    return ranks.results(RANK_TIMEOUT_S)


def _case(name):
    return next(c for c in CASES if c["name"] == name)


def _kinds(name):
    return _case(name).get("kinds", ["gan", "sun"])


# ---------------------------------------------------------------------------
# (a) the plan
# ---------------------------------------------------------------------------

KNOBS = {"f32": G.KNOB_CONFIGS["f32"], "opt": G.KNOB_CONFIGS["opt"],
         "param": G.KNOB_CONFIGS["param"]}
SIZES = {"16x64": (16, 64), "64x256": (64, 256)}
_PLANS = {}


def port_config(h, w, knobs):
    opt, grad, param = knobs
    return Config(model=ModelConfig(im_height=h, im_width=w, use_da_conv=True),
                  train=TrainConfig(opt_state_dtype=opt, grad_dtype=grad, param_dtype=param))


def meta_state(kind, h, w, knobs):
    """A port state on the "meta" device: shapes and dtypes, no memory."""
    make = empty_gan_state if kind == "gan" else empty_sun_state
    return make(port_config(h, w, knobs), "meta")


def skyhdr_plans():
    """{(kind, size, knobs, min_bytes): {Flax path: dimension or -1}} of
    `skyhdr`'s `fsdp_state_sharding` over `make_mesh(data=2)` of the
    virtual CPU devices, for `jax.eval_shape` states; the paths as
    `tools/export_jax_checkpoint.py` writes them."""
    if _PLANS:
        return _PLANS
    import sys

    import jax

    from skyhdr.config import Config as JConfig
    from skyhdr.config import ModelConfig as JModel
    from skyhdr.config import TrainConfig as JTrain
    from skyhdr.parallel.fsdp import fsdp_state_sharding
    from skyhdr.parallel.mesh import make_mesh
    from skyhdr.train import engine

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from export_jax_checkpoint import export_state

    mesh = make_mesh(data=G.DP_WORLD)
    for kind in ("gan", "sun"):
        for size, (h, w) in SIZES.items():
            for kn, (opt, grad, param) in KNOBS.items():
                cfg = JConfig(model=JModel(im_height=h, im_width=w, use_da_conv=True),
                              train=JTrain(opt_state_dtype=opt, grad_dtype=grad,
                                           param_dtype=param))
                make = engine.create_gan_state if kind == "gan" else engine.create_sun_state
                abstract = jax.eval_shape(lambda k: make(cfg, k), jax.random.PRNGKey(0))
                for mb in G.FSDP_MIN_BYTES:
                    dims = jax.tree_util.tree_map(
                        lambda s: np.array(list(s.spec).index("data") if "data" in s.spec
                                           else -1),
                        fsdp_state_sharding(abstract, mesh, mb))
                    _, leaves = export_state(kind, 0, dims, cfg)
                    _PLANS[kind, size, kn, mb] = {k: int(v) for k, v in leaves.items()}
    return _PLANS


def _port_plan(kind, size, knobs, min_bytes):
    plan = fsdp.fsdp_plan(meta_state(kind, *SIZES[size], KNOBS[knobs]),
                          Mesh(G.DP_WORLD, 1, 0, "gloo"), min_bytes)
    return {k: -1 if v is None else v.flax for k, v in plan.items()}


def _plan_gaps(kind, size, knobs, min_bytes):
    want = skyhdr_plans()[kind, size, knobs, min_bytes]
    got = _port_plan(kind, size, knobs, min_bytes)
    return sorted(k for k in set(want) | set(got) if want.get(k) != got.get(k)), want


@pytest.mark.parametrize("min_bytes", G.FSDP_MIN_BYTES)
@pytest.mark.parametrize("knobs", sorted(KNOBS))
@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("kind", ["gan", "sun"])
def test_plan_matches_skyhdr(kind, size, knobs, min_bytes):
    """(a): every tensor of the state (parameters, BatchNorm statistics,
    moments, master) is sharded on the Flax dimension `skyhdr`'s plan
    shards, or on none where it replicates the leaf."""
    gaps, want = _plan_gaps(kind, size, knobs, min_bytes)
    assert not gaps, gaps[:10]
    assert any(d >= 0 for d in want.values())


def test_small_min_bytes_shards_every_layout():
    """64 KiB shards conv kernels ("hwio", on their output channels: torch
    dimension 0), Dense kernels ("dense": Flax [in, out], torch [out, in])
    and DA kernels ("same"), which 1 MiB leaves whole."""
    state = meta_state("gan", 16, 64, KNOBS["f32"])
    plan = fsdp.fsdp_plan(state, Mesh(2, 1, 0, "gloo"), SMALL)
    layouts = {layout: [] for layout in ("hwio", "dense", "same")}
    for path, layout, _, _ in fsdp.state_leaves(state):
        if plan[path] is not None:
            layouts[layout].append((path, plan[path]))
    assert {s for _, s in layouts["hwio"]} == {fsdp.Split(3, 0)}
    assert {s for _, s in layouts["dense"]} == {fsdp.Split(1, 0)}
    assert layouts["same"]


def test_plan_on_flax_dimension_0_fails(monkeypatch):
    """(e): a plan that shards the first divisible Flax dimension, not the
    last, differs from `skyhdr`'s."""
    def first(flax_shape, nbytes, n, layout, min_bytes=fsdp.DEFAULT_MIN_BYTES):
        if not flax_shape or nbytes < min_bytes:
            return None
        for d in range(len(flax_shape)):
            if flax_shape[d] >= n and flax_shape[d] % n == 0:
                return fsdp.Split(d, d)
        return None

    monkeypatch.setattr(fsdp, "leaf_split", first)
    gaps, _ = _plan_gaps("sun", "16x64", "f32", BIG)
    assert gaps


def test_at_rest_bytes_at_64x256():
    """The plan at DA 64x256 from shapes alone: the replicated GanState
    holds 6.508 GB and the SunState 9.668 GB; over two ranks at 1 MiB each
    rank holds the blocks of the FC kernels and their moments, about half."""
    mesh = Mesh(2, 1, 0, "gloo")
    for kind, total in (("gan", 6_508_246_344), ("sun", 9_668_062_080)):
        state = meta_state(kind, 64, 256, KNOBS["f32"])
        got = fsdp.plan_bytes(state, fsdp.fsdp_plan(state, mesh), 2)
        assert got["replicated"] == total
        assert 0.5 * total < got["per_rank"] < 0.51 * total


# ---------------------------------------------------------------------------
# (b)-(e) the ranks
# ---------------------------------------------------------------------------

def test_fsdp_fixture_inputs(stored):
    """The fixture was built from the port's seeded weights, on `dp_batch`;
    `skyhdr`'s FSDP steps equal its single-device step."""
    from skyhdr_torch.utils.transplant import init_gan_vars, tree_digest

    gv, sv, dv = init_gan_vars(G.golden_config(), int(stored["seed"]))
    digest = tree_digest({"gen": gv, "sun": sv, "disc": dv})
    assert abs(digest - float(stored["weights_digest"])) <= 1e-9 * digest
    batch = G.dp_batch(int(stored["seed"]))
    for k in ("hdr", "elevation"):
        np.testing.assert_array_equal(stored[k], batch[k])
    for m in G.FSDP_MIN_BYTES:
        for kind in ("gan", "sun"):
            np.testing.assert_allclose(stored[f"single_{kind}_metrics"],
                                       stored[f"mb{m}_{kind}_metrics"], rtol=1e-5)


@pytest.mark.parametrize("min_bytes", G.FSDP_MIN_BYTES)
def test_fsdp_steps_match_skyhdr(stored, runs, min_bytes):
    """(b): the two ranks' GAN and sun steps on the stored JAX-degraded
    rows against `skyhdr`'s FSDP steps at the same min_bytes."""
    prefix = f"mb{min_bytes}_"
    ref = {k[len(prefix):]: v for k, v in stored.items() if k.startswith(prefix)}
    fails, worst = G.compare_dp_steps(ref, runs[0][f"jax_{min_bytes}"], G.DP_RTOL["golden"])
    assert not fails, (fails, worst)


@pytest.mark.parametrize("case", sorted(STEADY))
def test_fsdp_steps_bit_equal_to_dp(runs, case):
    """(c): two FSDP steps and two DP steps from the same state and seeds
    leave every tensor with the same bits, on every rank."""
    for r in runs:
        for kind in _kinds(case):
            assert r[case][f"{kind}_differ"] == [], (kind, r[case][f"{kind}_differ"][:10])


def _expected_residency(case):
    """{path: shape} a rank holds for the case's state: its block (the
    planned dimension moved to the front, halved) of each planned tensor,
    the rest whole; per kind."""
    c = _case(case)
    knobs = c.get("knobs", G.KNOB_CONFIGS["f32"])
    out = {}
    for kind in _kinds(case):
        state = meta_state(kind, G.H, G.W, knobs)
        plan = fsdp.fsdp_plan(state, Mesh(G.DP_WORLD, 1, 0, "gloo"), c["fsdp"])
        want = {}
        for path, _, t, _ in fsdp.state_leaves(state):
            shape = list(t.shape)
            if plan[path] is not None:
                d = plan[path].dim
                shape = [shape[d] // G.DP_WORLD] + shape[:d] + shape[d + 1:]
            want[path] = tuple(shape)
        out[kind] = (want, fsdp.plan_bytes(state, plan, G.DP_WORLD)["per_rank"])
    return out


@pytest.mark.parametrize("case", sorted(STEADY))
def test_ranks_hold_only_their_blocks(runs, case):
    """(d): after the steps each rank holds its block of every planned
    tensor and the rest whole, and its at-rest bytes are the plan's."""
    for kind, (want, per_rank) in _expected_residency(case).items():
        for r in runs:
            assert r[case][f"{kind}_resident"] == want
            assert r[case][f"{kind}_bytes"] == per_rank < r[case][f"{kind}_replicated_bytes"]


@pytest.mark.parametrize("fault", G.FSDP_FAULTS)
def test_planted_fault_fails(runs, fault):
    """(e): an unreduced gradient, a summed reduce-scatter and a stale
    gather move the state off the DP step's bits; moments planned but kept
    whole leave the DP bits alone and fail the residency."""
    res = runs[0][fault]
    (want, per_rank), = _expected_residency(fault).values()
    if fault == "moment_whole":
        assert res["sun_differ"] == []
        assert res["sun_resident"] != want and res["sun_bytes"] > per_rank
    else:
        assert res["sun_differ"], fault
        assert res["sun_resident"] == want


def test_ranks_agree(runs):
    """Every rank's unsharded states are bit-equal after every case, and
    the two ranks report the same metrics on the fixture's rows."""
    for case in CASES:
        assert all(r[case["name"]]["agree"] for r in runs), case["name"]
    for m in G.FSDP_MIN_BYTES:
        for key in ("gan_metrics", "sun_metrics", "gan_nu", "sun_mu", "sun_nu"):
            np.testing.assert_array_equal(runs[0][f"jax_{m}"][key], runs[1][f"jax_{m}"][key])


def test_ranks_import_no_jax(runs):
    """The rank processes ran the port alone: no JAX, Flax or `skyhdr`."""
    for r in runs:
        assert not set(r["imported"]) & {"jax", "jaxlib", "flax", "optax", "orbax", "skyhdr"}
        assert "skyhdr_torch" in r["imported"]


def test_width_sharded_mesh_is_refused():
    """The sun-pretrain step has no width-sharded form, as `skyhdr`'s
    `make_fsdp_sun_train_step` has none: it refuses `shard_width`, and on a
    width mesh it shards the batch over `data` alone (the width-sharded GAN
    step is tests/test_torch_width_step.py's)."""
    import inspect

    from skyhdr_torch.data.degradation import make_banks
    from skyhdr_torch.utils.io import get_exposure_lists, make_synthetic_dorf

    banks = make_banks(make_synthetic_dorf(4, 64), get_exposure_lists()[0], device="cpu")
    cfg = port_config(16, 64, KNOBS["f32"])
    with pytest.raises(TypeError, match="shard_width"):
        fsdp.make_fsdp_sun_train_step(cfg, banks, Mesh(1, 2, 0, "gloo"), shard_width=True)
    assert "shard_width" in inspect.signature(fsdp.make_fsdp_gan_train_step).parameters
    step, _, shard_batch = fsdp.make_fsdp_sun_train_step(cfg, banks, Mesh(1, 2, 1, "gloo"))
    hdr = np.arange(2 * 4 * 8 * 3, dtype=np.float32).reshape(2, 4, 8, 3)
    placed = shard_batch({"hdr": hdr, "elevation": np.zeros(2, np.float32)})
    np.testing.assert_array_equal(placed["hdr"].numpy(), hdr)


@pytest.mark.slow
def test_fsdp_fixture_regenerates(stored):
    fresh = G.make_fsdp_golden(0)
    assert sorted(fresh) == sorted(stored)
    for name in stored:
        if stored[name].dtype.kind in "US":
            np.testing.assert_array_equal(fresh[name], stored[name], err_msg=name)
        else:
            np.testing.assert_allclose(fresh[name], stored[name], rtol=1e-6, atol=1e-9,
                                       err_msg=name)
    assert os.path.getsize(G.FSDP_FIXTURE) < 200 * 1024
