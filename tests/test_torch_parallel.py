"""Data-parallel training of the port (`skyhdr_torch.parallel`) on the CPU:
two gloo ranks, each a process of `tools/make_torch_golden.py dp-rank`
(which imports no JAX), joined through a file under the test's temporary
directory, at DA 16x64 f32, a global batch of 4 (2 a rank).

  (a) against `skyhdr.parallel.dp`: one GAN step and one sun step of
      `make_parallel_*_train_step` on the stored JAX-degraded global batch
      (each rank its rows, through `step.train_on`), held to
      tests/fixtures/torch_golden_dp_16x64.npz (`make_torch_golden.
      make_dp_golden`: `skyhdr`'s GSPMD steps on two of the 8 virtual CPU
      devices) at the train golden's tolerances;
  (b) against the port's single-process step on the same global batch and
      generator seed, through the degradation (C3, C4), at the tolerances
      of `make_torch_golden.DP_RTOL`, which include the optimizer moments;
  (c) each planted fault of `DP_FAULTS` fails (b);
  (d) every rank ends bit-equal (an all-gather of a digest of every
      parameter, buffer and moment);
  (e) bf16 moments, bf16 gradients, bf16 parameters and bf16 compute run
      through the DP step and equal the single-process step under the same
      setting.

The ranks run every case in one launch, while this process runs the
single-process references; `DPRanks.results` stops them all and fails
after RANK_TIMEOUT_S, so a hung rank fails fast.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from skyhdr_torch.data.degradation import degrade_batch, make_banks
from skyhdr_torch.parallel import batch_sharding, vector_sharding
from skyhdr_torch.parallel.mesh import Mesh
from skyhdr_torch.utils.io import get_exposure_lists, make_synthetic_dorf

# The suite runs in several worker processes that share the CPU; torch's
# default of one thread per core in each of them oversubscribes it.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
spec_ = importlib.util.spec_from_file_location(
    "make_torch_golden", os.path.join(ROOT, "tools", "make_torch_golden.py"))
G = importlib.util.module_from_spec(spec_)
spec_.loader.exec_module(G)

# The ranks' whole run (12 cases) takes ~45 s alone on this CPU.
RANK_TIMEOUT_S = 300
SETTINGS = {"opt": {"knobs": G.KNOB_CONFIGS["opt"]}, "grad": {"knobs": G.KNOB_CONFIGS["grad"]},
            "param": {"knobs": G.KNOB_CONFIGS["param"]}, "bf16": {"compute": "bfloat16"}}
# The fault of a gradient reduced after its cast needs bf16 gradients.
FAULT_SETTING = {"reduce_after_cast": "grad"}
CASES = ([{"name": "jax", "path": "fixture"}, {"name": "clean", "path": "batch"}]
         + [{"name": n, "path": "batch", **s} for n, s in SETTINGS.items()]
         + [{"name": f, "path": "batch", "fault": f, **SETTINGS.get(FAULT_SETTING.get(f), {})}
            for f in G.DP_FAULTS])
SPEC = {"world": G.DP_WORLD, "device": "cpu", "h": G.H, "w": G.W, "batch": G.DP_BATCH,
        "seed": 0, "fixture": G.DP_FIXTURE, "cases": CASES}


@pytest.fixture(scope="module")
def stored():
    with np.load(G.DP_FIXTURE) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(each rank's results by case, the single-process references by
    setting): the references computed while the ranks run."""
    trees = G._dp_trees(SPEC)
    with G.DPRanks(SPEC, str(tmp_path_factory.mktemp("dp"))) as ranks:
        refs = {name: G.dp_reference(SPEC, case, trees)
                for name, case in [("clean", {}), *SETTINGS.items()]}
        return ranks.results(RANK_TIMEOUT_S), refs


def _case(name):
    return next(c for c in CASES if c["name"] == name)


def test_dp_fixture_inputs(stored):
    """The fixture was built from the port's seeded weights, on `dp_batch`,
    and `skyhdr`'s data-parallel step equals its single-device step."""
    from skyhdr_torch.utils.transplant import init_gan_vars, tree_digest

    gv, sv, dv = init_gan_vars(G.golden_config(), int(stored["seed"]))
    digest = tree_digest({"gen": gv, "sun": sv, "disc": dv})
    assert abs(digest - float(stored["weights_digest"])) <= 1e-9 * digest
    batch = G.dp_batch(int(stored["seed"]))
    for k in ("hdr", "elevation"):
        np.testing.assert_array_equal(stored[k], batch[k])
    assert stored["hdr_t"].shape[0] == G.DP_BATCH == G.DP_WORLD * 2
    for kind in ("gan", "sun"):
        np.testing.assert_allclose(stored[f"single_{kind}_metrics"], stored[f"{kind}_metrics"],
                                   rtol=1e-5)


def test_dp_steps_match_skyhdr(stored, runs):
    """(a): the two ranks' GAN and sun steps on the stored JAX-degraded
    rows against `skyhdr`'s GSPMD steps."""
    results, _ = runs
    fails, worst = G.compare_dp_steps(stored, results[0]["jax"], G.DP_RTOL["golden"])
    assert not fails, (fails, worst)


def test_dp_steps_match_the_single_process_step(runs):
    """(b): from the host batch through the degradation, against the port's
    single-process step on the whole batch with the same generator seed."""
    results, refs = runs
    fails, worst = G.compare_dp_steps(refs["clean"], results[0]["clean"], G.DP_RTOL["float32"])
    assert not fails, (fails, worst)


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_storage_knobs_and_bf16_compute_through_dp(runs, setting):
    """(e): bf16 moments, bf16 gradients, bf16 parameters (a float32
    master) and bf16 compute, each against the single-process step under
    the same setting, at its `dp_rtol` class."""
    results, refs = runs
    fails, worst = G.compare_dp_steps(refs[setting], results[0][setting],
                                      G.dp_rtol(_case(setting)))
    assert not fails, (fails, worst)


@pytest.mark.parametrize("fault", G.DP_FAULTS)
def test_planted_fault_fails_the_comparison(runs, fault):
    """(c): per-rank BatchNorm statistics (C1), a per-rank maximum (C2),
    per-rank draws (C3), a local JPEG ramp (C4), gradients reduced after
    the bf16 cast, gradients summed instead of averaged: each fails (b) at
    its setting's tolerances."""
    results, refs = runs
    case = _case(fault)
    setting = FAULT_SETTING.get(fault, "clean")
    fails, worst = G.compare_dp_steps(refs[setting], results[0][fault], G.dp_rtol(case))
    assert fails, worst


def test_ranks_end_bit_equal(runs):
    """(d): after each case's steps every rank holds the same bits
    (`replicas_agree`, an all-gather of `state_digest`), and the two ranks
    report the same moments and metrics."""
    results, _ = runs
    for case in CASES:
        if case.get("fault") == "batchnorm_per_rank":
            continue  # per-rank statistics leave per-rank running buffers
        name = case["name"]
        assert all(r[name]["agree"] for r in results), name
        for key in ("gan_metrics", "sun_metrics", "gan_nu", "sun_mu", "sun_nu"):
            np.testing.assert_array_equal(results[0][name][key], results[1][name][key])


def test_ranks_import_no_jax(runs):
    """The rank processes ran the port alone: no JAX, Flax or `skyhdr`."""
    results, _ = runs
    for r in results:
        assert not set(r["imported"]) & {"jax", "jaxlib", "flax", "optax", "orbax", "skyhdr"}
        assert "skyhdr_torch" in r["imported"]


def test_per_rank_batchnorm_leaves_ranks_apart(runs):
    """`replicas_agree` sees a difference: with per-rank statistics the
    BatchNorm running buffers differ between the ranks."""
    results, _ = runs
    assert not any(r["batchnorm_per_rank"]["agree"] for r in results)


def test_a_failing_rank_fails_the_run(tmp_path):
    """A rank that raises stops the run with its log, and the other rank is
    stopped too."""
    spec = dict(SPEC, cases=[{"name": "bad", "path": "batch", "fault": "no_such_fault"}])
    with pytest.raises(RuntimeError, match="no_such_fault"):
        G.run_dp_ranks(spec, str(tmp_path), RANK_TIMEOUT_S)


def test_batch_placement():
    """A rank's rows of a host batch and of its elevations; a batch that
    does not split evenly is refused."""
    x = np.arange(4 * 2 * 3 * 3, dtype=np.float32).reshape(4, 2, 3, 3)
    for rank in range(2):
        mesh = Mesh(data=2, width=1, rank=rank, backend="gloo")
        np.testing.assert_array_equal(batch_sharding(mesh)(x), x[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(vector_sharding(mesh)(np.arange(4)),
                                      np.arange(4)[2 * rank:2 * rank + 2])
    with pytest.raises(ValueError):
        batch_sharding(Mesh(2, 1, 0, "gloo"))(x[:3])


def test_sharded_degradation_is_the_whole_batchs():
    """C3 and C4 in one process: each shard's degradation, drawn from the
    same seed, equals its rows of the whole batch's, sample for sample; the
    shards' own ramps would not."""
    banks = make_banks(make_synthetic_dorf(175, 1024), get_exposure_lists()[0], device="cpu")
    hdr = torch.from_numpy(G.dp_batch(3)["hdr"])
    whole = degrade_batch(torch.Generator().manual_seed(9), hdr, banks)
    for index in range(2):
        rows = slice(2 * index, 2 * index + 2)
        part = degrade_batch(torch.Generator().manual_seed(9), hdr[rows], banks, shard=(index, 2))
        for a, b in zip(part, whole):
            assert torch.equal(a, b[rows])
    local = degrade_batch(torch.Generator().manual_seed(9), hdr[:2], banks)
    assert not torch.equal(local[1], whole[1][:2])


@pytest.mark.slow
def test_dp_fixture_regenerates(stored):
    fresh = G.make_dp_golden(0)
    assert sorted(fresh) == sorted(stored)
    for name in stored:
        if stored[name].dtype.kind in "US":
            np.testing.assert_array_equal(fresh[name], stored[name], err_msg=name)
        else:
            np.testing.assert_allclose(fresh[name], stored[name], rtol=1e-6, atol=1e-9,
                                       err_msg=name)
    assert os.path.getsize(G.DP_FIXTURE) < 200 * 1024
