"""The port's width-sharded GAN step (`make_parallel_gan_train_step` and
`make_fsdp_gan_train_step` with `shard_width=True`) on the CPU: gloo rank
processes of `tools/make_torch_golden.py dp-rank` (the "width" job, which
imports no JAX) at 16x64 f32, a global batch of 4, on a (1, 2) mesh (2
ranks, each every row and half the columns) and a (2, 2) mesh under FSDP
(4 ranks, each 2 rows and half the columns), both launched at once.

  (a) against `skyhdr`: one step on the stored JAX-degraded global batch
      (each rank its block, through `step.train_on`), held to
      tests/fixtures/torch_golden_width_16x64.npz (`make_torch_golden.
      make_width_golden`: `skyhdr`'s width-sharded GSPMD steps on the
      virtual CPU devices: DA k=3 and plain convs on (1, 2), DA FSDP on
      (2, 2)) at the DP golden's tolerances, and its gradients (recovered
      from the moments) within WIDTH_GRAD_RTOL;
  (b) against the port's single-process step on the same global batch and
      generator seed, through the degradation, at `WIDTH_RTOL` (moments
      included), and so a ring of one process (a (1, 1) mesh with
      `ring_of_one`: the width context, its halos the shard's own opposite
      edge) at `WIDTH_ONE_RTOL`;
  (c) the planted fault of a DA kernel's gradient not summed over the ring
      fails (b) (the ops' faults are tests/test_torch_width_ops.py's);
  (d) every rank ends bit-equal;
  (e) on a width mesh without `shard_width` the batch is sharded over
      `data` alone, as `skyhdr`'s: the ranks of a ring compute the same
      rows and equal the single-process step.
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

RANK_TIMEOUT_S = 300
SPEC = {"job": "width", "device": "cpu", "h": G.H, "w": G.W, "batch": G.WIDTH_BATCH,
        "seed": 0, "fixture": G.WIDTH_FIXTURE}
MESHES = {
    (1, 2): [{"name": "jax_da", "path": "fixture"},
             {"name": "jax_plain", "path": "fixture", "use_da_conv": False},
             {"name": "batch_da", "path": "batch"},
             {"name": "rows_only", "path": "batch", "shard_width": False},
             *({"name": f, "path": "batch", "fault": f} for f in G.WIDTH_FAULTS)],
    (2, 2): [{"name": "jax_fsdp", "path": "fixture", "fsdp": 1 << 20},
             {"name": "batch_fsdp", "path": "batch", "fsdp": 1 << 20}],
    (1, 1): [{"name": "ring_of_one", "path": "batch", "ring_of_one": True}],
}
# The fixture's run of each case against `skyhdr`.
JAX_RUNS = {"jax_da": "da_", "jax_plain": "plain_", "jax_fsdp": "fsdp_"}


@pytest.fixture(scope="module")
def stored():
    with np.load(G.WIDTH_FIXTURE) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({case: each rank's results}, the single-process step at DA through
    the degradation); the reference computed while the ranks run."""
    launches = {}
    try:
        for (data, width), cases in MESHES.items():
            spec = dict(SPEC, world=data * width, data=data, width=width, cases=cases)
            launches[data, width] = G.DPRanks(
                spec, str(tmp_path_factory.mktemp(f"width{data}x{width}")))
        ref = G.width_reference(SPEC, {})
        out = {}
        for mesh, ranks in launches.items():
            results = ranks.results(RANK_TIMEOUT_S)
            for case in MESHES[mesh]:
                out[case["name"]] = [r[case["name"]] for r in results]
            out["imported"] = out.get("imported", []) + [r["imported"] for r in results]
        return out, ref
    finally:
        for ranks in launches.values():
            ranks.stop()


def test_width_fixture_inputs(stored):
    """The fixture was built from the port's seeded weights, on `dp_batch`,
    and each of `skyhdr`'s width-sharded steps equals its single-device
    step (`skyhdr`'s own test holds them at rtol 1e-3)."""
    from skyhdr_torch.utils.transplant import init_gan_vars, tree_digest

    for prefix, _, use_da, _ in G.WIDTH_RUNS:
        gv, sv, dv = init_gan_vars(G.golden_config(use_da_conv=use_da), int(stored["seed"]))
        digest = tree_digest({"gen": gv, "sun": sv, "disc": dv})
        assert abs(digest - float(stored[prefix + "weights_digest"])) <= 1e-9 * abs(digest)
        np.testing.assert_allclose(stored[prefix + "single_gan_metrics"],
                                   stored[prefix + "gan_metrics"], rtol=1e-4, atol=1e-6)
    batch = G.dp_batch(int(stored["seed"]), G.WIDTH_BATCH)
    for k in ("hdr", "elevation"):
        np.testing.assert_array_equal(stored[k], batch[k])


@pytest.mark.parametrize("case", sorted(JAX_RUNS))
def test_width_steps_match_skyhdr(stored, runs, case):
    """(a): the ranks' step on the stored JAX-degraded blocks against
    `skyhdr`'s width-sharded step: metrics, update digests, BatchNorm sums
    at the DP golden's tolerances, and the gradient digests."""
    results, _ = runs
    want = G.width_fixture_run(stored, JAX_RUNS[case])
    got = results[case][0]
    fails, worst = G.compare_dp_steps(want, got, G.DP_RTOL["golden"], kinds=("gan",))
    grad_fails, worst["gan_grads"] = G.compare_grad_digests(want, got)
    assert not fails + grad_fails, (fails + grad_fails, worst)


@pytest.mark.parametrize("case", ["batch_da", "batch_fsdp", "ring_of_one"])
def test_width_steps_match_the_single_process_step(runs, case):
    """(b): from the host batch through the degradation (each rank drawing
    the whole panorama's noise and keeping its block), against the port's
    single-process step on the whole batch with the same generator seed;
    also the width context on a ring of one (`ring_of_one`: one process,
    its halos the shard's own opposite edge)."""
    results, ref = runs
    assert all(r["width_context"] for r in results[case])
    rtol = G.WIDTH_ONE_RTOL if case == "ring_of_one" else G.WIDTH_RTOL
    fails, worst = G.compare_dp_steps(ref, results[case][0], rtol, kinds=("gan",))
    assert not fails, (fails, worst)


@pytest.mark.parametrize("fault", G.WIDTH_FAULTS)
def test_planted_fault_fails_the_comparison(runs, fault):
    """(c): a DA conv's weight gradient left per rank fails (b)."""
    results, ref = runs
    fails, worst = G.compare_dp_steps(ref, results[fault][0], G.WIDTH_RTOL, kinds=("gan",))
    assert fails, worst


def test_ranks_end_bit_equal(runs):
    """(d): after each case's step every rank holds the same bits
    (`replicas_agree`), and the ranks report the same metrics and
    moments."""
    results, _ = runs
    for case in [c for cases in MESHES.values() for c in cases if not c.get("fault")]:
        ranks = results[case["name"]]
        assert all(r["agree"] for r in ranks), case["name"]
        for key in ("gan_metrics", "gan_nu"):
            assert all(np.array_equal(r[key], ranks[0][key]) for r in ranks), case["name"]


def test_width_mesh_without_shard_width_shards_rows(runs):
    """(e): on the (1, 2) mesh without `shard_width` both ranks run the
    whole batch, as `skyhdr`'s step shards it over `data` alone, and equal
    the single-process step."""
    results, ref = runs
    assert not any(r["width_context"] for r in results["rows_only"])
    fails, worst = G.compare_dp_steps(ref, results["rows_only"][0], G.DP_RTOL["float32"],
                                      kinds=("gan",))
    assert not fails, (fails, worst)


def test_ranks_import_no_jax(runs):
    """The rank processes ran the port alone: no JAX, Flax or `skyhdr`."""
    results, _ = runs
    for imported in results["imported"]:
        assert not set(imported) & {"jax", "jaxlib", "flax", "optax", "orbax", "skyhdr"}
        assert "skyhdr_torch" in imported


@pytest.mark.slow
def test_width_fixture_regenerates(stored):
    fresh = G.make_width_golden(0)
    assert sorted(fresh) == sorted(stored)
    for k, v in stored.items():
        if v.dtype.kind in "fc":
            np.testing.assert_allclose(fresh[k], v, rtol=1e-6, atol=1e-9, err_msg=k)
        else:
            np.testing.assert_array_equal(fresh[k], v, err_msg=k)
