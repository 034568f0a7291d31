"""The `da_kernel_size=5` configuration of the port end to end on the CPU:
the serving forward and one GAN step at 16x64 b2 against `skyhdr`'s, from
the same seeded weights (the trunk's 12 convs are 5x5 DA convs, on the plain
versions of K5, K6 and K7 here), and the two k=5 golden fixtures
regenerating. Tolerances are the k=3 slice's (`tests/test_torch_slice.py`,
`tests/test_torch_train.py`)."""

import os

import numpy as np
import pytest
import torch

from skyhdr_torch.data.degradation import make_banks
from skyhdr_torch.models.vgg16 import random_vgg16_weights
from skyhdr_torch.train.engine import build_models, make_gan_train_step, make_inference_fn
from skyhdr_torch.utils.io import get_exposure_lists, make_synthetic_dorf
from skyhdr_torch.utils.transplant import (export_model_vars, init_gan_vars,
                                           init_model_vars, load_model_vars)
# The golden tool (G) and the k=3 step's checks.
from test_torch_train import (LR, G, _abs_g, _check_close, _check_grads,
                              _check_updates, _inputs, _params)

# The suite runs in several worker processes that share the CPU; torch's
# default of one thread per core in each of them oversubscribes it.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_serving():
    return G.make_golden(0, da_kernel_size=5)


@pytest.fixture(scope="module")
def jax_train():
    return G.make_train_golden(0, full=True, da_kernel_size=5)


def test_da5_serving_fixture_regenerates(jax_serving):
    stored = np.load(G.DA5_FIXTURE)
    assert sorted(jax_serving) == sorted(stored.files)
    for name in stored.files:
        np.testing.assert_allclose(jax_serving[name], stored[name], rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    assert os.path.getsize(G.DA5_FIXTURE) < 100 * 1024


def test_da5_inference_matches_skyhdr(jax_serving):
    """The port's k=5 model (12 5x5 DA convs in the trunk) with the same
    seeded weights and input as `skyhdr`'s."""
    cfg = G.golden_config(5)
    gv, sv = init_model_vars(cfg, int(jax_serving["seed"]))
    assert gv["params"]["res0"]["conv1"]["kernel"].shape == (25 * 128, 128)
    gen, sun = build_models(cfg, "cpu")
    load_model_vars(gen, gv)
    load_model_vars(sun, sv)
    out = make_inference_fn(cfg)(gen, sun, torch.from_numpy(jax_serving["input"]))
    bins = jax_serving["sunpose_pred"].reshape(2, -1).argmax(-1)
    assert np.array_equal(out["sunpose_pred"].numpy().reshape(2, -1).argmax(-1), bins)
    for name in ("y_final_lin", "sunpose_pred", "alpha"):
        np.testing.assert_allclose(out[name].numpy(), jax_serving[name], rtol=1e-3,
                                   atol=1e-3, err_msg=name)


def test_da5_train_fixture_regenerates(jax_train):
    stored = np.load(G.DA5_TRAIN_FIXTURE)
    fresh = {k: v for k, v in jax_train.items() if k != "trees"}
    assert sorted(fresh) == sorted(stored.files)
    for name in stored.files:
        if stored[name].dtype.kind in "US":
            np.testing.assert_array_equal(fresh[name], stored[name], err_msg=name)
        else:
            np.testing.assert_allclose(fresh[name], stored[name], rtol=1e-6,
                                       atol=1e-9, err_msg=name)
    assert os.path.getsize(G.DA5_TRAIN_FIXTURE) < 100 * 1024


def test_da5_gan_step_matches_skyhdr(jax_train):
    """One k=5 GAN step from the same seeded weights on JAX's degraded
    pair: metrics, gradients (from RMSprop's moments), updates and BatchNorm
    statistics, as `tests/test_torch_train.py` holds the k=3 step; and the
    stored fixture's digests as `chip_smoke.py` checks them."""
    cfg = G.golden_config(5)
    gv, sv, dv = init_gan_vars(cfg, 0)
    banks = make_banks(make_synthetic_dorf(175, 1024), get_exposure_lists()[0], device="cpu")
    state = G.harness_gan_state(cfg, 0, "cpu")
    state, metrics = make_gan_train_step(cfg, banks, random_vgg16_weights()).train_on(
        state, *_inputs(jax_train))
    for name, want in zip(jax_train["gan_metric_names"], jax_train["gan_metrics"]):
        assert float(metrics[name]) == pytest.approx(want, rel=1e-4, abs=1e-6), name
    trees = jax_train["trees"]
    nu_gen, nu_disc = state.opt_gen.moments()["nu"], state.opt_disc.moments()["nu"]
    port_g = {"gen": _params(state.gen, nu_gen.__getitem__),
              "sun": _params(state.sun, nu_gen.__getitem__),
              "disc": _params(state.disc, nu_disc.__getitem__)}
    jax_g = {"gen": trees["nu_gen"][0], "sun": trees["nu_gen"][1], "disc": trees["nu_disc"]}
    _check_grads(_abs_g(port_g, 10.0), _abs_g(jax_g, 10.0), "|g|")
    _check_updates({"gen": _params(state.gen), "sun": _params(state.sun),
                    "disc": _params(state.disc)}, trees["params"],
                   {"gen": gv["params"], "sun": sv["params"], "disc": dv["params"]},
                   _abs_g(jax_g, 10.0), 3.17 * LR, "params")
    _check_close({n: export_model_vars(m, collections=("batch_stats",))["batch_stats"]
                  for n, m in (("gen", state.gen), ("disc", state.disc))},
                 trees["stats"], 1e-4, "batch_stats")
    stored = np.load(G.DA5_TRAIN_FIXTURE)
    fails, _ = G.compare_train_golden(stored, G.port_train_golden(stored, "cpu",
                                                                  da_kernel_size=5),
                                      1e-4, 1e-2)
    assert not fails, fails
