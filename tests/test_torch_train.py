"""The port's GAN train step and sun-pretrain step on the CPU against
`skyhdr`'s, at 16x64 with the DA conv, b2, from the same seeded weights
(the harness's `init_gan_vars`, `make_torch_golden.harness_gan_state`).
The JAX side runs once per module (`tools/make_torch_golden.
make_train_golden`, one jitted GAN step and one sun step on JAX's own
degraded pair); the port's steps take that pair through `step.train_on`,
so that the step is held apart from the draws
(`tests/test_torch_jax_random.py` holds those).

Tolerances, and why:
  - metrics: rtol 1e-4 (the same f32 graph summed in another order);
  - gradients, read back from the optimizer moments (RMSprop's nu = 0.1 g^2
    and Adam's mu = 0.1 g after one step from zero): within 1e-3 of the
    leaf's max |g| plus 1e-5 of the tree's max |g|;
  - parameters, as a fraction of each leaf's update: RMSprop's first step
    maps g to -lr g / sqrt(0.1 g^2 + 1e-7), about -3.16 lr sign(g) for
    |g| >> 1e-3 but with a slope of up to 3162 lr where g is small, so a
    gradient that agrees to 1e-6 can still move a small-g element's update
    by a sizeable part of lr. Per leaf: the summed |update error| within 1e-2
    of the summed |update|, and the largest within half the largest update.
    A leaf whose exact gradient is zero (a conv bias feeding an
    InstanceNorm) carries float noise in both packages, and the optimizer
    turns noise into updates of either sign; such a leaf (max |g| at most
    1e-5 of the tree's) is held to the optimizer's bound on |update| alone;
  - BatchNorm statistics: within 1e-4 of the leaf's max."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from skyhdr_torch.data.degradation import make_banks
from skyhdr_torch.models.vgg16 import random_vgg16_weights
from skyhdr_torch.train.engine import make_gan_train_step, make_sun_train_step
from skyhdr_torch.utils.io import get_exposure_lists, make_synthetic_dorf
from skyhdr_torch.utils.transplant import export_model_vars, init_gan_vars

# The suite runs in several worker processes that share the CPU; torch's
# default of one thread per core in each of them oversubscribes it.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LR = 1e-4


def _golden_module():
    spec = importlib.util.spec_from_file_location(
        "make_torch_golden", os.path.join(ROOT, "tools", "make_torch_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


G = _golden_module()


@pytest.fixture(scope="module")
def jax_run():
    """One GAN step and one sun step of `skyhdr`, with the whole trees."""
    return G.make_train_golden(0, full=True)


@pytest.fixture(scope="module")
def banks():
    return make_banks(make_synthetic_dorf(175, 1024), get_exposure_lists()[0], device="cpu")


def _inputs(run):
    return [torch.from_numpy(np.array(run[k])) for k in ("hdr_t", "ldr", "sunpose_gt")]


def _params(module, value_of=None):
    return export_model_vars(module, value_of=value_of, collections=("params",))["params"]


def _leaves(tree):
    return dict(G.flat_leaves(tree))


def _check_grads(port_g, jax_g, what):
    """Gradients (or any signed/unsigned per-element values) per leaf."""
    P, J = _leaves(port_g), _leaves(jax_g)
    assert sorted(P) == sorted(J)
    tree_max = max(float(np.abs(v).max()) for v in J.values())
    for k in J:
        tol = 1e-3 * float(np.abs(J[k]).max()) + 1e-5 * tree_max
        err = float(np.abs(P[k] - J[k]).max())
        assert err <= tol, f"{what} {k}: {err} > {tol}"


def _check_updates(port_new, jax_new, old, gmax_tree, bound, what):
    P, J, O, Gm = (_leaves(t) for t in (port_new, jax_new, old, gmax_tree))
    assert sorted(P) == sorted(J)
    tree_gmax = max(float(v.max()) for v in Gm.values())
    for k in J:
        dp, dj = P[k] - O[k], J[k] - O[k]
        if float(Gm[k].max()) <= 1e-5 * tree_gmax:
            assert float(np.abs(dp).max()) <= bound, f"{what} {k}: noise leaf moved too far"
            continue
        err = np.abs(dp - dj)
        assert err.sum() <= 1e-2 * np.abs(dj).sum(), f"{what} {k}: summed error {err.sum()}"
        assert err.max() <= 0.5 * np.abs(dj).max(), f"{what} {k}: max error {err.max()}"


def _check_close(port_t, jax_t, rtol, what):
    P, J = _leaves(port_t), _leaves(jax_t)
    assert sorted(P) == sorted(J)
    for k in J:
        tol = rtol * float(np.abs(J[k]).max()) + 1e-6
        assert float(np.abs(P[k] - J[k]).max()) <= tol, f"{what} {k}"


def _abs_g(nu_tree, scale):
    """|g| from a second moment nu = (1 - b2) g^2 after one step."""
    import jax

    return jax.tree_util.tree_map(lambda v: np.sqrt(scale * np.asarray(v, np.float64)), nu_tree)


def test_train_golden_fixture_regenerates(jax_run):
    stored = np.load(G.TRAIN_FIXTURE)
    fresh = {k: v for k, v in jax_run.items() if k != "trees"}
    assert sorted(fresh) == sorted(stored.files)
    for name in stored.files:
        if stored[name].dtype.kind in "US":
            np.testing.assert_array_equal(fresh[name], stored[name], err_msg=name)
        else:
            np.testing.assert_allclose(fresh[name], stored[name], rtol=1e-6,
                                       atol=1e-9, err_msg=name)
    assert os.path.getsize(G.TRAIN_FIXTURE) < 200 * 1024


def test_gan_step_matches_skyhdr(jax_run, banks):
    cfg = G.golden_config()
    gv, sv, dv = init_gan_vars(cfg, 0)
    state = G.harness_gan_state(cfg, 0, "cpu")
    step = make_gan_train_step(cfg, banks, random_vgg16_weights())
    state, metrics = step.train_on(state, *_inputs(jax_run))
    assert state.step == 1
    for name, want in zip(jax_run["gan_metric_names"], jax_run["gan_metrics"]):
        assert float(metrics[name]) == pytest.approx(want, rel=1e-4, abs=1e-6), name
    trees = jax_run["trees"]
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


def test_sun_step_matches_skyhdr(jax_run, banks):
    cfg = G.golden_config()
    _, sv, _ = init_gan_vars(cfg, 0)
    state = G.harness_sun_state(cfg, 0, "cpu")
    state, metrics = make_sun_train_step(cfg, banks).train_on(state, *_inputs(jax_run))
    for name, want in zip(jax_run["sun_metric_names"], jax_run["sun_metrics"]):
        assert float(metrics[name]) == pytest.approx(want, rel=1e-4, abs=1e-6), name
    trees = jax_run["trees"]
    mom = state.opt.moments()
    _check_grads(_params(state.sun, mom["mu"].__getitem__), trees["sun_mu"], "mu")
    _check_grads(_abs_g(_params(state.sun, mom["nu"].__getitem__), 1000.0),
                 _abs_g(trees["sun_nu"], 1000.0), "|g|")
    # Adam's first step moves an element by lr * g / (|g| + 1e-7): at most lr.
    _check_updates(_params(state.sun), trees["sun_params"], sv["params"],
                   _abs_g(trees["sun_nu"], 1000.0), 1.01 * LR, "params")
