"""The port's generator loss and its gradients on the CPU against
`jax.value_and_grad` of `skyhdr.train.engine.generator_forward` (same
seeded weights, the same JAX-degraded `(ldr, hdr_t, sunpose_gt)` from the
train golden fixture, f32), the two optimizers against optax, the port's
steps against the stored train golden fixture, the steps with their own
degradation, and the float32-only guard.

Tolerances: losses rtol 1e-4; each gradient leaf within 1e-3 of its own
max |g| plus 1e-5 of the tree's max |g| (a conv bias feeding an
InstanceNorm has an exact gradient of zero, and both packages return float
noise there); optimizers rtol 1e-6 (the same formula, the bias correction
computed in float64 here and float32 in optax)."""

import dataclasses
import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from skyhdr.config import Config as JConfig, DataConfig as JDataConfig
from skyhdr.config import ModelConfig as JModelConfig
from skyhdr.models.vgg16 import random_vgg16_weights as j_random_vgg16_weights
from skyhdr.train import engine as jengine
from skyhdr_torch.data.degradation import make_banks
from skyhdr_torch.models.vgg16 import random_vgg16_weights, vgg_constants
from skyhdr_torch.train import engine as tengine
from skyhdr_torch.train.optim import Adam, RMSprop
from skyhdr_torch.utils.io import get_exposure_lists, make_synthetic_dorf
from skyhdr_torch.utils.transplant import export_model_vars, init_gan_vars, tree_digest

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
def stored():
    return np.load(G.TRAIN_FIXTURE)


@pytest.fixture(scope="module")
def banks():
    return make_banks(make_synthetic_dorf(175, 1024), get_exposure_lists()[0], device="cpu")


@pytest.fixture(scope="module")
def jax_loss_and_grads(stored):
    """(total, losses, (gen grads, sun grads)) of `skyhdr`'s generator_forward
    in training mode at the seeded weights."""
    tcfg = G.golden_config()
    cfg = JConfig(model=JModelConfig(**vars(tcfg.model)),
                  data=JDataConfig(batch_size=G.BATCH))
    gv, sv, dv = init_gan_vars(tcfg, 0)
    gen, sun, disc = jengine.build_models(cfg)
    vgg = j_random_vgg16_weights()

    def loss(params):
        gp, sp = params
        total, aux = jengine.generator_forward(
            cfg, gen, sun, disc, {"params": gp, "batch_stats": gv["batch_stats"]},
            {"params": sp}, dv, stored["ldr"], stored["hdr_t"], stored["sunpose_gt"],
            vgg, train=True)
        return total, aux["losses"]

    (total, losses), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        (gv["params"], sv["params"]))
    return (float(total), {k: float(v) for k, v in losses.items()},
            jax.tree_util.tree_map(np.asarray, grads))


def test_generator_loss_and_grads_match(stored, jax_loss_and_grads):
    want_total, want_losses, (want_gen, want_sun) = jax_loss_and_grads
    cfg = G.golden_config()
    state = tengine.create_gan_state(cfg, 0, device="cpu")
    inputs = [torch.from_numpy(np.array(stored[k])) for k in ("ldr", "hdr_t", "sunpose_gt")]
    total, aux = tengine.generator_forward(
        cfg, state.gen, state.sun, state.disc, *inputs,
        vgg_constants(random_vgg16_weights(), "cpu"), train=True)
    assert float(total) == pytest.approx(want_total, rel=1e-4)
    for name, want in want_losses.items():
        assert float(aux["losses"][name]) == pytest.approx(want, rel=1e-4, abs=1e-7), name
    grads = dict(zip(state.opt_gen.params, torch.autograd.grad(total, state.opt_gen.params)))
    for module, want in ((state.gen, want_gen), (state.sun, want_sun)):
        got = dict(G.flat_leaves(export_model_vars(
            module, value_of=grads.__getitem__, collections=("params",))["params"]))
        want = dict(G.flat_leaves(want))
        assert sorted(got) == sorted(want)
        tree_max = max(float(np.abs(v).max()) for v in want.values())
        for k in want:
            tol = 1e-3 * float(np.abs(want[k]).max()) + 1e-5 * tree_max
            err = float(np.abs(got[k] - want[k]).max())
            assert err <= tol, f"{k}: {err} > {tol}"


def test_port_matches_train_golden_fixture(stored):
    gv, sv, dv = init_gan_vars(G.golden_config(), int(stored["seed"]))
    assert tree_digest({"gen": gv, "sun": sv, "disc": dv}) == pytest.approx(
        float(stored["weights_digest"]), rel=1e-9)
    fails, worst = G.compare_train_golden(stored, G.port_train_golden(stored, "cpu"),
                                          metric_rtol=1e-4, update_rtol=1e-2)
    assert not fails, (fails, worst)


def test_steps_degrade_and_thread_the_state(banks):
    """The full steps, degradation drawn from a torch.Generator: finite
    metrics with the JAX package's names, the state updated in place."""
    cfg = G.golden_config()
    hdr, elevation = G.train_batch(0)
    batch = {"hdr": torch.from_numpy(hdr), "elevation": torch.from_numpy(elevation)}
    gen = torch.Generator().manual_seed(0)
    state = tengine.create_gan_state(cfg, 0, device="cpu")
    step = tengine.make_gan_train_step(cfg, banks, random_vgg16_weights())
    totals = []
    for _ in range(2):
        state, metrics = step(state, batch, gen)
        assert sorted(metrics) == ["adv", "b_out", "disc_generated", "disc_real",
                                   "disc_total", "dog", "g_out", "gen_total", "kl",
                                   "l1", "perceptual"]
        assert all(torch.isfinite(v) for v in metrics.values())
        totals.append(float(metrics["gen_total"]))
    assert state.step == 2 and totals[0] != totals[1]
    sun_state = tengine.create_sun_state(cfg, 0, device="cpu")
    sun_state, m = tengine.make_sun_train_step(cfg, banks)(sun_state, batch, gen)
    assert sorted(m) == ["dog", "kl", "sun_total"] and sun_state.step == 1
    assert all(torch.isfinite(v) for v in m.values())


@pytest.mark.parametrize("knob", ["opt_state_dtype", "grad_dtype", "param_dtype"])
def test_low_precision_knobs_build_their_dtypes(banks, knob):
    """Each knob at bfloat16 builds states of its dtypes: parameters in
    param_dtype beside a float32 master holding the seeded draw (the
    parameters its rounding), BatchNorm statistics float32, moments in
    opt_state_dtype; and its train steps build."""
    from skyhdr_torch.utils.transplant import init_model_vars

    cfg = G.golden_config()
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **{knob: "bfloat16"}))
    bf16 = knob == "param_dtype"
    gan = tengine.create_gan_state(cfg, 0, device="cpu")
    sun = tengine.create_sun_state(cfg, 0, device="cpu")
    draws = (*init_gan_vars(cfg, 0), init_model_vars(cfg, 0)[1])
    for state, modules in ((gan, (gan.gen, gan.sun, gan.disc)), (sun, (sun.sun,))):
        assert state.param_dtype == ("bfloat16" if bf16 else "float32")
        for m in modules:
            assert {p.dtype for p in m.parameters()} == {torch.bfloat16 if bf16 else torch.float32}
            assert {b.dtype for b in m.buffers()} <= {torch.float32}
        for opt in state.optimizers().values():
            moments = [t for name in opt.MOMENTS for t in getattr(opt, name)]
            assert {t.dtype for t in moments} == {torch.bfloat16 if knob == "opt_state_dtype"
                                                  else torch.float32}
            assert (opt.master is not None) == bf16
            if bf16:
                assert all(m.dtype == torch.float32 and torch.equal(p, m.to(p.dtype))
                           for p, m in zip(opt.params, opt.master))
    if bf16:  # the master holds the float32 draw itself
        fc1 = gan.opt_gen.moments()["master"][gan.sun.fc1.weight]
        np.testing.assert_array_equal(fc1.numpy().T, draws[1]["params"]["fc1"]["kernel"])
    tengine.make_gan_train_step(cfg, banks, random_vgg16_weights())
    tengine.make_sun_train_step(cfg, banks)


@pytest.mark.parametrize("kind", ["rmsprop", "adam"])
def test_optimizers_match_optax(rng, kind):
    """Three steps from the same parameters and gradients, small gradients
    (where eps matters) included."""
    import optax

    shapes = [(5, 7), (3,)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * 10.0 ** rng.uniform(-6, 1, s)).astype(np.float32)
              for s in shapes] for _ in range(3)]
    tx = (optax.rmsprop(LR, decay=0.9, eps=1e-7) if kind == "rmsprop"
          else optax.adam(LR, b1=0.9, b2=0.999, eps=1e-7))
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    tp = [torch.from_numpy(p.copy()) for p in params]
    opt = (RMSprop if kind == "rmsprop" else Adam)(tp, LR)
    for g in grads:
        updates, opt_state = tx.update([jnp.asarray(x) for x in g], opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.step([torch.from_numpy(x) for x in g])
    for got, want in zip(tp, jp):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-9)
