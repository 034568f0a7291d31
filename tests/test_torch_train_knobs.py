"""The three storage knobs of `skyhdr` (`TrainConfig.opt_state_dtype`,
`grad_dtype`, `param_dtype`) held to `skyhdr` on the CPU.

The optimizers: the port's RMSprop and Adam (`skyhdr_torch.train.optim`)
against `skyhdr.train.engine._rmsprop` / `_adam`, run eagerly on seeded
numpy trees over 5 steps, under each of the 8 combinations of the knobs.
The moments (in their stored dtype) and Adam's count agree bit for bit,
every dtype exactly, and the bfloat16 parameters are their master rounded.
The float32 parameters and masters agree within `OPT_ULPS` ulps of the
larger of the value and 4 lr (measured: 2 for RMSprop, 20 for Adam).
XLA:CPU computes rsqrt and sqrt by its own approximations (`jax.lax.rsqrt`
differs from the correctly rounded value on 14% of float32 inputs here,
`jnp.sqrt` on 0.6%), so an update differs by an ulp now and then, and the
sum that takes it may round the other way. Adam's bias correction
1 - 0.999^count runs inside optax's jitted `tree_bias_correction`, whose
fused pow is a few ulps off (0.999^3: 1/(1 - pow) is 333.669 there, 333.676
correctly rounded, 2e-5 apart once the subtraction cancels), and the
update carries that. The bfloat16 parameters are within one bfloat16 ulp
of `skyhdr`'s.

The steps: the knob golden (`make_torch_golden.make_train_golden_knobs`,
tests/fixtures/torch_golden_train_knobs_16x64.npz), `skyhdr`'s resumed GAN
and sun steps at 16x64 DA b2 f32 compute under each configuration, against
the port's from the same states (`compare_knobs_golden`: its tolerances
`KNOB_STEP_RTOL` and `KNOB_MOMENT_RTOL` are 4 times the port's own gap on
the float32 control, the resume golden's states). Five planted faults, each failing a named test
(`FAULTS`); the SUN -> GAN hand-off into bfloat16 parameters; a `skyhdr`
state exported by `tools/export_jax_checkpoint.py` and resumed.
"""

import importlib.util
import dataclasses
import itertools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from skyhdr.train import engine as jengine
from skyhdr_torch.train import engine, optim
from skyhdr_torch.train.convert import state_from_export
from skyhdr_torch.utils.flax_export import read_export, unflatten, write_export

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "make_torch_golden", os.path.join(ROOT, "tools", "make_torch_golden.py"))
G = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(G)

KNOBS = list(itertools.product(("float32", "bfloat16"), repeat=3))
SHAPES = {"a": (3, 5), "b": (7,), "c": (2, 3, 4)}
LR, STEPS = 1e-3, 5
# Float32 parameters and masters: ulps of max(|value|, 4 lr), over 5 steps.
OPT_ULPS = {"rmsprop": 2 * STEPS, "adam": 32}


def _tree_grads(seed: int):
    """[STEPS] gradient trees: N(0, 1) times a per-leaf, per-step scale
    10^U(-4, 1), so that g^2 spans bfloat16's rounding at every size."""
    rng = np.random.default_rng(seed)
    return [{k: (rng.standard_normal(s) * 10.0 ** rng.uniform(-4, 1)).astype(np.float32)
             for k, s in SHAPES.items()} for _ in range(STEPS)]


def _bits(x):
    """A tensor or array as comparable numpy bits (bfloat16 as its float32
    upcast, which is exact)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _moment_nodes(opt_state):
    """(moment node, master or None) of a `skyhdr` optimizer state."""
    master = None
    if isinstance(opt_state, jengine.MasterParamsState):
        opt_state, master = opt_state.inner, opt_state.master
    while not hasattr(opt_state, "nu"):
        opt_state = opt_state[0]
    return opt_state, master


def _run_pair(kind, opt_dtype, grad_dtype, param_dtype, seed=0, port_fault=None):
    """5 steps of `skyhdr`'s and of the port's optimizer from the same
    trees: (skyhdr's stored params, moment node, master; the port's
    optimizer)."""
    rng = np.random.default_rng(100 + seed)
    p32 = {k: (rng.standard_normal(s) * 0.1).astype(np.float32) for k, s in SHAPES.items()}
    tx = (jengine._rmsprop if kind == "rmsprop" else jengine._adam)(LR, opt_dtype, param_dtype)
    jp32 = jax.tree_util.tree_map(jnp.asarray, p32)
    jstate = tx.init(jp32)
    stored = jengine._store_params(jp32, param_dtype)
    pdt = optim.storage_dtype(param_dtype)
    params = [torch.from_numpy(p32[k]).to(pdt) for k in SHAPES]
    cls = optim.RMSprop if kind == "rmsprop" else optim.Adam
    opt = cls(params, LR, opt_state_dtype=opt_dtype, param_dtype=param_dtype)
    if opt.master is not None:
        for m, k in zip(opt.master, SHAPES):
            m.copy_(torch.from_numpy(p32[k]))
        opt.sync_params()
    for grads in _tree_grads(seed):
        # A gradient for a bfloat16 leaf arrives rounded (the cast's VJP).
        jg = {k: jnp.asarray(v).astype(stored[k].dtype) for k, v in grads.items()}
        if grad_dtype == "bfloat16":
            jg = jengine._cast_floating(jg, jnp.bfloat16)
        updates, jstate = tx.update(jg, jstate, stored)
        stored = optax.apply_updates(stored, updates)
        tg = [torch.from_numpy(grads[k]).to(pdt) for k in SHAPES]
        if grad_dtype == "bfloat16":
            tg = [g.to(torch.bfloat16) for g in tg]
        (port_fault or cls.step)(opt, tg)
    node, master = _moment_nodes(jstate)
    return stored, node, master, opt


def _ulps(got, want, dtype):
    """Per element, |got - want| in ulps of `dtype` at max(|want|, 4 lr)."""
    got, want = _bits(got).astype(np.float64), _bits(want).astype(np.float64)
    scale = np.maximum(np.abs(want), 4 * LR).astype(np.float32)
    ulp = np.spacing(scale) if dtype == "float32" else np.spacing(scale) * 2.0 ** 16
    return np.abs(got - want) / ulp


def _mismatches(stored, node, master, opt):
    """[what differs beyond the module docstring's rules]."""
    out = []
    ulps = OPT_ULPS["adam" if isinstance(opt, optim.Adam) else "rmsprop"]

    def dtype_of(j, t):
        jd, td = jnp.asarray(j).dtype.name, str(t.dtype).replace("torch.", "")
        if jd != td:
            out.append(f"dtype {jd} vs {td}")
        return jd == td

    def exact(name, j, t):
        if dtype_of(j, t) and not np.array_equal(_bits(j), _bits(t)):
            n = int((_bits(j) != _bits(t)).sum())
            out.append(f"{name}: {n} of {t.numel()} elements differ")

    def close(name, j, t, ulps):
        if dtype_of(j, t):
            gap = _ulps(t, j, jnp.asarray(j).dtype.name).max()
            if gap > ulps:
                out.append(f"{name}: {gap:.1f} ulps")

    for i, k in enumerate(SHAPES):
        for name in opt.MOMENTS:
            exact(f"{name} {k}", getattr(node, name)[k], getattr(opt, name)[i])
        if (master is None) != (opt.master is None):
            out.append("master presence")
        elif master is not None:
            close(f"master {k}", master[k], opt.master[i], ulps)
            if not torch.equal(opt.params[i], opt.master[i].to(opt.params[i].dtype)):
                out.append(f"param {k}: not its master rounded")
        close(f"param {k}", stored[k], opt.params[i],
              1 if opt.params[i].dtype == torch.bfloat16 else ulps)
    if "count" in node._fields and int(node.count) != opt.count:
        out.append(f"count {int(node.count)} vs {opt.count}")
    return out


@pytest.mark.parametrize("opt_dtype, grad_dtype, param_dtype", KNOBS)
@pytest.mark.parametrize("kind", ["rmsprop", "adam"])
def test_optimizer_matches_skyhdr(kind, opt_dtype, grad_dtype, param_dtype):
    assert _mismatches(*_run_pair(kind, opt_dtype, grad_dtype, param_dtype)) == []


def _with_moments(opt_state, values):
    """`opt_state` with its moment node's fields replaced by `values`, kept
    in their own dtypes (as a restore hands them over)."""
    if hasattr(opt_state, "nu"):
        return opt_state._replace(**values)
    nodes = [_with_moments(node, values) if isinstance(node, tuple) else node
             for node in opt_state]
    return type(opt_state)(*nodes) if hasattr(opt_state, "_fields") else tuple(nodes)


@pytest.mark.parametrize("saved, run", [("float32", "bfloat16"), ("bfloat16", "float32")])
@pytest.mark.parametrize("kind", ["rmsprop", "adam"])
def test_moments_of_another_dtype_resume_as_skyhdr(kind, saved, run):
    """A checkpoint's moments in another dtype than the run's
    opt_state_dtype keep their values (a bfloat16 moment upcast exactly, a
    float32 one kept float32 until the step rounds it), and the next step
    matches `skyhdr`'s optimizer of the run's dtype handed the same values,
    as its restore hands the saved dtype over. (Eager optax would round
    0.9 m of a bfloat16 m in bfloat16 under a float32 run; the jitted step
    computes it in float32, as the port does.)"""
    rng = np.random.default_rng(7)
    p32 = {k: (rng.standard_normal(s) * 0.1).astype(np.float32) for k, s in SHAPES.items()}
    names = ("nu",) if kind == "rmsprop" else ("mu", "nu")
    drawn = {n: {k: (np.abs(rng.standard_normal(s)) * 1e-3).astype(np.float32)
                 for k, s in SHAPES.items()} for n in names}
    held = {n: {k: np.asarray(jnp.asarray(v).astype(saved).astype(jnp.float32))
                for k, v in tree.items()} for n, tree in drawn.items()}
    tx = (jengine._rmsprop if kind == "rmsprop" else jengine._adam)(LR, run)
    jp = jax.tree_util.tree_map(jnp.asarray, p32)
    values = {n: {k: jnp.asarray(v) for k, v in tree.items()} for n, tree in held.items()}
    if kind == "adam":
        values["count"] = jnp.asarray(3, jnp.int32)
    jstate = _with_moments(tx.init(jp), values)
    grads = _tree_grads(7)[0]
    updates, jstate = tx.update({k: jnp.asarray(v) for k, v in grads.items()}, jstate, jp)
    stored = optax.apply_updates(jp, updates)
    params = [torch.from_numpy(p32[k].copy()) for k in SHAPES]
    opt = (optim.RMSprop if kind == "rmsprop" else optim.Adam)(params, LR, opt_state_dtype=run)
    state = {n: [torch.from_numpy(held[n][k].copy()).to(getattr(torch, saved)) for k in SHAPES]
             for n in names}
    opt.load_moments({**state, "count": 3} if kind == "adam" else state)
    assert {t.dtype for n in names for t in getattr(opt, n)} == {torch.float32}
    opt.step([torch.from_numpy(grads[k]) for k in SHAPES])
    assert {t.dtype for n in names for t in getattr(opt, n)} == {getattr(torch, run)}
    assert _mismatches(stored, _moment_nodes(jstate)[0], None, opt) == []


@pytest.mark.parametrize("knobs", [KNOBS[0], KNOBS[-1], ("bfloat16", "bfloat16", "float32")])
@pytest.mark.parametrize("kind", ["rmsprop", "adam"])
def test_chunked_step_is_the_same_bits(kind, knobs, monkeypatch):
    """A leaf stepped in stretches of `CHUNK` elements (here 5, across the
    leaves' ends) gives the bits of the whole leaf at once."""
    whole = _run_pair(kind, *knobs)[3]
    monkeypatch.setattr(optim, "CHUNK", 5)
    chunked = _run_pair(kind, *knobs)[3]
    for name in ("params", *whole.MOMENTS) + (("master",) if whole.master else ()):
        for a, b in zip(getattr(whole, name), getattr(chunked, name)):
            assert a.dtype == b.dtype and torch.equal(a, b), name


# --- the planted faults ----------------------------------------------------

def _upcast_before_square(opt, grads):
    """Fault 1: the optimizer upcasts a bfloat16 gradient before g^2."""
    type(opt).step(opt, [g.float() for g in grads])


def _update_from_rounded_moments(monkeypatch):
    """Fault 2: the update computed from the moments rounded for storage."""
    moment = optim._Optimizer._moment
    monkeypatch.setattr(optim._Optimizer, "_moment",
                        lambda *a: moment(*a).to(torch.bfloat16).float())


def _no_master(opt):
    """Fault 3: no master; the bfloat16 parameters updated in place."""
    opt.master = None


def _optimizer_fault(fault, kind, knobs, monkeypatch):
    """The optimizer-level comparison's mismatches under `fault`, with
    `skyhdr` run under `knobs` (opt, grad, param)."""
    if fault == "upcast_before_square":
        return _mismatches(*_run_pair(kind, *knobs, port_fault=_upcast_before_square))
    if fault == "update_from_rounded_moments":
        _update_from_rounded_moments(monkeypatch)
        return _mismatches(*_run_pair(kind, *knobs))
    if fault == "no_master":
        def step(opt, grads):
            _no_master(opt)
            type(opt).step(opt, grads)
        return _mismatches(*_run_pair(kind, *knobs, port_fault=step))
    # The knob ignored: the port built with it at float32.
    i = {"opt": 0, "grad": 1, "param": 2}[fault.split("_")[0]]
    stored, node, master, _ = _run_pair(kind, *knobs)
    port_knobs = list(knobs)
    port_knobs[i] = "float32"
    return _mismatches(stored, node, master, _run_pair(kind, *port_knobs)[3])


# fault -> (configuration, where it shows: "golden" fails the knob golden
# at the step level, "optimizer" only the optimizer-level comparison).
FAULTS = {
    "upcast_before_square": ("grad", "optimizer"),
    "update_from_rounded_moments": ("opt", "optimizer"),
    "no_master": ("param", "golden"),
    "stale_handoff_master": ("param", "golden"),
    "opt_ignored": ("opt", "golden"),
    "grad_ignored": ("grad", "optimizer"),
    "param_ignored": ("param", "golden"),
    "all_ignored": ("all", "golden"),
}


@pytest.mark.parametrize("kind", ["rmsprop", "adam"])
@pytest.mark.parametrize("fault", [f for f in FAULTS if f not in ("stale_handoff_master",
                                                                  "all_ignored")])
def test_optimizer_comparison_sees_a_fault(fault, kind, monkeypatch):
    config = FAULTS[fault][0]
    assert _optimizer_fault(fault, kind, G.KNOB_CONFIGS[config], monkeypatch)


# --- the knob golden ---------------------------------------------------------

@pytest.fixture(scope="module")
def stored():
    with np.load(G.KNOBS_FIXTURE) as f:
        return dict(f)


def _golden(stored, config, **kw):
    port = G.port_knob_steps(config, "cpu", **kw)
    return G.compare_knobs_golden(stored, port, config)


@pytest.mark.parametrize("config", list(G.KNOB_CONFIGS))
def test_knobs_golden(stored, config):
    fails, worst = _golden(stored, config)
    assert not fails, (fails[:10], json.dumps(worst))


def test_knobs_fixture_is_small(stored):
    assert int(stored["seed"]) == 0
    assert G.export_digest(G.resume_export(0)) == pytest.approx(float(stored["export_digest"]),
                                                                rel=1e-12)
    assert os.path.getsize(G.KNOBS_FIXTURE) < 250 * 1024


def _stale_handoff(state_gan, sun_params):
    """Fault 4: the hand-off copies the stored parameters only."""
    state_gan.sun.load_state_dict(sun_params)


def _handoff_start(fault=None):
    """The "param" configuration's GAN state reached through a hand-off:
    its sun-pose net (stored and master) first overwritten by another
    draw, then handed the float32 sun-pose weights of the resume export's
    GAN state, as a float32 SUN checkpoint holds them (modules/sun). A
    correct hand-off gives back the golden's starting state."""
    from skyhdr_torch.utils.transplant import init_model_vars, load_model_vars

    cfg = G.knob_config("param")
    export = G.resume_export(0)
    gan = state_from_export(G.knob_export(export["SKY"], "float32", "bfloat16"), cfg, "cpu")
    sun = state_from_export(G.knob_export(export["SUN"], "float32", "bfloat16"), cfg, "cpu")
    donor = engine.build_models(G.golden_config(), "cpu")[1]
    load_model_vars(donor, unflatten(export["SKY"][1], "sun_vars"))
    master = gan.opt_gen.moments()["master"]
    other = init_model_vars(cfg, 5)[1]
    with torch.no_grad():
        load_model_vars(gan.sun, other)
        for p in gan.sun.parameters():
            master[p].copy_(p)
    if fault is None:
        engine.replace_sun_params(cfg, gan, donor.state_dict())
    else:
        fault(gan, donor.state_dict())
    return cfg, gan, sun, donor


def test_handoff_refreshes_master():
    """`skyhdr`'s test_handoff_refreshes_master invariant: after the hand-off
    from a float32 SUN checkpoint the master holds the donor's values and
    the stored parameters their rounding; the first step then matches the
    knob golden's "param" configuration."""
    cfg, gan, sun, donor = _handoff_start()
    master = gan.opt_gen.moments()["master"]
    for name, p in gan.sun.named_parameters():
        want = donor.state_dict()[name]
        assert torch.equal(master[p], want) and torch.equal(p, want.to(torch.bfloat16)), name
    with np.load(G.KNOBS_FIXTURE) as f:
        fails, worst = G.compare_knobs_golden(
            dict(f), G.port_knob_steps("param", "cpu", states=(gan, sun)), "param")
    assert not fails, (fails[:10], json.dumps(worst))


def _golden_fault(stored, fault, config, monkeypatch):
    """The knob golden's failures for `config` under `fault`."""
    if fault == "stale_handoff_master":
        _, gan, sun, _ = _handoff_start(_stale_handoff)
        return _golden(stored, config, states=(gan, sun))[0]
    if fault == "no_master":
        return _golden(stored, config, fault=lambda gan, sun: [
            _no_master(o) for s in (gan, sun) for o in s.optimizers().values()])[0]
    # The knob ignored: the port runs the configuration with it at float32.
    knob = {"opt": "opt_state_dtype", "grad": "grad_dtype", "param": "param_dtype"}
    cfg = G.knob_config(config)
    off = [knob[fault.split("_")[0]]] if fault != "all_ignored" else list(knob.values())
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, **{k: "float32" for k in off}))
    monkeypatch.setattr(G, "knob_config", lambda name, fused=False: cfg)
    export = G.resume_export(0)
    states = [state_from_export(G.knob_export(export[n], cfg.train.opt_state_dtype,
                                              cfg.train.param_dtype), cfg, "cpu")
              for n in ("SKY", "SUN")]
    return _golden(stored, config, states=states)[0]


@pytest.mark.parametrize("fault", [f for f, (_, where) in FAULTS.items() if where == "golden"])
def test_planted_fault_is_caught(stored, fault, monkeypatch):
    """Each fault that `FAULTS` gives to the knob golden fails it; the
    others, which the step-level comparison cannot resolve, fail the
    optimizer-level comparison (`test_optimizer_comparison_sees_a_fault`,
    under both optimizers)."""
    assert _golden_fault(stored, fault, FAULTS[fault][0], monkeypatch)


def test_skyhdr_state_exported_and_resumed(stored, tmp_path):
    """A `skyhdr` GanState and SunState with bfloat16 parameters and
    bfloat16 moments (`jax_state`), exported by the tool's `export_state`
    through `write_export` and imported, resume one step within the knob
    golden's "all" configuration."""
    from skyhdr.config import Config, DataConfig, ModelConfig, TrainConfig

    tool = _load_tool()
    cfg = G.knob_config("all")
    jcfg = Config(model=ModelConfig(**vars(cfg.model)), data=DataConfig(batch_size=2),
                  train=TrainConfig(opt_state_dtype="bfloat16", param_dtype="bfloat16"))
    states = []
    for name, kind in (("SKY", "gan"), ("SUN", "sun")):
        jstate = G.jax_state(G.resume_export(0)[name], "bfloat16", "bfloat16")
        manifest, leaves = tool.export_state(kind, 3, jax.tree_util.tree_map(np.asarray, jstate),
                                             jcfg)
        assert (manifest["param_dtype"], manifest["opt_state_dtype"]) == ("bfloat16", "bfloat16")
        write_export(str(tmp_path / name), manifest, leaves)
        states.append(state_from_export(read_export(str(tmp_path / name)), cfg, "cpu"))
    fails, worst = G.compare_knobs_golden(
        stored, G.port_knob_steps("all", "cpu", states=states), "all")
    assert not fails, (fails[:10], json.dumps(worst))


def _load_tool():
    spec = importlib.util.spec_from_file_location(
        "export_jax_checkpoint", os.path.join(ROOT, "tools", "export_jax_checkpoint.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.mark.slow
def test_knobs_fixture_regenerates(stored):
    """`skyhdr`'s steps under each configuration (10 JAX compiles, ~5 min
    on the CPU) reproduce the fixture."""
    fresh = G.make_train_golden_knobs(0)
    assert sorted(fresh) == sorted(stored)
    for name, want in stored.items():
        if want.dtype.kind in "USu":
            np.testing.assert_array_equal(fresh[name], want, err_msg=name)
        else:
            np.testing.assert_allclose(fresh[name], want, rtol=1e-6, atol=1e-9, err_msg=name)
