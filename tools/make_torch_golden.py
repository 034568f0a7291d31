"""Golden outputs of `skyhdr` for the PyTorch port, on the CPU at 16x64 with
the distortion-aware conv (the XLA gather path), weights from
`skyhdr_torch.utils.transplant` (`init_model_vars` / `init_gan_vars`) and
seeded numpy inputs:

  - the serving forward (`make_inference_fn`)
      -> tests/fixtures/torch_golden_da_16x64.npz
  - one GAN train step and one sun-pretrain step from the seeded weights:
    the JAX-degraded (hdr_t, ldr) pair and the vMF ground truth they were
    fed, their metrics, and per-leaf digests of the updated parameters
    (sum and sum of |.| of the update) and BatchNorm statistics
      -> tests/fixtures/torch_golden_train_16x64.npz
  - the same two at `da_kernel_size=5` (5x5 DA convs in the residual trunk,
    the other convs plain)
      -> tests/fixtures/torch_golden_da5_16x64.npz,
         tests/fixtures/torch_golden_train_da5_16x64.npz
  - one GAN step and one sun step resumed from the checkpoints of
    `resume_export` (the seeded weights with BatchNorm statistics and
    optimizer moments drawn nonzero, a nonzero step and epoch, Adam's count
    > 0), fed the train golden's JAX-degraded inputs
      -> tests/fixtures/torch_golden_resume_16x64.npz

    python tools/make_torch_golden.py

`tests/test_torch_slice.py`, `tests/test_torch_train.py`,
`tests/test_torch_da_generic.py` and `tests/test_torch_convert.py`
regenerate them and check them against the files; `chip_smoke.py` holds the
port's CUDA run to them.
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_golden_da_16x64.npz")
TRAIN_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_golden_train_16x64.npz")
# The same at da_kernel_size=5.
DA5_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_golden_da5_16x64.npz")
DA5_TRAIN_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                                 "torch_golden_train_da5_16x64.npz")
RESUME_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_golden_resume_16x64.npz")
H, W, BATCH = 16, 64, 2
# (step, epoch) of the resumed checkpoints; Adam's count is the SUN step.
RESUME_COUNTERS = {"SKY": (12, 2), "SUN": (7, 1)}


def golden_config(da_kernel_size: int = 3):
    from skyhdr_torch.config import Config, DataConfig, ModelConfig

    return Config(model=ModelConfig(im_height=H, im_width=W, use_da_conv=True,
                                    da_kernel_size=da_kernel_size, da_backend="xla"),
                  data=DataConfig(batch_size=BATCH))


def golden_input(seed: int) -> np.ndarray:
    return np.random.default_rng(seed + 1).uniform(
        0.0, 1.0, (BATCH, H, W, 3)).astype(np.float32)


def make_golden(seed: int = 0, da_kernel_size: int = 3) -> dict:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from skyhdr.config import Config, DataConfig, ModelConfig
    from skyhdr.train.engine import make_inference_fn
    from skyhdr_torch.utils.transplant import init_model_vars, tree_digest

    tcfg = golden_config(da_kernel_size)
    cfg = Config(model=ModelConfig(**vars(tcfg.model)),
                 data=DataConfig(batch_size=BATCH))
    gen_vars, sun_vars = init_model_vars(tcfg, seed)
    x = golden_input(seed)
    out = make_inference_fn(cfg)(gen_vars, sun_vars, jnp.asarray(x))
    return {
        "seed": np.int64(seed),
        "weights_digest": np.float64(tree_digest({"gen": gen_vars,
                                                  "sun": sun_vars})),
        "input": x,
        "y_final_lin": np.asarray(out["y_final_lin"]),
        "sunpose_pred": np.asarray(out["sunpose_pred"]),
        "alpha": np.asarray(out["alpha"]),
    }


def train_batch(seed: int):
    """The batch of the train golden: hdr uniform [0, 2), elevations
    linspace(4, 28)."""
    hdr = np.random.default_rng(seed + 2).uniform(
        0.0, 2.0, (BATCH, H, W, 3)).astype(np.float32)
    return hdr, np.linspace(4, 28, BATCH).astype(np.float32)


def flat_leaves(tree, prefix=""):
    """[(path, array)] of a nested dict, paths joined by '/', sorted."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}/{k}" if prefix else k
        out += flat_leaves(v, path) if isinstance(v, dict) else [(path, np.asarray(v))]
    return out


def update_digests(new_tree, old_tree):
    """(paths, [n, 3] float64): per leaf, sum, sum of |.| and max |.| of
    new - old."""
    old = dict(flat_leaves(old_tree))
    paths, rows = [], []
    for path, v in flat_leaves(new_tree):
        d = np.asarray(v, np.float64) - np.asarray(old[path], np.float64)
        paths.append(path)
        rows.append((d.sum(), np.abs(d).sum(), np.abs(d).max()))
    return np.array(paths), np.array(rows, np.float64)


def leaf_max(tree, scale: float):
    """[n] float64: per leaf (sorted paths), max of sqrt(scale * |v|); with
    v a second moment nu = (1-b2) g^2 after one step and scale = 1/(1-b2),
    the leaf's max |g|."""
    return np.array([np.sqrt(scale * np.abs(np.asarray(v, np.float64)).max())
                     for _, v in flat_leaves(tree)])


def stat_digests(tree):
    """(paths, [n] float64): per leaf, the sum."""
    leaves = flat_leaves(tree)
    return (np.array([p for p, _ in leaves]),
            np.array([np.asarray(v, np.float64).sum() for _, v in leaves]))


def stat_abs_sums(tree):
    """[n] float64: per leaf (sorted paths), the sum of |.|."""
    return np.array([np.abs(np.asarray(v, np.float64)).sum() for _, v in flat_leaves(tree)])


def make_train_golden(seed: int = 0, full: bool = False,
                      da_kernel_size: int = 3) -> dict:
    """One GAN step and one sun step of `skyhdr` from the port's seeded
    weights. With `full`, also the whole updated trees and optimizer states
    under "trees" (not stored)."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from skyhdr.config import Config, DataConfig, ModelConfig
    from skyhdr.data.degradation import make_banks
    from skyhdr.models.vgg16 import random_vgg16_weights
    from skyhdr.train import engine
    from skyhdr.utils.io import get_exposure_lists, make_synthetic_dorf
    from skyhdr_torch.utils.transplant import init_gan_vars, tree_digest

    tcfg = golden_config(da_kernel_size)
    cfg = Config(model=ModelConfig(**vars(tcfg.model)),
                 data=DataConfig(batch_size=BATCH))
    lr = cfg.train.learning_rate
    gv, sv, dv = init_gan_vars(tcfg, seed)
    banks = make_banks(make_synthetic_dorf(175, 1024), get_exposure_lists()[0])
    hdr, elevation = train_batch(seed)
    batch = {"hdr": jnp.asarray(hdr), "elevation": jnp.asarray(elevation)}
    key = jax.random.PRNGKey(seed + 1)
    hdr_t, ldr = engine._degrade(cfg, banks, key, batch["hdr"])
    sunpose_gt = engine._sunpose_gt_from_elevation(cfg, batch["elevation"])

    state = engine.GanState(
        gen_vars=gv, sun_vars=sv, disc_vars=dv,
        opt_gen=engine._rmsprop(lr).init((gv["params"], sv["params"])),
        opt_disc=engine._rmsprop(lr).init(dv["params"]),
        step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32))
    gan_step = engine.make_gan_train_step(cfg, banks, random_vgg16_weights(), jit=False)
    new, metrics = jax.jit(gan_step)(state, batch, key)
    sun_state = engine.SunState(sun_vars={"params": sv["params"]},
                                opt=engine._adam(lr).init(sv["params"]),
                                step=jnp.zeros((), jnp.int32),
                                epoch=jnp.zeros((), jnp.int32))
    sun_step = engine.make_sun_train_step(cfg, banks, jit=False)
    new_sun, sun_metrics = jax.jit(sun_step)(sun_state, batch, key)

    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    params = {"gen": to_np(new.gen_vars["params"]), "sun": to_np(new.sun_vars["params"]),
              "disc": to_np(new.disc_vars["params"])}
    stats = {"gen": to_np(new.gen_vars["batch_stats"]),
             "disc": to_np(new.disc_vars["batch_stats"])}
    sun_params = to_np(new_sun.sun_vars["params"])
    out = {
        "seed": np.int64(seed),
        "weights_digest": np.float64(tree_digest({"gen": gv, "sun": sv, "disc": dv})),
        "elevation": elevation,
        "hdr_t": np.asarray(hdr_t), "ldr": np.asarray(ldr),
        "sunpose_gt": np.asarray(sunpose_gt),
        "gan_metric_names": np.array(sorted(metrics)),
        "gan_metrics": np.array([float(metrics[k]) for k in sorted(metrics)]),
        "sun_metric_names": np.array(sorted(sun_metrics)),
        "sun_metrics": np.array([float(sun_metrics[k]) for k in sorted(sun_metrics)]),
    }
    old = {"gen": gv["params"], "sun": sv["params"], "disc": dv["params"]}
    out["gan_param_paths"], out["gan_param_digests"] = update_digests(params, old)
    out["gan_stat_paths"], out["gan_stat_digests"] = stat_digests(stats)
    out["gan_stat_abs"] = stat_abs_sums(stats)
    out["sun_param_paths"], out["sun_param_digests"] = update_digests(sun_params,
                                                                      sv["params"])
    # max |g| per leaf, from the second moments (RMSprop: 0.1 g^2; Adam:
    # (1 - 0.999) g^2 after one step).
    nu_gan = {"gen": to_np(new.opt_gen[0].nu[0]), "sun": to_np(new.opt_gen[0].nu[1]),
              "disc": to_np(new.opt_disc[0].nu)}
    out["gan_param_gmax"] = leaf_max(nu_gan, 10.0)
    out["sun_param_gmax"] = leaf_max(to_np(new_sun.opt[0].nu), 1000.0)
    if full:
        out["trees"] = {
            "params": params, "stats": stats, "sun_params": sun_params,
            "nu_gen": to_np(new.opt_gen[0].nu),
            "nu_disc": to_np(new.opt_disc[0].nu),
            "sun_mu": to_np(new_sun.opt[0].mu), "sun_nu": to_np(new_sun.opt[0].nu),
        }
    return out


def resume_export(seed: int = 0) -> dict:
    """{"SKY": (manifest, leaves), "SUN": (manifest, leaves)}: a GanState and
    a SunState at 16x64 DA in the export form of
    `skyhdr_torch.utils.flax_export`, from numpy alone. The GAN's weights
    are `init_gan_vars(seed)`'s, the SUN checkpoint's sun-pose net
    `init_model_vars(seed + 1)`'s (so that serving shows which one it
    restored). From `default_rng(seed + 3)`, in path order: BatchNorm means
    N(0, 0.1) and variances U(0.5, 1.5), and per leaf a scale 10^U(-3, 3)
    for the second moments (U(0.5, 1.5) times it) and first moments
    U(-0.5, 0.5) times the root of the second, which keeps Adam's update
    within its first step's bound. The scales reach above the GAN's 0.1 g^2
    (|g| up to ~56 here), so that RMSprop's update follows the moment and a
    moment mapped to another leaf moves it: a smaller range (10^U(-8, -3))
    let the gradient swamp the moment, and swapping two trunk kernels'
    moments stayed within the golden's tolerance
    (test_torch_convert.py:test_resume_golden_sees_a_wrong_moment)."""
    from skyhdr_torch.utils.flax_export import flatten
    from skyhdr_torch.utils.transplant import init_gan_vars, init_model_vars

    cfg = golden_config()
    gv, sv, dv = init_gan_vars(cfg, seed)
    rng = np.random.default_rng(seed + 3)

    def stats(vars_):
        out = flatten(vars_["params"], "params")
        for path, v in sorted(flatten(vars_["batch_stats"], "batch_stats").items()):
            out[path] = (rng.standard_normal(v.shape, dtype=np.float32) * np.float32(0.1)
                         if path.endswith("/mean")
                         else rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
        return out

    def second(params):
        return {p: (np.float32(10.0 ** rng.uniform(-3, 3))
                    * rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
                for p, v in sorted(flatten(params).items())}

    def first(nu):
        return {p: (np.sqrt(v) * rng.uniform(-0.5, 0.5, v.shape)).astype(np.float32)
                for p, v in sorted(nu.items())}

    def with_prefix(prefix, leaves):
        return {f"{prefix}/{p}": v for p, v in leaves.items()}

    shape = {"im_height": H, "im_width": W, "use_da_conv": True, "da_kernel_size": 3}
    sky = {**with_prefix("gen_vars", stats(gv)), **with_prefix("sun_vars", flatten(sv)),
           **with_prefix("disc_vars", stats(dv)),
           **with_prefix("opt_gen/nu/0", second(gv["params"])),
           **with_prefix("opt_gen/nu/1", second(sv["params"])),
           **with_prefix("opt_disc/nu", second(dv["params"]))}
    sun_params = init_model_vars(cfg, seed + 1)[1]["params"]
    nu = second(sun_params)
    sun = {**with_prefix("sun_vars", flatten(sun_params, "params")),
           **with_prefix("opt/mu", first(nu)), **with_prefix("opt/nu", nu)}
    out = {}
    for name, kind, leaves in (("SKY", "gan", sky), ("SUN", "sun", sun)):
        step, epoch = RESUME_COUNTERS[name]
        out[name] = ({"kind": kind, "orbax_step": epoch, "step": step, "epoch": epoch,
                      "count": step if kind == "sun" else None, "param_dtype": "float32",
                      "opt_state_dtype": "float32", **shape}, leaves)
    return out


def export_digest(export) -> float:
    """Sum of |leaf| over every leaf of `resume_export`'s two states, in
    float64, plus their counters."""
    from skyhdr_torch.utils.transplant import tree_digest

    total = 0.0
    for name in sorted(export):
        manifest, leaves = export[name]
        total += tree_digest(leaves) + sum(manifest[k] or 0 for k in ("step", "epoch", "count"))
    return total


def _set_moments(opt, fields):
    """`opt` (an optax state) with the fields of its moment node (the one
    with a `nu`) replaced by `fields`, cast to the dtypes they replace."""
    import jax
    import jax.numpy as jnp

    if hasattr(opt, "nu"):
        return opt._replace(**{k: jax.tree_util.tree_map(
            lambda old, new: jnp.asarray(new, old.dtype), getattr(opt, k), v)
            for k, v in fields.items()})
    if isinstance(opt, tuple):
        nodes = [_set_moments(node, fields) for node in opt]
        return type(opt)(*nodes) if hasattr(opt, "_fields") else tuple(nodes)
    return opt


def jax_state(export, opt_state_dtype: str = "float32", param_dtype: str = "float32"):
    """The `skyhdr` GanState or SunState of one (manifest, leaves) of
    `resume_export`, built from its trees without `create_*_state`'s jit;
    optionally with the moments stored in `opt_state_dtype` and the
    parameters in `param_dtype` (their optimizer state then a
    `MasterParamsState` over the float32 values)."""
    import jax
    import jax.numpy as jnp

    from skyhdr.train import engine
    from skyhdr_torch.utils.flax_export import unflatten

    manifest, leaves = export
    lr = golden_config().train.learning_rate
    tree = lambda prefix: jax.tree_util.tree_map(jnp.asarray, unflatten(leaves, prefix))
    store = lambda v: dict(v, params=engine._store_params(v["params"], param_dtype))
    counters = dict(step=jnp.asarray(manifest["step"], jnp.int32),
                    epoch=jnp.asarray(manifest["epoch"], jnp.int32))
    if manifest["kind"] == "gan":
        gv, sv, dv = tree("gen_vars"), tree("sun_vars"), tree("disc_vars")
        rms = lambda: engine._rmsprop(lr, opt_state_dtype, param_dtype)
        opt_gen = _set_moments(rms().init((gv["params"], sv["params"])),
                               {"nu": (tree("opt_gen/nu/0"), tree("opt_gen/nu/1"))})
        opt_disc = _set_moments(rms().init(dv["params"]), {"nu": tree("opt_disc/nu")})
        return engine.GanState(gen_vars=store(gv), sun_vars=store(sv), disc_vars=store(dv),
                               opt_gen=opt_gen, opt_disc=opt_disc, **counters)
    sv = tree("sun_vars")
    opt = _set_moments(engine._adam(lr, opt_state_dtype, param_dtype).init(sv["params"]),
                       {"mu": tree("opt/mu"), "nu": tree("opt/nu"),
                        "count": jnp.asarray(manifest["count"], jnp.int32)})
    return engine.SunState(sun_vars=store(sv), opt=opt, **counters)


def make_resume_golden(seed: int = 0, states=None) -> dict:
    """One GAN step and one sun step of `skyhdr` from the f32 states of
    `resume_export(seed)` (or from `states`, (GanState, SunState), such as
    the same checkpoints restored from Orbax), on the train golden's batch
    and key. Keys as in `make_train_golden`, with `export_digest` for
    `weights_digest`; the JAX-degraded inputs are the train golden's (its
    file's, degraded from the same batch and key); the max |g| per leaf
    comes from the same steps taken from zero moments (the gradients do not
    depend on the moments)."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from skyhdr.config import Config, DataConfig, ModelConfig
    from skyhdr.data.degradation import make_banks
    from skyhdr.models.vgg16 import random_vgg16_weights
    from skyhdr.train import engine
    from skyhdr.utils.io import get_exposure_lists, make_synthetic_dorf

    export = resume_export(seed)
    tcfg = golden_config()
    cfg = Config(model=ModelConfig(**vars(tcfg.model)), data=DataConfig(batch_size=BATCH))
    if states is None:
        states = jax_state(export["SKY"]), jax_state(export["SUN"])
    state, sun_state = states
    banks = make_banks(make_synthetic_dorf(175, 1024), get_exposure_lists()[0])
    hdr, elevation = train_batch(seed)
    batch = {"hdr": jnp.asarray(hdr), "elevation": jnp.asarray(elevation)}
    key = jax.random.PRNGKey(seed + 1)
    train = np.load(TRAIN_FIXTURE)
    if int(train["seed"]) != seed:
        raise ValueError(f"{TRAIN_FIXTURE} holds seed {int(train['seed'])}, not {seed}")
    gan_step = jax.jit(engine.make_gan_train_step(cfg, banks, random_vgg16_weights(),
                                                  jit=False))
    sun_step = jax.jit(engine.make_sun_train_step(cfg, banks, jit=False))
    new, metrics = gan_step(state, batch, key)
    new_sun, sun_metrics = sun_step(sun_state, batch, key)
    zeros = lambda t: jax.tree_util.tree_map(jnp.zeros_like, t)
    from_zero, _ = gan_step(state.replace(opt_gen=zeros(state.opt_gen),
                                          opt_disc=zeros(state.opt_disc)), batch, key)
    sun_from_zero, _ = sun_step(sun_state.replace(opt=zeros(sun_state.opt)), batch, key)

    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    old = {"gen": state.gen_vars["params"], "sun": state.sun_vars["params"],
           "disc": state.disc_vars["params"]}
    params = {"gen": to_np(new.gen_vars["params"]), "sun": to_np(new.sun_vars["params"]),
              "disc": to_np(new.disc_vars["params"])}
    stats = {"gen": to_np(new.gen_vars["batch_stats"]),
             "disc": to_np(new.disc_vars["batch_stats"])}
    out = {
        "seed": np.int64(seed),
        "export_digest": np.float64(export_digest(export)),
        "elevation": elevation,
        **{k: train[k] for k in ("hdr_t", "ldr", "sunpose_gt")},
        "gan_metric_names": np.array(sorted(metrics)),
        "gan_metrics": np.array([float(metrics[k]) for k in sorted(metrics)]),
        "sun_metric_names": np.array(sorted(sun_metrics)),
        "sun_metrics": np.array([float(sun_metrics[k]) for k in sorted(sun_metrics)]),
    }
    out["gan_param_paths"], out["gan_param_digests"] = update_digests(params, to_np(old))
    out["gan_stat_paths"], out["gan_stat_digests"] = stat_digests(stats)
    out["gan_stat_abs"] = stat_abs_sums(stats)
    out["sun_param_paths"], out["sun_param_digests"] = update_digests(
        to_np(new_sun.sun_vars["params"]), to_np(sun_state.sun_vars["params"]))
    nu_gan = {"gen": to_np(from_zero.opt_gen[0].nu[0]),
              "sun": to_np(from_zero.opt_gen[0].nu[1]),
              "disc": to_np(from_zero.opt_disc[0].nu)}
    out["gan_param_gmax"] = leaf_max(nu_gan, 10.0)
    out["sun_param_gmax"] = leaf_max(to_np(sun_from_zero.opt[0].nu), 1000.0)
    return out


def port_train_golden(stored, device, fused_instance_norm: bool = False,
                      da_kernel_size: int = 3) -> dict:
    """The port's GAN step and sun step from the same seeded weights on the
    stored JAX-degraded inputs, reduced to the fixture's metrics and
    digests (keys as in `make_train_golden`, with the port's values). With
    `fused_instance_norm` the port runs that configuration (the same
    function, so the same fixture holds); `da_kernel_size` must be the
    fixture's."""
    import dataclasses

    from skyhdr_torch.train.engine import create_gan_state, create_sun_state

    cfg = golden_config(da_kernel_size)
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, fused_instance_norm=fused_instance_norm))
    seed = int(stored["seed"])
    return port_steps(stored, cfg, create_gan_state(cfg, seed, device),
                      create_sun_state(cfg, seed, device), device)


def port_steps(stored, cfg, state, sun_state, device) -> dict:
    """The port's GAN step from `state` and sun step from `sun_state` on the
    stored JAX-degraded inputs, reduced to the fixture's metrics and digests
    (keys as in `make_train_golden`, with the port's values)."""
    import torch

    from skyhdr_torch.data.degradation import make_banks
    from skyhdr_torch.models.vgg16 import random_vgg16_weights
    from skyhdr_torch.train.engine import make_gan_train_step, make_sun_train_step
    from skyhdr_torch.utils.io import get_exposure_lists, make_synthetic_dorf
    from skyhdr_torch.utils.transplant import export_model_vars

    banks = make_banks(make_synthetic_dorf(175, 1024), get_exposure_lists()[0],
                       device=device)
    inputs = [torch.from_numpy(np.array(stored[k])).to(device)
              for k in ("hdr_t", "ldr", "sunpose_gt")]

    def params(*modules):
        return {n: export_model_vars(m, collections=("params",))["params"]
                for n, m in zip(("gen", "sun", "disc"), modules)}

    old = params(state.gen, state.sun, state.disc)
    state, metrics = make_gan_train_step(cfg, banks, random_vgg16_weights()).train_on(
        state, *inputs)
    sun_old = params(sun_state.sun)["gen"]
    sun_state, sun_metrics = make_sun_train_step(cfg, banks).train_on(sun_state, *inputs)
    out = {
        "gan_metrics": np.array([float(metrics[k]) for k in stored["gan_metric_names"]]),
        "sun_metrics": np.array([float(sun_metrics[k]) for k in stored["sun_metric_names"]]),
    }
    _, out["gan_param_digests"] = update_digests(
        params(state.gen, state.sun, state.disc), old)
    _, out["gan_stat_digests"] = stat_digests(
        {n: export_model_vars(m, collections=("batch_stats",))["batch_stats"]
         for n, m in (("gen", state.gen), ("disc", state.disc))})
    _, out["sun_param_digests"] = update_digests(params(sun_state.sun)["gen"], sun_old)
    return out


def compare_train_golden(stored, port, metric_rtol: float, update_rtol: float):
    """Failures (a list of strings) of the port's `port_train_golden`
    against the stored JAX values, and the largest relative errors.

    Metrics: within `metric_rtol` (atol 1e-6). Updates: per leaf, the sum
    and the sum of |.| of the update within `update_rtol` of the JAX sum of
    |.|. A leaf whose gradient is zero in exact arithmetic (a conv bias
    feeding an InstanceNorm) comes out as float noise in both packages, and
    the optimizers map noise to updates of either sign; such a leaf (max |g|
    <= 1e-5 of the step's largest) is held only to the optimizer's bound on
    |update| (3.17 lr per element for RMSprop, whatever its moments; 1.01
    lr for Adam's first step, and for the step resumed from
    `resume_export`, whose first moments are at most half the root of the
    second). BatchNorm statistics: the sums within 1e-4 relative, where a sum
    that cancels (a running mean) is held relative to 1e-2 of its leaf's
    sum of |.| at least, since its terms' rounding weighs more than 100-fold
    against it."""
    fails, worst = [], {}
    for kind in ("gan", "sun"):
        got, want = port[f"{kind}_metrics"], stored[f"{kind}_metrics"]
        for name, a, b in zip(stored[f"{kind}_metric_names"], got, want):
            if not abs(a - b) <= metric_rtol * abs(b) + 1e-6:
                fails.append(f"{kind} metric {name}: {a} vs {b}")
        worst[f"{kind}_metrics"] = float(np.max(np.abs(got - want) / (np.abs(want) + 1e-6)))
        lr_bound = 3.17e-4 if kind == "gan" else 1.01e-4
        gmax = stored[f"{kind}_param_gmax"]
        noise = gmax <= 1e-5 * gmax.max()
        err = 0.0
        for path, g, w, is_noise in zip(stored[f"{kind}_param_paths"],
                                        port[f"{kind}_param_digests"],
                                        stored[f"{kind}_param_digests"], noise):
            if is_noise:
                if not g[2] <= lr_bound:
                    fails.append(f"{kind} update {path}: max |update| {g[2]}")
                continue
            e = float(np.max(np.abs(g[:2] - w[:2])) / max(w[1], 1e-30))
            err = max(err, e)
            if not e <= update_rtol:
                fails.append(f"{kind} update {path}: digests {g} vs {w}")
        worst[f"{kind}_updates"] = err
    got, want = port["gan_stat_digests"], stored["gan_stat_digests"]
    scale = np.maximum(np.abs(want), 1e-2 * stored["gan_stat_abs"])
    e = np.abs(got - want) / np.maximum(scale, 1e-30)
    worst["gan_stats"] = float(e.max())
    fails += [f"batch_stats {p}: {a} vs {b}" for p, a, b, x in
              zip(stored["gan_stat_paths"], got, want, e) if not x <= 1e-4]
    return fails, worst


def main():
    sys.path.insert(0, ROOT)
    for path, make in ((FIXTURE, lambda: make_golden(0)),
                       (TRAIN_FIXTURE, lambda: make_train_golden(0)),
                       (DA5_FIXTURE, lambda: make_golden(0, da_kernel_size=5)),
                       (DA5_TRAIN_FIXTURE, lambda: make_train_golden(0, da_kernel_size=5)),
                       (RESUME_FIXTURE, lambda: make_resume_golden(0))):
        np.savez_compressed(path, **make())
        print(f"wrote {path} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    main()
