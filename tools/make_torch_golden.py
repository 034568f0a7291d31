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
  - one GAN step and one sun step under compute_dtype="bfloat16", with
    `skyhdr`'s DA layers on the Pallas path (interpret mode), and its GAN
    and sun eval steps on the same inputs: metrics, per-leaf gradient
    digests (sum g and sum |g|) and BatchNorm statistics
      -> tests/fixtures/torch_golden_train_bf16_16x64.npz
  - one GAN step and one sun step resumed from the checkpoints of
    `resume_export` (the seeded weights with BatchNorm statistics and
    optimizer moments drawn nonzero, a nonzero step and epoch, Adam's count
    > 0), fed the train golden's JAX-degraded inputs
      -> tests/fixtures/torch_golden_resume_16x64.npz
  - the same resumed steps under the storage knobs (`KNOB_CONFIGS`: a
    float32 control, bf16 moments, bf16 gradients, bf16 parameters with a
    float32 master, all three), at float32 compute: metrics, update
    digests, every stored leaf's dtype and seeded samples of the new
    parameters, moments and master
      -> tests/fixtures/torch_golden_train_knobs_16x64.npz

    python tools/make_torch_golden.py

With no argument it writes every fixture; `python tools/make_torch_golden.py
fsdp` writes tests/fixtures/torch_golden_fsdp_16x64.npz alone (`make_fsdp_golden`:
`skyhdr`'s FSDP steps on two virtual CPU devices at 1 MiB and 64 KiB),
`python tools/make_torch_golden.py plain-bf16-adv` prints `plain_bf16_adv`
(8 GAN steps of both packages at plain 32x128 b8 bf16 on the CPU), and
`python tools/make_torch_golden.py trajectory-spread` prints
`trajectory_spread` (how far free runs of the 8 + 8 step DA trajectory
drift from `skyhdr`'s: `skyhdr`'s own under weight noise, the port's), and
`python tools/make_torch_golden.py draws` writes
tests/fixtures/torch_golden_draws_16x64.npz alone (`make_draws_golden`:
digests of `skyhdr`'s `--seed 0` weights and first degradation draws at
DA 16x64, which `chip_smoke.py` holds the card's draws to), and
`python tools/make_torch_golden.py untrained-draws` prints
`untrained_draws` (the untrained generator's output scale under three
seeded draws of each package: `skyhdr`'s and the port's entry-point draw,
which is the same).

`tests/test_torch_slice.py`, `tests/test_torch_train.py`,
`tests/test_torch_da_generic.py`, `tests/test_torch_convert.py` and
`tests/test_torch_train_bf16.py`, `tests/test_torch_train_knobs.py`
regenerate them and check them against the files; `chip_smoke.py` holds the
port's CUDA run to them.
"""

from __future__ import annotations

import importlib.util
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
BF16_TRAIN_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                                  "torch_golden_train_bf16_16x64.npz")
KNOBS_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_golden_train_knobs_16x64.npz")
# The train and bf16 train goldens with plain convs (`use_da_conv=False`,
# `skyhdr`'s default), on the same inputs.
PLAIN_TRAIN_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                                   "torch_golden_train_plain_16x64.npz")
PLAIN_BF16_TRAIN_FIXTURE = os.path.join(ROOT, "tests", "fixtures",
                                        "torch_golden_train_plain_bf16_16x64.npz")
# The knob golden's configurations: (opt_state_dtype, grad_dtype, param_dtype).
KNOB_CONFIGS = {"f32": ("float32", "float32", "float32"),
                "opt": ("bfloat16", "float32", "float32"),
                "grad": ("float32", "bfloat16", "float32"),
                "param": ("float32", "float32", "bfloat16"),
                "all": ("bfloat16", "bfloat16", "bfloat16")}
# Elements sampled a leaf (fewer in a smaller leaf).
KNOB_SAMPLES = 32
# The knob golden's float32 samples, from the port's own gap on the float32
# control (the resume golden's states) on the CPU, times 4: a parameter or
# master within 0.01 of its leaf's largest change in the step (measured
# 0.0100, fused IN; 0.0015 unfused), a moment within 9.5e-4 of its value.
KNOB_STEP_RTOL, KNOB_MOMENT_RTOL = 0.04, 4e-3
H, W, BATCH = 16, 64, 2
DRAWS_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_golden_draws_16x64.npz")
# The draws fixture keeps a leaf's sum, sum of |.| and first DRAWS_LEAD
# values, a noise's first DRAWS_NOISE_LEAD; the card's draw is held to it
# within DRAWS_ULPS float32 ulps (erf_inv's log1p; uniform-drawn, zero and
# one leaves exactly) and its sums within DRAWS_SUM_RTOL of the sum of |.|.
DRAWS_LEAD, DRAWS_NOISE_LEAD = 8, 64
DRAWS_ULPS = 4
DRAWS_SUM_RTOL = 1e-6
# (step, epoch) of the resumed checkpoints; Adam's count is the SUN step.
RESUME_COUNTERS = {"SKY": (12, 2), "SUN": (7, 1)}


def golden_config(da_kernel_size: int = 3, compute_dtype: str = "float32",
                  use_da_conv: bool = True):
    """The port's Config of the fixtures. Under bfloat16 compute `skyhdr`'s
    DA layers take the Pallas path (run by the interpreter on the CPU): its
    XLA path promotes the bilinear samples to float32 against a bfloat16
    kernel, while the Pallas kernels, which the TPU runs and the port
    follows, round samples and weights to bfloat16. `use_da_conv=False` is
    the plain-conv goldens' configuration."""
    from skyhdr_torch.config import Config, DataConfig, ModelConfig

    backend = "xla" if compute_dtype == "float32" else "pallas"
    return Config(model=ModelConfig(im_height=H, im_width=W, use_da_conv=use_da_conv,
                                    da_kernel_size=da_kernel_size, da_backend=backend,
                                    compute_dtype=compute_dtype),
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


def perturbed(tree, share: float, seed: int):
    """`tree` with each leaf times (1 + share N(0, 1)), from
    `default_rng(seed)` in path order: float32 noise of a given size."""
    rng = np.random.default_rng(seed)
    out = {}
    for k in sorted(tree):
        v = tree[k]
        out[k] = (perturbed(v, share, int(rng.integers(2**31))) if isinstance(v, dict) else
                  (np.asarray(v) * (1.0 + share * rng.standard_normal(np.shape(v))))
                  .astype(np.asarray(v).dtype))
    return out


def _jax_train_steps(tcfg, seed: int, perturb: float = 0.0, draw: int = 0):
    """One GAN step and one sun step of `skyhdr` under `tcfg` (the port's
    Config, mirrored) from the port's seeded weights on `train_batch(seed)`
    and the key `seed + 1`: a namespace of the config, banks, batch, key,
    the initial trees (gv, sv, dv), the initial and stepped states, the
    metrics and the JAX-degraded inputs. `perturb`: the weights first
    `perturbed` by that share (seeds 7, 8, 9 plus 10 `draw`)."""
    from types import SimpleNamespace

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from skyhdr.config import Config, DataConfig, ModelConfig
    from skyhdr.data.degradation import make_banks
    from skyhdr.models.vgg16 import random_vgg16_weights
    from skyhdr.train import engine
    from skyhdr.utils.io import get_exposure_lists, make_synthetic_dorf
    from skyhdr_torch.utils.transplant import init_gan_vars

    cfg = Config(model=ModelConfig(**vars(tcfg.model)),
                 data=DataConfig(batch_size=BATCH))
    lr = cfg.train.learning_rate
    gv, sv, dv = init_gan_vars(tcfg, seed)
    if perturb:
        gv, sv, dv = (perturbed(t, perturb, s + 10 * draw)
                      for t, s in ((gv, 7), (sv, 8), (dv, 9)))
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
    vgg = random_vgg16_weights()
    gan_step = engine.make_gan_train_step(cfg, banks, vgg, jit=False)
    new, metrics = jax.jit(gan_step)(state, batch, key)
    sun_state = engine.SunState(sun_vars={"params": sv["params"]},
                                opt=engine._adam(lr).init(sv["params"]),
                                step=jnp.zeros((), jnp.int32),
                                epoch=jnp.zeros((), jnp.int32))
    sun_step = engine.make_sun_train_step(cfg, banks, jit=False)
    new_sun, sun_metrics = jax.jit(sun_step)(sun_state, batch, key)
    return SimpleNamespace(cfg=cfg, banks=banks, batch=batch, key=key, vgg=vgg,
                           gv=gv, sv=sv, dv=dv, state=state, sun_state=sun_state,
                           new=new, metrics=metrics, new_sun=new_sun,
                           sun_metrics=sun_metrics, hdr_t=hdr_t, ldr=ldr,
                           sunpose_gt=sunpose_gt, elevation=elevation)


def _metric_entries(prefix: str, metrics) -> dict:
    """{prefix_metric_names, prefix_metrics} of a metrics dict, sorted."""
    return {f"{prefix}_metric_names": np.array(sorted(metrics)),
            f"{prefix}_metrics": np.array([float(metrics[k]) for k in sorted(metrics)])}


def make_train_golden(seed: int = 0, full: bool = False,
                      da_kernel_size: int = 3, use_da_conv: bool = True) -> dict:
    """One GAN step and one sun step of `skyhdr` from the port's seeded
    weights. With `full`, also the whole updated trees and optimizer states
    under "trees" (not stored)."""
    from skyhdr_torch.utils.transplant import tree_digest

    r = _jax_train_steps(golden_config(da_kernel_size, use_da_conv=use_da_conv), seed)
    gv, sv, dv = r.gv, r.sv, r.dv
    out = {
        "seed": np.int64(seed),
        "weights_digest": np.float64(tree_digest({"gen": gv, "sun": sv, "disc": dv})),
        "elevation": r.elevation,
        "hdr_t": np.asarray(r.hdr_t), "ldr": np.asarray(r.ldr),
        "sunpose_gt": np.asarray(r.sunpose_gt),
        **_train_entries(gv, sv, dv, r.new, r.metrics, r.new_sun, r.sun_metrics, full),
    }
    return out


def _train_entries(gv, sv, dv, new, metrics, new_sun, sun_metrics, full: bool = False) -> dict:
    """The train golden's reduction of `skyhdr`'s stepped GAN state `new`
    (from the trees gv, sv, dv) and sun state `new_sun`, and their metrics:
    metrics, per-leaf update digests, BatchNorm sums, max |g| per leaf;
    with `full`, the whole trees under "trees"."""
    import jax

    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    params, stats, out = _gan_entries(gv, sv, dv, new, metrics)
    del out["nu"]
    sun_params = to_np(new_sun.sun_vars["params"])
    out.update(_metric_entries("sun", sun_metrics))
    out["sun_param_paths"], out["sun_param_digests"] = update_digests(sun_params,
                                                                      sv["params"])
    # max |g| per leaf, from the second moments (Adam: (1 - 0.999) g^2
    # after one step).
    out["sun_param_gmax"] = leaf_max(to_np(new_sun.opt[0].nu), 1000.0)
    if full:
        out["trees"] = {
            "params": params, "stats": stats, "sun_params": sun_params,
            "nu_gen": to_np(new.opt_gen[0].nu),
            "nu_disc": to_np(new.opt_disc[0].nu),
            "sun_mu": to_np(new_sun.opt[0].mu), "sun_nu": to_np(new_sun.opt[0].nu),
        }
    return out


def _gan_entries(gv, sv, dv, new, metrics):
    """(params, stats, entries) of `skyhdr`'s stepped GAN state `new` (from
    the trees gv, sv, dv): the new parameters and BatchNorm statistics as
    numpy trees, and `_train_entries`' GAN keys (metrics, update digests,
    BatchNorm sums, max |g| per leaf from the second moments: RMSprop's
    0.1 g^2), and under "nu" the second moments' tree."""
    import jax

    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    params = {"gen": to_np(new.gen_vars["params"]), "sun": to_np(new.sun_vars["params"]),
              "disc": to_np(new.disc_vars["params"])}
    stats = {"gen": to_np(new.gen_vars["batch_stats"]),
             "disc": to_np(new.disc_vars["batch_stats"])}
    out = _metric_entries("gan", metrics)
    old = {"gen": gv["params"], "sun": sv["params"], "disc": dv["params"]}
    out["gan_param_paths"], out["gan_param_digests"] = update_digests(params, old)
    out["gan_stat_paths"], out["gan_stat_digests"] = stat_digests(stats)
    out["gan_stat_abs"] = stat_abs_sums(stats)
    nu_gan = {"gen": to_np(new.opt_gen[0].nu[0]), "sun": to_np(new.opt_gen[0].nu[1]),
              "disc": to_np(new.opt_disc[0].nu)}
    out["gan_param_gmax"] = leaf_max(nu_gan, 10.0)
    out["nu"] = nu_gan
    return params, stats, out


def rmsprop_grads(nu_tree, new_tree, old_tree):
    """The gradient of RMSprop's first step from zero moments, per leaf of
    the sorted paths: |g| = sqrt(10 nu) (nu = 0.1 g^2), its sign opposite
    to the update's."""
    new, old = dict(flat_leaves(new_tree)), dict(flat_leaves(old_tree))
    return {p: -np.sign(np.asarray(new[p], np.float64) - np.asarray(old[p], np.float64))
            * np.sqrt(10.0 * np.asarray(nu, np.float64))
            for p, nu in flat_leaves(nu_tree)}


def adam_grads(mu_tree):
    """The gradient of Adam's first step from zero moments: g = 10 mu (mu =
    0.1 g), per leaf of the sorted paths."""
    return {p: 10.0 * np.asarray(mu, np.float64) for p, mu in flat_leaves(mu_tree)}


def grad_digests(grads: dict):
    """(paths, [n, 2] float64): per leaf (sorted paths), sum g and sum |g|."""
    paths = sorted(grads)
    return np.array(paths), np.array([(grads[p].sum(), np.abs(grads[p]).sum())
                                      for p in paths], np.float64)


def _bf16_golden_entries(r, eval_metrics, sun_eval_metrics) -> dict:
    """The bf16 golden's reduction of one `_jax_train_steps` run and its eval
    steps' metrics: the four steps' metrics, per-leaf gradient digests and
    the BatchNorm running sums."""
    import jax

    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    new, new_sun = r.new, r.new_sun
    stats = {"gen": to_np(new.gen_vars["batch_stats"]),
             "disc": to_np(new.disc_vars["batch_stats"])}
    grads = rmsprop_grads(
        {"gen": to_np(new.opt_gen[0].nu[0]), "sun": to_np(new.opt_gen[0].nu[1]),
         "disc": to_np(new.opt_disc[0].nu)},
        {"gen": to_np(new.gen_vars["params"]), "sun": to_np(new.sun_vars["params"]),
         "disc": to_np(new.disc_vars["params"])},
        {"gen": r.gv["params"], "sun": r.sv["params"], "disc": r.dv["params"]})
    out = {**_metric_entries("gan", r.metrics), **_metric_entries("sun", r.sun_metrics),
           **_metric_entries("gan_eval", eval_metrics),
           **_metric_entries("sun_eval", sun_eval_metrics)}
    out["gan_grad_paths"], out["gan_grad_digests"] = grad_digests(grads)
    out["sun_grad_paths"], out["sun_grad_digests"] = grad_digests(
        adam_grads(to_np(new_sun.opt[0].mu)))
    out["gan_stat_paths"], out["gan_stat_digests"] = stat_digests(stats)
    out["gan_stat_abs"] = stat_abs_sums(stats)
    return out


def _jax_steps_and_evals(tcfg, seed: int, perturb: float = 0.0, draw: int = 0):
    """`_jax_train_steps` under `tcfg`, then `skyhdr`'s GAN and sun eval
    steps from the same initial states on the same batch and key."""
    from skyhdr.train import engine

    r = _jax_train_steps(tcfg, seed, perturb, draw)
    eval_metrics, _ = engine.make_gan_eval_step(r.cfg, r.banks, r.vgg)(
        r.state, r.batch, r.key)
    sun_eval_metrics, _ = engine.make_sun_eval_step(r.cfg, r.banks)(
        r.sun_state, r.batch, r.key)
    return _bf16_golden_entries(r, eval_metrics, sun_eval_metrics), r


def make_train_golden_bf16(seed: int = 0, use_da_conv: bool = True) -> dict:
    """`make_train_golden`'s GAN step and sun step under
    `compute_dtype="bfloat16"`, with `skyhdr`'s DA layers on the Pallas path
    run by the interpreter, and the GAN and sun eval steps from the seeded
    weights on the same batch and key (so on the same degraded inputs).
    Stores per-leaf digests of the GRADIENT (sum g, sum |g|), recovered from
    the optimizers' moments, not of the update: a first step of RMSprop or
    Adam moves each element by about a constant times lr sign(g), so an
    update digest counts sign flips of small gradients, which bf16 rounding
    flips. Under "f32_..." the same values of `skyhdr`'s float32 steps (the
    f32 train golden's configuration), from which `bf16_tolerances` takes
    `skyhdr`'s own bf16-vs-f32 gap. `use_da_conv=False`: the same with plain
    convs (no Pallas kernel on that path), and under "pert<k>_..." the values
    of `skyhdr`'s bf16 steps from the weights `perturbed` by
    PLAIN_BF16_PERTURB, PLAIN_BF16_PERTURB_DRAWS draws: how far float32 noise
    moves `skyhdr`'s own bf16 run."""
    from jax.experimental.pallas import tpu as pltpu

    from skyhdr_torch.utils.transplant import tree_digest

    with pltpu.force_tpu_interpret_mode():
        entries, r = _jax_steps_and_evals(
            golden_config(compute_dtype="bfloat16", use_da_conv=use_da_conv), seed)
    f32, _ = _jax_steps_and_evals(golden_config(use_da_conv=use_da_conv), seed)
    out = {
        "seed": np.int64(seed),
        "weights_digest": np.float64(tree_digest({"gen": r.gv, "sun": r.sv, "disc": r.dv})),
        "elevation": r.elevation,
        "hdr_t": np.asarray(r.hdr_t), "ldr": np.asarray(r.ldr),
        "sunpose_gt": np.asarray(r.sunpose_gt), **entries,
    }
    runs = {"f32": f32}
    for k in range(0 if use_da_conv else PLAIN_BF16_PERTURB_DRAWS):
        runs[f"pert{k}"], _ = _jax_steps_and_evals(
            golden_config(compute_dtype="bfloat16", use_da_conv=False), seed,
            PLAIN_BF16_PERTURB, k)
    for prefix, run in runs.items():
        for k, v in run.items():
            if k.endswith(("_names", "_paths")):
                assert np.array_equal(v, entries[k]), k
            else:
                out[f"{prefix}_{k}"] = v
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


def knob_config(name: str, fused_instance_norm: bool = False):
    """The port's Config of one `KNOB_CONFIGS` entry: the train golden's
    model at float32 compute, the knobs in its TrainConfig."""
    import dataclasses

    opt, grad, param = KNOB_CONFIGS[name]
    cfg = golden_config()
    return cfg.replace(
        model=dataclasses.replace(cfg.model, fused_instance_norm=fused_instance_norm),
        train=dataclasses.replace(cfg.train, opt_state_dtype=opt, grad_dtype=grad,
                                  param_dtype=param))


def _master_path(kind: str, path: str) -> str:
    """The export path of the master of the parameter at `path`."""
    module, rest = path.split("/params/", 1)
    if kind == "sun":
        return f"opt/master/{rest}"
    return {"gen_vars": "opt_gen/master/0", "sun_vars": "opt_gen/master/1",
            "disc_vars": "opt_disc/master"}[module] + "/" + rest


def knob_export(export, opt_state_dtype: str, param_dtype: str):
    """One (manifest, leaves) of `resume_export` as `jax_state(export,
    opt_state_dtype, param_dtype)` holds that state, in export form: the
    moments rounded to bfloat16 under bfloat16 moments; under bfloat16
    parameters the parameters rounded and their float32 values the master.
    numpy and torch only (the card's machine has no JAX)."""
    import torch

    manifest, leaves = export
    rnd = lambda v: torch.from_numpy(np.array(v, np.float32)).to(torch.bfloat16).float().numpy()
    out = {}
    for path, v in leaves.items():
        if path.startswith("opt"):
            out[path] = rnd(v) if opt_state_dtype == "bfloat16" else v
        elif param_dtype == "bfloat16" and "/params/" in path:
            out[path] = rnd(v)
            out[_master_path(manifest["kind"], path)] = v
        else:
            out[path] = v
    return dict(manifest, param_dtype=param_dtype, opt_state_dtype=opt_state_dtype), out


def knob_samples(leaves: dict, dtypes: dict):
    """(float32 samples, bfloat16 samples as their uint16 bits, layout) of
    an export-form state (`leaves`: {path: array}, values exact in float32;
    `dtypes`: {path: dtype name}): over every leaf but the BatchNorm
    statistics, in path order, `KNOB_SAMPLES` elements each at positions
    seeded by the path. `layout` lists (path, dtype, count) in that order."""
    import zlib

    f32, bf16, layout = [], [], []
    for path in sorted(leaves):
        if "/batch_stats/" in path:
            continue
        v = np.asarray(leaves[path], np.float32).ravel()
        rng = np.random.default_rng(zlib.crc32(path.encode()))
        idx = np.sort(rng.choice(v.size, min(KNOB_SAMPLES, v.size), replace=False))
        if dtypes[path] == "bfloat16":
            bf16.append((v[idx].view(np.uint32) >> 16).astype(np.uint16))
        else:
            f32.append(v[idx])
        layout.append((path, dtypes[path], idx.size))
    cat = lambda xs, dt: np.concatenate(xs) if xs else np.zeros(0, dt)
    return cat(f32, np.float32), cat(bf16, np.uint16), layout


def _digest_path(kind: str, path: str):
    """The `update_digests` path ("gen/...", or the bare path of the sun
    state) of the parameter an export path's parameter or master belongs
    to; None for a moment."""
    parts = path.split("/")
    if parts[1] == "params":
        module, rest = parts[0][:-len("_vars")], parts[2:]
    elif parts[1] == "master":
        if kind == "sun":
            return "/".join(parts[2:])
        module = {"opt_gen": ("gen", "sun")[int(parts[2]) if parts[0] == "opt_gen" else 0],
                  "opt_disc": "disc"}[parts[0]]
        rest = parts[3:] if parts[0] == "opt_gen" else parts[2:]
    else:
        return None
    return "/".join(rest) if kind == "sun" else "/".join([module, *rest])


def _dtype_entries(prefix: str, dtypes: dict) -> dict:
    return {f"{prefix}_leaf_paths": np.array(sorted(dtypes)),
            f"{prefix}_leaf_dtypes": np.array([dtypes[p] for p in sorted(dtypes)])}


def make_train_golden_knobs(seed: int = 0) -> dict:
    """`skyhdr`'s resumed GAN step and sun step (`make_resume_golden`'s, on
    its batch, key and JAX-degraded inputs) from `jax_state(resume_export
    (seed)[...], opt_state_dtype, param_dtype)` under each `KNOB_CONFIGS`
    entry, at float32 compute on the XLA path. Per configuration c:
    c_{gan,sun}_metrics, c_{gan,sun}_param_digests (the stored parameters'
    update, as `update_digests`), c_gan_stat_digests, c_gan_stat_abs,
    c_{gan,sun}_leaf_paths / _leaf_dtypes (every leaf of the new state in
    export form, with its dtype) and c_{gan,sun}_samples_f32 /
    _samples_bf16 (`knob_samples`)."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from skyhdr.config import Config, DataConfig, ModelConfig, TrainConfig
    from skyhdr.data.degradation import make_banks
    from skyhdr.models.vgg16 import random_vgg16_weights
    from skyhdr.train import engine
    from skyhdr.utils.io import get_exposure_lists, make_synthetic_dorf

    spec = importlib.util.spec_from_file_location(
        "export_jax_checkpoint", os.path.join(ROOT, "tools", "export_jax_checkpoint.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)

    export = resume_export(seed)
    resume = np.load(RESUME_FIXTURE)
    banks = make_banks(make_synthetic_dorf(175, 1024), get_exposure_lists()[0])
    hdr, elevation = train_batch(seed)
    batch = {"hdr": jnp.asarray(hdr), "elevation": jnp.asarray(elevation)}
    key = jax.random.PRNGKey(seed + 1)
    vgg = random_vgg16_weights()
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    out = {"seed": np.int64(seed), "export_digest": np.float64(export_digest(export)),
           **{k: resume[k] for k in ("gan_metric_names", "sun_metric_names",
                                     "gan_param_paths", "sun_param_paths", "gan_stat_paths")}}
    for c, (opt, grad, param) in KNOB_CONFIGS.items():
        cfg = Config(model=ModelConfig(**vars(golden_config().model)),
                     data=DataConfig(batch_size=BATCH),
                     train=TrainConfig(opt_state_dtype=opt, grad_dtype=grad, param_dtype=param))
        state, sun_state = jax_state(export["SKY"], opt, param), jax_state(export["SUN"], opt, param)
        new, metrics = jax.jit(engine.make_gan_train_step(cfg, banks, vgg, jit=False))(
            state, batch, key)
        new_sun, sun_metrics = jax.jit(engine.make_sun_train_step(cfg, banks, jit=False))(
            sun_state, batch, key)
        out.update(_metric_entries(c + "_gan", metrics))
        out.update(_metric_entries(c + "_sun", sun_metrics))
        del out[f"{c}_gan_metric_names"], out[f"{c}_sun_metric_names"]
        old = {"gen": state.gen_vars["params"], "sun": state.sun_vars["params"],
               "disc": state.disc_vars["params"]}
        params = {"gen": new.gen_vars["params"], "sun": new.sun_vars["params"],
                  "disc": new.disc_vars["params"]}
        _, out[f"{c}_gan_param_digests"] = update_digests(to_np(params), to_np(old))
        _, out[f"{c}_sun_param_digests"] = update_digests(
            to_np(new_sun.sun_vars["params"]), to_np(sun_state.sun_vars["params"]))
        stats = {"gen": to_np(new.gen_vars["batch_stats"]),
                 "disc": to_np(new.disc_vars["batch_stats"])}
        _, out[f"{c}_gan_stat_digests"] = stat_digests(stats)
        out[f"{c}_gan_stat_abs"] = stat_abs_sums(stats)
        for kind, st in (("gan", new), ("sun", new_sun)):
            _, leaves = tool.export_state(kind, 0, to_np(st), cfg)
            dtypes = {p: np.asarray(v).dtype.name for p, v in leaves.items()}
            out.update(_dtype_entries(f"{c}_{kind}", dtypes))
            out[f"{c}_{kind}_samples_f32"], out[f"{c}_{kind}_samples_bf16"], _ = knob_samples(
                {p: np.asarray(v, np.float32) for p, v in leaves.items()}, dtypes)
    return out


def port_knob_steps(name: str, device, fused_instance_norm: bool = False, seed: int = 0,
                    fault=None, states=None) -> dict:
    """The port's side of the knob golden for `KNOB_CONFIGS[name]`: the
    states of `knob_export(resume_export(seed)[...])` imported by
    `convert.state_from_export` (or `states`, (GanState, SunState) of that
    configuration), `fault(gan, sun)` applied if given, then
    `port_steps` on the resume golden's inputs, and the new states' leaf
    dtypes and samples (the fixture's keys without the configuration's
    prefix); "states" holds (GanState, SunState)."""
    from skyhdr_torch.train.convert import export_from_state, leaf_dtypes, state_from_export

    opt, _, param = KNOB_CONFIGS[name]
    cfg = knob_config(name, fused_instance_norm)
    if states is None:
        export = resume_export(seed)
        states = [state_from_export(knob_export(export[n], opt, param), cfg, device)
                  for n in ("SKY", "SUN")]
    gan, sun = states
    if fault is not None:
        fault(gan, sun)
    old = {kind: export_from_state(state)[1] for kind, state in (("gan", gan), ("sun", sun))}
    out = port_steps(np.load(RESUME_FIXTURE), cfg, gan, sun, device)
    for kind, state in (("gan", gan), ("sun", sun)):
        dtypes = leaf_dtypes(state)
        out.update(_dtype_entries(kind, dtypes))
        out[f"{kind}_samples_f32"], out[f"{kind}_samples_bf16"], out[f"{kind}_layout"] = (
            knob_samples(export_from_state(state)[1], dtypes))
        out[f"{kind}_old_samples_f32"], out[f"{kind}_old_samples_bf16"], _ = knob_samples(
            old[kind], dtypes)
    out["states"] = (gan, sun)
    return out


def _bf16_order(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns as integers in the order of their values (the
    difference of two is their distance in ulps; -0 and +0 are both 0)."""
    bits = bits.astype(np.int64)
    return np.where(bits & 0x8000, -(bits & 0x7FFF), bits & 0x7FFF)


def compare_knobs_golden(stored, port, name: str, step_rtol: float = KNOB_STEP_RTOL,
                         moment_rtol: float = KNOB_MOMENT_RTOL, equal_share: float = 0.99):
    """Failures (a list of strings) of `port_knob_steps(name)` against the
    fixture, and the worst gaps:
      - metrics within 1e-3, the stored parameters' update digests within
        2e-2 and the BatchNorm sums within 1e-4 (`compare_train_golden`,
        with the resume golden's gradient maxima for its zero-gradient
        leaves);
      - every stored leaf's dtype exactly `skyhdr`'s;
      - the port's bfloat16 parameters its master rounded, bit for bit;
      - the bfloat16 samples bit-equal to `skyhdr`'s on at least
        `equal_share` of the elements and within one bfloat16 ulp on all, or, for a
        parameter, within the float32 bound below where that is wider (a
        bias that starts at 0 holds only its step, whose float32 gap a
        bfloat16 ulp near 0 resolves);
      - the float32 samples: a parameter or master within `step_rtol` of
        its leaf's largest change in the step (among the samples; a value
        that starts at 0 is all change, so a relative bound on it would
        weigh the gradient's own rounding); a moment within `moment_rtol`
        of its value, plus, where the gradients are bfloat16, 2^-6 of the
        step's term new - decay * old (a gradient on either side of a
        bfloat16 rounding moves g^2 by up to 2^-7; optax run eagerly rounds
        g^2, (1 - decay) g^2 and (1 - b1) g in bfloat16, as the port does,
        while jitted XLA:CPU keeps the products in float32).
    The parameters and masters of the leaves whose gradient is zero in
    exact arithmetic hold float noise in both packages and are held only
    by the update digests' bound."""
    resume = np.load(RESUME_FIXTURE)
    view = {k: resume[k] for k in ("gan_metric_names", "sun_metric_names", "gan_param_paths",
                                   "sun_param_paths", "gan_stat_paths", "gan_param_gmax",
                                   "sun_param_gmax")}
    view.update({k: stored[f"{name}_{k}"] for k in (
        "gan_metrics", "sun_metrics", "gan_param_digests", "sun_param_digests",
        "gan_stat_digests", "gan_stat_abs")})
    fails, worst = compare_train_golden(view, port, 1e-3, 2e-2)
    _, grad, param = KNOB_CONFIGS[name]
    bf16_grads = "bfloat16" in (grad, param)
    for kind in ("gan", "sun"):
        want = dict(zip(stored[f"{name}_{kind}_leaf_paths"], stored[f"{name}_{kind}_leaf_dtypes"]))
        got = dict(zip(port[f"{kind}_leaf_paths"], port[f"{kind}_leaf_dtypes"]))
        if got != want:
            diff = sorted(p for p in set(got) | set(want) if got.get(p) != want.get(p))
            fails.append(f"{kind} dtypes: {len(diff)} leaves differ, e.g. "
                         f"{[(p, got.get(p), want.get(p)) for p in diff[:3]]}")
            continue
        gmax = view[f"{kind}_param_gmax"]
        noise = set(np.asarray(view[f"{kind}_param_paths"])[gmax <= 1e-5 * gmax.max()])
        bits = [port[f"{kind}_samples_bf16"], stored[f"{name}_{kind}_samples_bf16"],
                port[f"{kind}_old_samples_bf16"]]
        ulps = np.abs(_bf16_order(bits[0]) - _bf16_order(bits[1]))
        values = {"bfloat16": [(v.astype(np.uint32) << 16).view(np.float32).astype(np.float64)
                               for v in bits],
                  "float32": [port[f"{kind}_samples_f32"].astype(np.float64),
                              stored[f"{name}_{kind}_samples_f32"].astype(np.float64),
                              port[f"{kind}_old_samples_f32"].astype(np.float64)]}
        at = {"bfloat16": 0, "float32": 0}
        gaps = {"param": [0.0], "moment": [0.0]}
        equal16, ok16 = [], []
        for path, dtype, n in port[f"{kind}_layout"]:
            sl = slice(at[dtype], at[dtype] + n)
            at[dtype] += n
            if _digest_path(kind, path) in noise:
                continue
            x, y, o = (v[sl] for v in values[dtype])
            if "/params/" in path or "/master/" in path:
                what = "param"
                scale = max(float(np.abs(y - o).max()), 1e-30)
                ratio = np.abs(x - y) / (step_rtol * scale)
            else:
                what = "moment"
                decay = 0.999 if kind == "sun" and "/nu/" in path else 0.9
                slack = 2.0 ** -6 * np.abs(y - decay * o) if bf16_grads else 0.0
                ratio = np.maximum(np.abs(x - y) - slack, 0.0) / np.maximum(
                    moment_rtol * np.abs(y), 1e-30)
            if dtype == "bfloat16":
                equal16.append(ulps[sl])
                ok16.append((ulps[sl] <= 1) | (ratio <= 1.0))
            else:
                gaps[what].append(float(ratio.max()))
        worst[f"{kind}_param_share_of_tol"] = max(gaps["param"])
        worst[f"{kind}_moment_share_of_tol"] = max(gaps["moment"])
        for what, g in gaps.items():
            if not max(g) <= 1.0:
                fails.append(f"{kind} float32 {what} samples: {max(g):.3g} of the tolerance")
        if equal16:
            kept, ok16 = np.concatenate(equal16), np.concatenate(ok16)
            share = float((kept == 0).mean())
            worst[f"{kind}_bf16_equal_share"] = share
            worst[f"{kind}_bf16_max_ulps"] = int(kept.max())
            if share < equal_share or not ok16.all():
                fails.append(f"{kind} bfloat16 samples: {share:.4f} bit-equal, "
                             f"{int((~ok16).sum())} beyond one ulp and the float32 bound")
    import torch

    for state in port["states"]:
        for opt in state.optimizers().values():
            if opt.master is not None and not all(
                    torch.equal(p, m.to(p.dtype)) for p, m in zip(opt.params, opt.master)):
                fails.append(f"{state.kind} parameters are not their master rounded")
    return fails, worst


def harness_gan_state(cfg, seed: int = 0, device="cpu"):
    """The port's GAN state with the test harness's weights
    (`init_gan_vars(cfg, seed)`, from which the goldens were made; not the
    `--seed` draw of `create_gan_state`) and zero moments."""
    from skyhdr_torch.train.engine import empty_gan_state, load_weights
    from skyhdr_torch.utils.transplant import init_gan_vars

    state = empty_gan_state(cfg, device)
    load_weights(state, init_gan_vars(cfg, seed))
    return state


def harness_sun_state(cfg, seed: int = 0, device="cpu"):
    """The port's sun-pretrain state with the harness's sun-pose weights
    (`init_model_vars(cfg, seed)[1]`) and zero moments."""
    from skyhdr_torch.train.engine import empty_sun_state, load_weights
    from skyhdr_torch.utils.transplant import init_model_vars

    state = empty_sun_state(cfg, device)
    load_weights(state, [init_model_vars(cfg, seed)[1]])
    return state


def port_train_golden(stored, device, fused_instance_norm: bool = False,
                      da_kernel_size: int = 3, use_da_conv: bool = True) -> dict:
    """The port's GAN step and sun step from the same seeded weights on the
    stored JAX-degraded inputs, reduced to the fixture's metrics and
    digests (keys as in `make_train_golden`, with the port's values). With
    `fused_instance_norm` the port runs that configuration (the same
    function, so the same fixture holds); `da_kernel_size` must be the
    fixture's, and so must `use_da_conv`."""
    import dataclasses

    cfg = golden_config(da_kernel_size, use_da_conv=use_da_conv)
    cfg = cfg.replace(model=dataclasses.replace(
        cfg.model, fused_instance_norm=fused_instance_norm))
    seed = int(stored["seed"])
    return port_steps(stored, cfg, harness_gan_state(cfg, seed, device),
                      harness_sun_state(cfg, seed, device), device)


def port_steps(stored, cfg, state, sun_state, device) -> dict:
    """The port's GAN step from `state` and sun step from `sun_state` on the
    stored JAX-degraded inputs, reduced to the fixtures' keys (the port's
    values): the metrics; per leaf the update digests (sum, sum |.|, max
    |.|; the float32 goldens compare the first two, the bf16 golden holds
    the leaves of exactly zero gradient to the third); the gradient digests
    recovered from the optimizers' moments (`rmsprop_grads`, `adam_grads`;
    the bf16 golden's, valid only for a step from zero moments); and the
    BatchNorm sums."""
    from skyhdr_torch.train.engine import make_gan_train_step, make_sun_train_step

    banks, inputs, vgg = _port_setup(stored, device)
    out = step_digests(state, sun_state,
                       lambda s: make_gan_train_step(cfg, banks, vgg).train_on(s, *inputs),
                       lambda s: make_sun_train_step(cfg, banks).train_on(s, *inputs))
    for kind in ("gan", "sun"):
        out[f"{kind}_metrics"] = np.array(
            [out[f"{kind}_metric_dict"][k] for k in stored[f"{kind}_metric_names"]])
    return out


def step_digests(state, sun_state, gan_step, sun_step) -> dict:
    """`gan_step(state)` and `sun_step(sun_state)` (each -> (state,
    metrics)) run, and reduced as `port_steps` reduces them, with the keys a
    stored side of `compare_train_golden` has (metric names, leaf paths,
    max |g| per leaf from the second moments, the BatchNorm sums of |.|),
    the metrics by name under "gan_metric_dict" / "sun_metric_dict", and
    the moments flattened leaf after leaf in path order ("gan_nu" over the
    generator, sun-pose net and discriminator; "sun_mu", "sun_nu") with
    each leaf's size ("gan_sizes", "sun_sizes")."""
    out = gan_step_digests(state, gan_step)
    out.update(sun_step_digests(sun_state, sun_step))
    return out


def _params(value_of=None, **modules):
    from skyhdr_torch.utils.transplant import export_model_vars

    return {n: export_model_vars(m, value_of=value_of, collections=("params",))["params"]
            for n, m in modules.items()}


def _flat32(tree):
    return [np.asarray(v, np.float32).ravel() for _, v in flat_leaves(tree)]


def gan_step_digests(state, gan_step) -> dict:
    """The GAN half of `step_digests` (the keys prefixed "gan_")."""
    from skyhdr_torch.utils.transplant import export_model_vars

    modules = {"gen": state.gen, "sun": state.sun, "disc": state.disc}
    old = _params(**modules)
    state, metrics = gan_step(state)
    new = _params(**modules)
    out = {"gan_metric_dict": {k: float(v) for k, v in metrics.items()}}
    out.update(_metric_entries("gan", out["gan_metric_dict"]))
    out["gan_param_paths"], out["gan_param_digests"] = update_digests(new, old)
    nu = {**state.opt_gen.moments()["nu"], **state.opt_disc.moments()["nu"]}
    nu_tree = _params(nu.__getitem__, **modules)
    _, out["gan_grad_digests"] = grad_digests(rmsprop_grads(nu_tree, new, old))
    stats = {n: export_model_vars(m, collections=("batch_stats",))["batch_stats"]
             for n, m in (("gen", state.gen), ("disc", state.disc))}
    out["gan_stat_paths"], out["gan_stat_digests"] = stat_digests(stats)
    out["gan_stat_abs"] = stat_abs_sums(stats)
    out["gan_param_gmax"] = leaf_max(nu_tree, 10.0)
    out["gan_nu"] = np.concatenate(_flat32(nu_tree))
    out["gan_sizes"] = np.array([v.size for v in _flat32(nu_tree)])
    return out


def sun_step_digests(sun_state, sun_step) -> dict:
    """The sun half of `step_digests` (the keys prefixed "sun_")."""
    sun_old = _params(sun=sun_state.sun)["sun"]
    sun_state, sun_metrics = sun_step(sun_state)
    sun_new = _params(sun=sun_state.sun)["sun"]
    out = {"sun_metric_dict": {k: float(v) for k, v in sun_metrics.items()}}
    out.update(_metric_entries("sun", out["sun_metric_dict"]))
    out["sun_param_paths"], out["sun_param_digests"] = update_digests(sun_new, sun_old)
    moments = sun_state.opt.moments()
    mu_tree = _params(moments["mu"].__getitem__, sun=sun_state.sun)["sun"]
    sun_nu_tree = _params(moments["nu"].__getitem__, sun=sun_state.sun)["sun"]
    _, out["sun_grad_digests"] = grad_digests(adam_grads(mu_tree))
    out["sun_param_gmax"] = leaf_max(sun_nu_tree, 1000.0)
    out["sun_mu"], out["sun_nu"] = (np.concatenate(_flat32(t)) for t in (mu_tree, sun_nu_tree))
    out["sun_sizes"] = np.array([v.size for v in _flat32(mu_tree)])
    return out


def port_train_golden_bf16(stored, device, fused_instance_norm: bool = False,
                           use_da_conv: bool = True) -> dict:
    """`port_eval_bf16` and then `port_steps` from the port's seeded
    weights under `compute_dtype="bfloat16"` (with `fused_instance_norm`,
    that configuration: the same function, so the same fixture holds;
    `use_da_conv` must be the fixture's)."""
    cfg = bf16_config(fused_instance_norm, use_da_conv)
    state, sun_state = bf16_states(stored, cfg, device)
    return {**port_eval_bf16(stored, cfg, state, sun_state, device),
            **port_steps(stored, cfg, state, sun_state, device)}


def bf16_config(fused_instance_norm: bool = False, use_da_conv: bool = True):
    """The port's Config of the bf16 train golden (plain convs: of the plain
    bf16 golden)."""
    import dataclasses

    cfg = golden_config(compute_dtype="bfloat16", use_da_conv=use_da_conv)
    return cfg.replace(model=dataclasses.replace(
        cfg.model, fused_instance_norm=fused_instance_norm))


def bf16_states(stored, cfg, device):
    """(GanState, SunState) of the port from the fixture's seed (the
    harness's weights)."""
    seed = int(stored["seed"])
    return harness_gan_state(cfg, seed, device), harness_sun_state(cfg, seed, device)


def _port_setup(stored, device):
    """(banks, [hdr_t, ldr, sunpose_gt] on `device`, VGG16 weights)."""
    import torch

    from skyhdr_torch.data.degradation import make_banks
    from skyhdr_torch.models.vgg16 import random_vgg16_weights
    from skyhdr_torch.utils.io import get_exposure_lists, make_synthetic_dorf

    banks = make_banks(make_synthetic_dorf(175, 1024), get_exposure_lists()[0],
                       device=device)
    inputs = [torch.from_numpy(np.array(stored[k])).to(device)
              for k in ("hdr_t", "ldr", "sunpose_gt")]
    return banks, inputs, random_vgg16_weights()


def _metric_values(stored, prefix: str, metrics) -> np.ndarray:
    return np.array([float(metrics[k]) for k in stored[f"{prefix}_metric_names"]])


def port_eval_bf16(stored, cfg, state, sun_state, device) -> dict:
    """The port's GAN and sun eval steps from `state` and `sun_state` on the
    stored JAX-degraded inputs: {"gan_eval_metrics", "sun_eval_metrics"}."""
    from skyhdr_torch.train.engine import make_gan_eval_step, make_sun_eval_step

    banks, inputs, vgg = _port_setup(stored, device)
    gan = make_gan_eval_step(cfg, banks, vgg).eval_on(state, *inputs)[0]
    sun = make_sun_eval_step(cfg, banks).eval_on(sun_state, *inputs)[0]
    return {"gan_eval_metrics": _metric_values(stored, "gan_eval", gan),
            "sun_eval_metrics": _metric_values(stored, "sun_eval", sun)}


def compare_train_golden(stored, port, metric_rtol: float, update_rtol: float,
                         stat_rtol: float = 1e-4, kinds=("gan", "sun")):
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
    against it (`stat_rtol`: 1e-4). `kinds`: the steps compared (the
    width-sharded runs have a GAN step alone)."""
    fails, worst = [], {}
    for kind in kinds:
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
              zip(stored["gan_stat_paths"], got, want, e) if not x <= stat_rtol]
    return fails, worst


# ---------------------------------------------------------------------------
# Data parallelism: `skyhdr.parallel.dp` against `skyhdr_torch.parallel.dp`
# ---------------------------------------------------------------------------

DP_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_golden_dp_16x64.npz")
FSDP_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_golden_fsdp_16x64.npz")
# The FSDP golden's min_bytes: `skyhdr`'s default (the sun-pose FCs and
# their moments sharded), and 64 KiB, which shards conv kernels of every
# layout as well.
FSDP_MIN_BYTES = (1 << 20, 1 << 16)
# The DP golden: 2 data shards of a global batch of 4 at 16x64 DA f32.
DP_WORLD, DP_BATCH = 2, 4
# A step of the port's data-parallel step against its single-process step
# on the same global batch and key seed (`compare_dp_steps`; 2 gloo
# ranks at DA 16x64, b4, on the CPU). The two differ by the order of the
# cross-rank sums (float32: metrics 5.7e-7, BatchNorm sums 1.1e-6, the
# moments' per-leaf relative L1 3.7e-5), and, where a value is stored or
# computed in bfloat16, by the roundings that order moves: bfloat16 moments
# 3.6e-4 and bfloat16 gradients 1.0e-3 of a moment; bfloat16 parameters
# 8.2e-3 (a bfloat16 leaf's gradient arrives rounded on each rank, through
# the cast autograd takes back, and is summed after: one more rounding than
# the single process's) and bfloat16 compute 4.8e-3 (a bf16 conv's weight
# gradient is rounded per rank). Each class's moment tolerance sits above
# those and below what a planted fault moves: a gradient reduced after its
# bfloat16 cast moves the moments by 6.3e-3, every other fault by more than
# 0.3 (`DP_FAULTS`). `None`: the moments are not compared (the card's run,
# held to `compare_train_golden`'s tolerances).
DP_RTOL = {
    "float32": {"metrics": 1e-5, "updates": 2e-2, "stats": 1e-5, "moments": 2e-4},
    "bf16_storage": {"metrics": 1e-5, "updates": 2e-2, "stats": 1e-5, "moments": 2e-3},
    "bf16_rounding": {"metrics": 1e-5, "updates": 2e-2, "stats": 1e-5, "moments": 2e-2},
    "golden": {"metrics": 1e-3, "updates": 2e-2, "stats": 1e-4, "moments": None},
}


def dp_rtol(case: dict) -> dict:
    """The `DP_RTOL` class of a DP case (its knobs and compute dtype)."""
    opt, grad, param = case.get("knobs", KNOB_CONFIGS["f32"])
    if case.get("compute", "float32") == "bfloat16" or param == "bfloat16":
        return DP_RTOL["bf16_rounding"]
    return DP_RTOL["bf16_storage" if "bfloat16" in (opt, grad) else "float32"]


# The faults a data-parallel step must not have; each fails the comparison
# with the single-process step (tests/test_torch_parallel.py).
DP_FAULTS = ("batchnorm_per_rank", "max_per_rank", "draws_per_rank", "jpeg_ramp_local",
             "reduce_after_cast", "grads_summed")
# The faults an FSDP step must not have (tests/test_torch_fsdp.py): the
# first three fail the comparison with the DP step, the last the residency.
FSDP_FAULTS = ("unreduced_grads", "scatter_summed", "stale_gather", "moment_whole")


def dp_batch(seed: int, batch: int = DP_BATCH, h: int = H, w: int = W):
    """The DP golden's global batch: hdr uniform [0, 2), elevations
    linspace(4, 28)."""
    hdr = np.random.default_rng(seed + 2).uniform(0.0, 2.0, (batch, h, w, 3)).astype(np.float32)
    return {"hdr": hdr, "elevation": np.linspace(4, 28, batch).astype(np.float32)}


def _jax_gan_state(engine, gv, sv, dv, lr):
    import jax.numpy as jnp

    return engine.GanState(gen_vars=gv, sun_vars=sv, disc_vars=dv,
                           opt_gen=engine._rmsprop(lr).init((gv["params"], sv["params"])),
                           opt_disc=engine._rmsprop(lr).init(dv["params"]),
                           step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32))


def _jax_sun_state(engine, sv, lr):
    import jax.numpy as jnp

    return engine.SunState(sun_vars={"params": sv["params"]},
                           opt=engine._adam(lr).init(sv["params"]),
                           step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32))


def make_dp_golden(seed: int = 0) -> dict:
    """One GAN step and one sun step of `skyhdr.parallel.dp`
    (`make_parallel_{gan,sun}_train_step`) on `make_mesh(data=2)` of the CPU
    devices (the tests' 8 virtual ones), global b4 at 16x64 DA f32 (the XLA
    path), from the port's seeded weights on `dp_batch(seed)` and the key
    `seed + 1`. Keys as `make_train_golden`'s, with the JAX-degraded global
    `hdr_t` / `ldr` / `sunpose_gt` (each rank takes its rows), and under
    "single_..." the metrics of `skyhdr`'s single-device steps on the same
    batch and key, which the data-parallel ones equal."""
    return _parallel_golden(seed, {"": None})


def make_fsdp_golden(seed: int = 0) -> dict:
    """`make_dp_golden`'s steps through `skyhdr.parallel.fsdp`
    (`make_fsdp_{gan,sun}_train_step` on `make_mesh(data=2)`) at each
    `FSDP_MIN_BYTES`: the train entries of the steps at min_bytes `m` under
    the prefix "mb<m>_"; the inputs and the single-device metrics as
    `make_dp_golden`'s."""
    return _parallel_golden(seed, {f"mb{m}_": m for m in FSDP_MIN_BYTES})


def _parallel_golden(seed: int, runs: dict) -> dict:
    """`make_dp_golden` (runs {"": None}) or `make_fsdp_golden` (runs
    {prefix: min_bytes})."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from skyhdr.config import Config, DataConfig, ModelConfig
    from skyhdr.data.degradation import make_banks
    from skyhdr.models.vgg16 import random_vgg16_weights
    from skyhdr.parallel import fsdp
    from skyhdr.parallel.dp import make_parallel_gan_train_step, make_parallel_sun_train_step
    from skyhdr.parallel.mesh import make_mesh
    from skyhdr.train import engine
    from skyhdr.utils.io import get_exposure_lists, make_synthetic_dorf
    from skyhdr_torch.utils.transplant import init_gan_vars, tree_digest

    if len(jax.devices()) < DP_WORLD:
        raise RuntimeError(f"the DP golden needs {DP_WORLD} JAX devices: set XLA_FLAGS="
                           "--xla_force_host_platform_device_count=8 before JAX starts")
    tcfg = golden_config()
    cfg = Config(model=ModelConfig(**vars(tcfg.model)), data=DataConfig(batch_size=DP_BATCH))
    lr = cfg.train.learning_rate
    gv, sv, dv = init_gan_vars(tcfg, seed)
    banks = make_banks(make_synthetic_dorf(175, 1024), get_exposure_lists()[0])
    host = dp_batch(seed)
    batch = {k: jnp.asarray(v) for k, v in host.items()}
    key = jax.random.PRNGKey(seed + 1)
    hdr_t, ldr = engine._degrade(cfg, banks, key, batch["hdr"])
    sunpose_gt = engine._sunpose_gt_from_elevation(cfg, batch["elevation"])
    vgg = random_vgg16_weights()
    mesh = make_mesh(data=DP_WORLD)
    out = {"seed": np.int64(seed), "world": np.int64(DP_WORLD),
           "weights_digest": np.float64(tree_digest({"gen": gv, "sun": sv, "disc": dv})),
           **{k: np.asarray(v) for k, v in host.items()},
           "hdr_t": np.asarray(hdr_t), "ldr": np.asarray(ldr),
           "sunpose_gt": np.asarray(sunpose_gt)}
    for prefix, min_bytes in runs.items():
        if min_bytes is None:
            gan_step, shard = make_parallel_gan_train_step(cfg, banks, vgg, mesh)
            sun_step, _ = make_parallel_sun_train_step(cfg, banks, mesh)
            place_gan = place_sun = lambda s: s
        else:
            gan_step, place_gan, shard = fsdp.make_fsdp_gan_train_step(
                cfg, banks, vgg, mesh, min_bytes=min_bytes)
            sun_step, place_sun, _ = fsdp.make_fsdp_sun_train_step(cfg, banks, mesh,
                                                                   min_bytes=min_bytes)
        new, metrics = gan_step(place_gan(_jax_gan_state(engine, gv, sv, dv, lr)),
                                shard(batch), key)
        new_sun, sun_metrics = sun_step(place_sun(_jax_sun_state(engine, sv, lr)),
                                        shard(batch), key)
        out.update({prefix + k: v for k, v in _train_entries(
            gv, sv, dv, new, metrics, new_sun, sun_metrics).items()})
    _, single = jax.jit(engine.make_gan_train_step(cfg, banks, vgg, jit=False))(
        _jax_gan_state(engine, gv, sv, dv, lr), batch, key)
    _, single_sun = jax.jit(engine.make_sun_train_step(cfg, banks, jit=False))(
        _jax_sun_state(engine, sv, lr), batch, key)
    out["single_gan_metrics"] = _metric_entries("gan", single)["gan_metrics"]
    out["single_sun_metrics"] = _metric_entries("sun", single_sun)["sun_metrics"]
    return out


def apply_dp_fault(fault: str):
    """Plant one of DP_FAULTS in this process (a rank's) by patching the
    port's modules, and return the function that takes it out again:
    BatchNorm's statistics over the rank's rows alone (C1); the sun-pose
    maximum of the rank's rows (C2); the rank's own draws of its b rows from
    the shared seed (C3); the JPEG ramp over the rank's b samples (C4); the
    gradients cast to `grad_dtype` before the all-reduce; the gradients
    summed over the ranks, not averaged."""
    import torch

    from skyhdr_torch.data import degradation
    from skyhdr_torch.models import layers
    from skyhdr_torch.parallel import dp
    from skyhdr_torch.train import engine
    from skyhdr_torch.train.optim import storage_dtype

    if fault == "batchnorm_per_rank":
        forward = layers.BatchNorm.forward

        def local(self, x, train=False):
            with layers.batch_across(None):
                return forward(self, x, train)
        target, name, value = layers.BatchNorm, "forward", local
    elif fault == "max_per_rank":
        target, name, value = dp.BatchReduce, "max", lambda self, x: torch.max(x)
    elif fault in ("draws_per_rank", "jpeg_ramp_local"):
        def degrade_batch(key, hdr, banks, shard=(0, 1), **kw):
            index, count = shard
            if fault == "draws_per_rank":
                draws = degradation.draw_degradation(key, hdr.shape, banks)
                return degradation.degrade_with(hdr, banks, draws, shard=shard, **kw)
            draws = degradation.draw_degradation(
                key, (hdr.shape[0] * count, *hdr.shape[1:]), banks)
            return degradation.degrade_with(hdr, banks, degradation.shard_rows(draws, index, count),
                                            **kw)
        target, name, value = engine, "degrade_batch", degrade_batch
    elif fault == "reduce_after_cast":
        def grads(cfg, total, params, reduce=None):
            dtype = storage_dtype(cfg.train.grad_dtype)
            out = [g.to(dtype) for g in torch.autograd.grad(total, params)]
            return out if reduce is None else reduce(out, params)
        target, name, value = engine, "_grads", grads
    elif fault == "grads_summed":
        average = dp.BatchReduce.grads
        target, name, value = (dp.BatchReduce, "grads",
                               lambda self, g, p=None: [x * self.world
                                                        for x in average(self, g, p)])
    elif fault in FSDP_FAULTS:
        return _apply_fsdp_fault(fault)
    else:
        raise ValueError(f"unknown fault {fault!r}")
    old = getattr(target, name)
    setattr(target, name, value)
    return lambda: setattr(target, name, old)


def _apply_fsdp_fault(fault: str):
    """Plant one of FSDP_FAULTS (see `apply_dp_fault`): a sharded group's
    block updated from the rank's own unreduced gradient; the
    reduce-scatter summed, not averaged; every step after the first run on
    the parameters gathered for the first (a stale gather); the moments
    planned but left whole on every rank."""
    from skyhdr_torch.parallel import fsdp

    if fault == "unreduced_grads":
        target, name = fsdp.FsdpReduce, "scatter"
        value = lambda self, g, dim: fsdp._block(g.float(), dim, self.mesh.data_index,
                                                 self.world)
    elif fault == "scatter_summed":
        average = fsdp.FsdpReduce.scatter
        target, name = fsdp.FsdpReduce, "scatter"
        value = lambda self, g, dim: average(self, g, dim) * self.world
    elif fault == "stale_gather":
        gather = fsdp._Layout.gather

        def value(self):
            if not hasattr(self, "first"):
                gather(self)
                self.first = {k: g.param.data for k, g in self.sharded.items()
                              if "params" in g.planned}
            for k, t in self.first.items():
                self.sharded[k].param.data = t
        target, name = fsdp._Layout, "gather"
    else:  # moment_whole
        plan = fsdp.fsdp_plan
        target, name = fsdp, "fsdp_plan"
        value = lambda *a, **kw: {path: None if path.split("/")[1] in ("nu", "mu") else split
                                  for path, split in plan(*a, **kw).items()}
    old = getattr(target, name)
    setattr(target, name, value)
    return lambda: setattr(target, name, old)


def dp_config(case: dict, h: int = H, w: int = W, batch: int = DP_BATCH):
    """The port's Config of one DP case: DA at h x w, the global `batch`,
    the case's compute dtype, fused IN and storage knobs."""
    import dataclasses

    cfg = golden_config()
    opt, grad, param = case.get("knobs", KNOB_CONFIGS["f32"])
    return cfg.replace(
        model=dataclasses.replace(cfg.model, im_height=h, im_width=w,
                                  compute_dtype=case.get("compute", "float32"),
                                  fused_instance_norm=case.get("fused", False)),
        data=dataclasses.replace(cfg.data, batch_size=batch),
        train=dataclasses.replace(cfg.train, opt_state_dtype=opt, grad_dtype=grad,
                                  param_dtype=param))


def _dp_states(cfg, trees, device):
    from skyhdr_torch.train.engine import empty_gan_state, empty_sun_state, load_weights

    gan, sun = empty_gan_state(cfg, device), empty_sun_state(cfg, device)
    load_weights(gan, trees)
    load_weights(sun, [trees[1]])
    return gan, sun


def _dp_trees(spec):
    """The seeded weights of a DP run: the file the parent wrote once
    (`spec["weights"]`, a pickle of `init_gan_vars`' trees), or a draw."""
    import pickle

    from skyhdr_torch.utils.transplant import init_gan_vars

    if spec.get("weights"):
        with open(spec["weights"], "rb") as f:
            return pickle.load(f)
    return init_gan_vars(dp_config({}, spec["h"], spec["w"], spec["batch"]), spec["seed"])


def _dp_setup(spec):
    from skyhdr_torch.data.degradation import make_banks
    from skyhdr_torch.models.vgg16 import random_vgg16_weights
    from skyhdr_torch.utils.io import get_exposure_lists, make_synthetic_dorf

    banks = make_banks(make_synthetic_dorf(175, 1024), get_exposure_lists()[0],
                       device=spec["device"])
    host = dp_batch(spec["seed"], spec["batch"], spec["h"], spec["w"])
    return banks, random_vgg16_weights(), host


def dp_reference(spec: dict, case: dict, trees=None) -> dict:
    """The port's single-process GAN and sun steps of a DP case on the whole
    batch, with the key the ranks use (`step_digests`)."""
    import torch

    from skyhdr_torch.utils import jax_random
    from skyhdr_torch.train.engine import make_gan_train_step, make_sun_train_step

    cfg = dp_config(case, spec["h"], spec["w"], spec["batch"])
    banks, vgg, host = _dp_setup(spec)
    device = spec["device"]
    batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    gan, sun = _dp_states(cfg, trees if trees is not None else _dp_trees(spec), device)
    key = jax_random.key(spec["seed"] + 1)
    return step_digests(gan, sun,
                        lambda s: make_gan_train_step(cfg, banks, vgg)(s, batch, key),
                        lambda s: make_sun_train_step(cfg, banks)(s, batch, key))


def dp_rank(spec: dict, rank: int) -> dict:
    """One rank of a data-parallel run (a process of `run_dp_ranks`): joins
    the group, then per case of `spec["cases"]` builds the GAN and sun
    states from the run's seeded weights, replicates them from rank 0 and
    takes one GAN step and one sun step of `make_parallel_*_train_step` on
    its rows: of the stored JAX-degraded inputs of `spec["fixture"]`
    (`step.train_on`; case "path": "fixture") or of `dp_batch` through the
    degradation from the key of seed + 1 on every rank ("path":
    "batch"). Returns {case name: `step_digests` + "agree" (every rank's
    states bit-equal after the steps) + on the card the DA kernels'
    launches per step}, and under "imported" the top-level modules the
    rank imported; with `spec["timing"]` (or the case's) also each step's
    ms, the collectives' share of it and the peak device memory; with
    `spec["single"]` whether the single-process steps in this process give
    the same bits (a world of 1 under deterministic algorithms; `spec` or a
    case may ask for "deterministic" algorithms). A case with "fsdp":
    min_bytes takes `parallel.fsdp`'s steps (sharded, stepped, unsharded),
    with "vs_dp" instead `fsdp_vs_dp`, with "at_rest" `fsdp_at_rest`."""
    import statistics
    import time

    import torch

    from skyhdr_torch.utils import jax_random
    from skyhdr_torch.parallel import dp as pdp
    from skyhdr_torch.parallel import fsdp as pfsdp

    for case in spec["cases"]:
        if case.get("fault") not in (None, *DP_FAULTS, *FSDP_FAULTS):
            raise ValueError(f"unknown fault {case['fault']!r}")
    mesh = _rank_setup(spec, rank)
    device = spec["device"]
    trees = _dp_trees(spec)
    banks, vgg, host = _dp_setup(spec)
    dc = None
    if device.startswith("cuda"):
        from skyhdr_torch.ops.kernels import deform_conv as dc
    out = {}
    dp_runs = {}  # the DP steps' bits of `fsdp_vs_dp`, by setting
    for case in spec["cases"]:
        t_case = time.perf_counter()
        # An operation with no deterministic form warns.
        torch.use_deterministic_algorithms(
            bool(spec.get("deterministic") or case.get("deterministic")), warn_only=True)
        if case.get("at_rest"):
            out[case["name"]] = fsdp_at_rest(case, mesh, device)
            continue
        undo = apply_dp_fault(case["fault"]) if case.get("fault") else None
        cfg = dp_config(case, spec["h"], spec["w"], spec["batch"])
        gan, sun = (pdp.replicate_state(s, mesh) for s in _dp_states(cfg, trees, device))
        min_bytes = case.get("fsdp")
        if min_bytes is None:
            gan_step, shard = pdp.make_parallel_gan_train_step(cfg, banks, vgg, mesh)
            sun_step, _ = pdp.make_parallel_sun_train_step(cfg, banks, mesh)
            shard_gan = shard_sun = None
        else:
            gan_step, shard_gan, shard = pfsdp.make_fsdp_gan_train_step(
                cfg, banks, vgg, mesh, min_bytes=min_bytes)
            sun_step, shard_sun, _ = pfsdp.make_fsdp_sun_train_step(cfg, banks, mesh, min_bytes)
        launches = {}

        def run(kind, step, state):
            if dc is not None:
                for k in ("K1", "K2", "K3"):
                    setattr(dc, f"{k}_LAUNCHES", 0)
            if case.get("path") == "fixture":
                with np.load(spec["fixture"]) as f:
                    rows = [shard({"hdr": f[k], "elevation": f["elevation"]})["hdr"]
                            for k in ("hdr_t", "ldr", "sunpose_gt")]
                result = step.train_on(state, *rows)
            else:
                result = step(state, shard(host), jax_random.key(spec["seed"] + 1))
            if dc is not None:
                launches[kind] = {k: getattr(dc, f"{k}_LAUNCHES") for k in ("K1", "K2", "K3")}
            return result

        def once(kind, step, shard_state):
            """One step; an FSDP step from the state sharded, unsharded after."""
            if shard_state is None:
                return lambda s: run(kind, step, s)
            return lambda s: (lambda r: (pfsdp.unshard_state(r[0]), r[1]))(
                run(kind, step, shard_state(s)))

        if case.get("vs_dp"):
            res = fsdp_vs_dp(spec, case, cfg, mesh, trees, (banks, vgg, host), dp_runs)
        else:
            res = step_digests(gan, sun, once("gan", gan_step, shard_gan),
                               once("sun", sun_step, shard_sun))
            res["agree"] = pdp.replicas_agree(gan, mesh) and pdp.replicas_agree(sun, mesh)
        res["launches"] = launches
        if spec.get("single"):
            ref = dp_reference(spec, case, trees)
            res["single_equal"] = all(np.array_equal(ref[k], res[k]) for k in (
                "gan_metrics", "sun_metrics", "gan_param_digests", "sun_param_digests",
                "gan_stat_digests", "gan_nu", "sun_mu", "sun_nu"))
        timing = case.get("timing", spec.get("timing"))
        for kind, step, state, shard_state in (("gan", gan_step, gan, shard_gan),
                                               ("sun", sun_step, sun, shard_sun))[
                :2 if timing else 0]:
            # A warm-up step, then `timing` steps timed on the host clock
            # (every rank steps together), then as many with each collective
            # timed after the device's queued work: its share of the step.
            key = jax_random.key(spec["seed"] + 2)
            batch = shard(host)
            if shard_state is not None:
                shard_state(state)
            torch.cuda.reset_peak_memory_stats()
            walls = {False: [], True: []}
            shares = []
            for timed in (None, False, True):
                for _ in range(1 if timed is None else timing):
                    step.reduce.timed, step.reduce.comm_s = bool(timed), 0.0
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    step(state, batch, key)
                    torch.cuda.synchronize()
                    if timed is not None:
                        walls[timed].append(time.perf_counter() - t0)
                    if timed:
                        shares.append(step.reduce.comm_s / walls[True][-1])
            res[f"{kind}_ms"] = 1e3 * statistics.median(walls[False])
            res[f"{kind}_ms_all"] = [1e3 * t for t in walls[False]]
            res[f"{kind}_comm_share"] = statistics.median(shares)
            res[f"{kind}_comm_ms"] = 1e3 * statistics.median(
                sh * t for sh, t in zip(shares, walls[True]))
            res[f"{kind}_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
            if shard_state is not None:
                res[f"{kind}_resident_bytes"] = state.fsdp.resident_bytes()
                pfsdp.unshard_state(state)
        res["seconds"] = time.perf_counter() - t_case
        out[case["name"]] = res
        if undo is not None:
            undo()
        del gan, sun
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    out["imported"] = sorted({m.split(".")[0] for m in sys.modules})
    return out


def fsdp_at_rest(case: dict, mesh, device) -> dict:
    """The at-rest bytes of a GAN and a sun state of DA case["at_rest"] =
    [h, w] sharded at case["fsdp"] over `mesh`: each state allocated on
    `device` and filled with normal draws (the bytes do not depend on the
    values), then sharded; per kind "{kind}_bytes" (this rank's tensors),
    "{kind}_replicated_bytes", "{kind}_plan_bytes" (`plan_bytes`' per rank)
    and on the card "{kind}_allocated" (the allocator's bytes after the
    sharding, the state alone) and "{kind}_peak" (with the whole state
    before)."""
    import gc

    import torch

    from skyhdr_torch.parallel import fsdp as pfsdp
    from skyhdr_torch.train.engine import empty_gan_state, empty_sun_state

    h, w = case["at_rest"]
    cfg = dp_config(case, h, w)
    out = {}
    for kind, make in (("gan", empty_gan_state), ("sun", empty_sun_state)):
        cuda = torch.device(device).type == "cuda"
        gc.collect()  # what earlier cases left in reference cycles
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        state = make(cfg, device)
        _fill_normal(state)
        plan = pfsdp.fsdp_plan(state, mesh, case["fsdp"])
        planned = pfsdp.plan_bytes(state, plan, mesh.data)
        out[f"{kind}_plan_bytes"] = planned["per_rank"]
        out[f"{kind}_replicated_bytes"] = planned["replicated"]
        pfsdp.make_shard_state(mesh, case["fsdp"])(state)
        out[f"{kind}_bytes"] = state.fsdp.resident_bytes()
        if cuda:
            out[f"{kind}_allocated"] = torch.cuda.memory_allocated() - base
            out[f"{kind}_peak"] = torch.cuda.max_memory_allocated() - base
        del state
    return out


def _fill_normal(state) -> None:
    """Every tensor of `state` drawn N(0, 1) (no loop variable outlives the
    call to keep a tensor alive)."""
    import torch

    from skyhdr_torch.parallel.fsdp import state_leaves

    with torch.no_grad():
        for _, _, t, _ in state_leaves(state):
            t.normal_()


def _state_bits(state) -> dict:
    """{Flax path: the tensor's bytes} of a replicated state, with its step
    (and Adam's count) under "step"."""
    import torch

    from skyhdr_torch.parallel.fsdp import state_leaves

    out = {path: t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy().tobytes()
           for path, _, t, _ in state_leaves(state)}
    out["step"] = (state.step, getattr(getattr(state, "opt", None), "count", None))
    return out


def fsdp_vs_dp(spec, case, cfg, mesh, trees, setup, dp_runs: dict, steps: int = 2) -> dict:
    """`steps` GAN steps and as many sun steps (the case's "kinds", default
    both) of the FSDP step (at the case's "fsdp" min_bytes) and of the DP
    step, each from the run's replicated seeded state with the keys
    seeded seed + 1, seed + 2, ...: under "{kind}_differ" the paths of the
    tensors (parameters, buffers, moments, master; "step") whose bits
    differ after unsharding, empty when the two are bit-equal; under
    "{kind}_resident" the sharded state's `resident` shapes after the
    steps, "{kind}_bytes" its at-rest bytes on this rank and
    "{kind}_replicated_bytes" the whole state's; "agree": every rank's
    unsharded states bit-equal. The DP runs are kept in `dp_runs` by
    setting, for the next case of the same setting."""
    import torch

    from skyhdr_torch.utils import jax_random
    from skyhdr_torch.parallel import dp as pdp
    from skyhdr_torch.parallel import fsdp as pfsdp

    banks, vgg, host = setup
    device = spec["device"]
    makers = {
        "gan": (lambda: pdp.make_parallel_gan_train_step(cfg, banks, vgg, mesh),
                lambda: pfsdp.make_fsdp_gan_train_step(cfg, banks, vgg, mesh,
                                                       min_bytes=case["fsdp"])),
        "sun": (lambda: pdp.make_parallel_sun_train_step(cfg, banks, mesh),
                lambda: pfsdp.make_fsdp_sun_train_step(cfg, banks, mesh, case["fsdp"]))}
    setting = repr((case.get("knobs"), case.get("compute")))

    def steps_of(step, shard, state):
        for i in range(steps):
            state, _ = step(state, shard(host), jax_random.key(spec["seed"] + 1 + i))
        return state

    out = {"agree": True}
    for kind in case.get("kinds", ("gan", "sun")):
        make_dp, make_fsdp = makers[kind]
        fresh = lambda: pdp.replicate_state(
            _dp_states(cfg, trees, device)[0 if kind == "gan" else 1], mesh)
        if (setting, kind) not in dp_runs:
            step, shard = make_dp()
            dp_runs[setting, kind] = _state_bits(steps_of(step, shard, fresh()))
        step, shard_state, shard = make_fsdp()
        state = steps_of(step, shard, shard_state(fresh()))
        out[f"{kind}_resident"] = state.fsdp.resident()
        out[f"{kind}_bytes"] = state.fsdp.resident_bytes()
        pfsdp.unshard_state(state)
        out["agree"] = out["agree"] and pdp.replicas_agree(state, mesh)
        bits = _state_bits(state)
        out[f"{kind}_replicated_bytes"] = sum(len(v) for k, v in bits.items() if k != "step")
        want = dp_runs[setting, kind]
        out[f"{kind}_differ"] = sorted(k for k in set(bits) | set(want)
                                       if bits.get(k) != want.get(k))
    return out


class DPRanks:
    """`spec["world"]` processes of `dp_rank` (this file's `dp-rank`
    command; `spatial_rank` for a spec with "job": "spatial"), started together, their init through a file under `workdir`
    unless `spec` names another `init_method`; the caller may work while
    they run. `results(timeout_s)` waits: [each rank's results]; a rank
    that fails or outlives the timeout stops every rank and raises. Leaving
    the `with` block stops any rank still running."""

    def __init__(self, spec: dict, workdir: str):
        import json
        import subprocess

        spec = dict(spec)
        spec.setdefault("init_method", "file://" + os.path.join(workdir, "dp_init"))
        self.workdir, self.world = workdir, spec["world"]
        path = os.path.join(workdir, "dp_spec.json")
        with open(path, "w") as f:
            json.dump(spec, f)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        self.logs = [open(os.path.join(workdir, f"dp_rank{r}.log"), "w+")
                     for r in range(self.world)]
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "dp-rank", path, str(r)], cwd=ROOT,
            env=env, stdout=self.logs[r], stderr=subprocess.STDOUT) for r in range(self.world)]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()

    def stop(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in self.logs:
            f.close()

    def results(self, timeout_s: float = 300.0) -> list:
        import pickle
        import time

        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p in self.procs):
            if time.monotonic() > deadline or any(p.poll() not in (None, 0) for p in self.procs):
                break
            time.sleep(0.05)
        alive = [r for r, p in enumerate(self.procs) if p.poll() is None]
        failed = [r for r, p in enumerate(self.procs) if p.poll() not in (None, 0)]
        if alive or failed:
            tails = []
            for r in failed or alive:
                self.logs[r].flush()
                self.logs[r].seek(0)
                tails.append(f"rank {r} (exit {self.procs[r].poll()}):\n"
                             + self.logs[r].read()[-3000:])
            self.stop()
            raise RuntimeError(f"data-parallel ranks {'timed out' if alive else 'failed'}:\n"
                               + "\n".join(tails))
        out = []
        for r in range(self.world):
            with open(os.path.join(self.workdir, f"dp_rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def run_dp_ranks(spec: dict, workdir: str, timeout_s: float = 300.0) -> list:
    """`DPRanks(spec, workdir).results(timeout_s)`, the ranks stopped after."""
    with DPRanks(spec, workdir) as ranks:
        return ranks.results(timeout_s)


def spatial_inputs(case: dict):
    """The global inputs of a width-ring case, from numpy seeded
    `case["seed"]`: x [b, h, w, c] N(0, 1) and, for "op": "conv", a kernel
    [k, k, c, f] and a bias [f]; for "op": "da", a kernel [k*k*c, f] and a
    bias [f] (N(0, 1) x 0.2 and N(0, 1))."""
    rng = np.random.default_rng(case["seed"])
    b, h, w, c = case["shape"]
    k, f = case["k"], case["f"]
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    kshape = (k, k, c, f) if case["op"] == "conv" else (k * k * c, f)
    kernel = (rng.normal(size=kshape) * 0.2).astype(np.float32)
    return x, kernel, rng.normal(size=(f,)).astype(np.float32)


def spatial_rank(spec: dict, rank: int) -> dict:
    """One rank of a width-ring run (`spec["job"] == "spatial"`; a process
    of `DPRanks`): joins the group, makes the (spec["data"],
    spec["width"]) mesh and per case of `spec["cases"]` runs
    `ring_conv2d` ("op": "conv", its "padding") or `ring_deformable_conv2d`
    ("op": "da", its "k", "dilation", "force_gather") on its rows and width
    columns of `spatial_inputs(case)` (in `case["dtype"]`, default
    float32). Returns {case name: {"out": its block as float32 numpy, "mode"
    and "halo": `ring_da_plan`'s, "launches": the K1/K5 launches of the
    call}; on the card also "plain" (the same op with the plain DA forward
    on the extended shard) and "whole" (K1/K5 on the whole panorama, the
    rank's columns)}, with "imported" and the mesh's coordinates."""
    import torch
    import torch.nn.functional as F

    from skyhdr_torch.parallel import spatial
    from skyhdr_torch.parallel.mesh import batch_sharding

    mesh = _rank_setup(spec, rank)
    device = spec["device"]
    from skyhdr_torch.ops.kernels import deform_conv as dc

    place = batch_sharding(mesh, shard_width=True)
    out = {"coords": (mesh.data_index, mesh.width_index)}
    for case in spec["cases"]:
        dtype = getattr(torch, case.get("dtype", "float32"))
        x, kernel, bias = (torch.from_numpy(a).to(device) for a in spatial_inputs(case))
        xl = place(x).to(dtype).contiguous()
        kernel, bias = kernel.to(dtype), bias.to(dtype)
        res = {}
        dc.K1_LAUNCHES = dc.K5_LAUNCHES = 0
        if case["op"] == "conv":
            padding = case.get("padding", "cyclic")
            got = spatial.ring_conv2d(xl, kernel, bias, mesh=mesh, padding=padding)
            if xl.is_cuda:
                # F.conv2d on the whole panorama, its seam padded the same way.
                full = spatial._gather_width(xl, mesh)
                p = (kernel.shape[1] - 1) // 2
                wrap = (torch.cat([full[:, :, -p:], full, full[:, :, :p]], dim=2)
                        if padding == "cyclic" else F.pad(full, (0, 0, p, p)))
                ph = (kernel.shape[0] - 1) // 2
                want = F.conv2d(F.pad(wrap, (0, 0, 0, 0, ph, ph)).permute(0, 3, 1, 2),
                                kernel.permute(3, 2, 0, 1), bias).permute(0, 2, 3, 1)
                wl = xl.shape[2]
                want = want[:, :, mesh.width_index * wl:(mesh.width_index + 1) * wl]
                gap = (got - want).abs().max().item()
                res.update(err_plain=gap / want.abs().max().item(), max_abs_err=gap)
        else:
            geom = dict(kernel_size=case["k"], dilation_rate=case.get("dilation", 1))
            _, h, wl, _ = xl.shape
            res["mode"], res["halo"] = spatial.ring_da_plan(h, wl * mesh.width, wl, **geom)
            got = spatial.ring_deformable_conv2d(xl, kernel, bias, mesh=mesh,
                                                 force_gather=case.get("force_gather", False),
                                                 **geom)
            res["launches"] = {"K1": dc.K1_LAUNCHES, "K5": dc.K5_LAUNCHES}
            if xl.is_cuda:
                res.update(_ring_checks(spatial, dc, xl, kernel, bias, got, mesh, res, geom,
                                        case.get("force_gather", False)))
        if not got.is_cuda:
            res["out"] = got.float().numpy()
        out[case["name"]] = res
    dist = torch.distributed
    dist.barrier()
    dist.destroy_process_group()
    out["imported"] = sorted({m.split(".")[0] for m in sys.modules})
    return out


def _ring_checks(spatial, dc, xl, kernel, bias, got, mesh, res, geom, force_gather) -> dict:
    """On the card: a ring DA conv's block `got` against its plain version
    (the gather form on the extended shard, or of the whole panorama where
    the whole panorama was gathered) and against K1/K5 on the whole
    panorama: the largest error relative to the plain version's largest
    value ("err_plain"), the largest absolute one ("max_abs_err"), and
    whether the block is the whole panorama's bit for bit
    ("whole_equal")."""
    import torch

    wl = xl.shape[2]
    w = wl * mesh.width
    cols = slice(mesh.width_index * wl, (mesh.width_index + 1) * wl)
    full = spatial._gather_width(xl, mesh)
    if force_gather or res["mode"] == "gather":
        plain = dc.da_conv_forward_ref(full, kernel, bias, **geom)[:, :, cols]
    else:
        left, right = spatial._exchange_halos(xl, res["halo"], mesh)
        plain = dc.da_conv_forward_ring_ref(torch.cat([left, xl, right], dim=2), kernel, bias,
                                            w=w, halo=res["halo"], **geom)
    whole = (dc.da_conv_forward_k1(full, kernel, bias, dilation_rate=geom["dilation_rate"])
             if geom["kernel_size"] == 3 else dc.da_conv_forward_k5(full, kernel, bias, **geom))
    gap = (got.float() - plain.float()).abs().max().item()
    return {"err_plain": gap / plain.float().abs().max().item(), "max_abs_err": gap,
            "whole_equal": bool(torch.equal(got, whole[:, :, cols]))}


# ---------------------------------------------------------------------------
# The width-sharded GAN step: `skyhdr`'s shard_width=True against the port's
# ---------------------------------------------------------------------------

WIDTH_FIXTURE = os.path.join(ROOT, "tests", "fixtures", "torch_golden_width_16x64.npz")
# `skyhdr`'s runs of the width golden at 16x64 b4 f32: (key prefix, (data,
# width) mesh, use_da_conv, FSDP min_bytes or None for the DP step).
WIDTH_RUNS = (("da_", (1, 2), True, None), ("plain_", (1, 2), False, None),
              ("fsdp_", (2, 2), True, 1 << 20))
WIDTH_BATCH = 4
# The faults of a width-sharded step (`apply_width_fault`): the DA convs'
# weight gradients left per rank (not summed over the width ring).
WIDTH_FAULTS = ("dk_not_width_summed",)
# A width-sharded step against the port's single-process step on the same
# batch and key seed (2 gloo ranks at 16x64 b4 f32, and 4 under
# FSDP): `DP_RTOL`'s float32 class, but the moments, whose per-leaf
# relative L1 gaps reach 2.6e-4 at DA and with plain convs (the sums over
# the ring reorder more of the step than the data-parallel all-reduce
# does: every InstanceNorm, Dense over a map and loss); a DA kernel's
# gradient left unsummed moves its moments by more than 0.3.
WIDTH_RTOL = dict(DP_RTOL["float32"], moments=1e-3)
# The width step on a ring of one process (`ring_of_one`) against the
# single-process step: its metrics differ by rounding alone (in float64
# the generator's losses agree to 1e-15), 1.3e-5 at worst (the adversarial
# loss) at 16x64 b4 on the CPU.
WIDTH_ONE_RTOL = dict(WIDTH_RTOL, metrics=3e-5)
# The faults of the width-aware ops (`width_ops_rank`), each on the op it
# breaks: InstanceNorm's statistics over the shard, the halos' gradients
# not sent back, the sun-pose fc1 not summed over the ring, the VALID conv
# without its right halo, the degradation's noise drawn at the shard's
# width.
WIDTH_OP_FAULTS = {"in_local_stats": "in", "halo_grad_dropped": "conv_k3s1",
                   "fc1_not_reduced": "spatial_dense", "valid_no_right_halo": "valid_k4",
                   "noise_per_shard": "degrade"}


def width_config(case: dict, h: int = H, w: int = W, batch: int = WIDTH_BATCH):
    """The port's Config of a width case: `dp_config`'s, with the case's
    `use_da_conv` (default True)."""
    import dataclasses

    cfg = dp_config(case, h, w, batch)
    return cfg.replace(model=dataclasses.replace(cfg.model,
                                                 use_da_conv=case.get("use_da_conv", True)))


def make_width_golden(seed: int = 0) -> dict:
    """One GAN step of `skyhdr`'s width-sharded steps (`shard_width=True`)
    on the virtual CPU devices at 16x64 b4 f32 (`WIDTH_RUNS`: the DP step
    on a (1, 2) mesh at DA k=3 (the XLA path) and with plain convs, the
    FSDP step on a (2, 2) mesh at DA k=3, min_bytes 1 MiB), from the port's
    seeded weights on `dp_batch(seed, 4)` and the key seed + 1. Keys: the
    batch, the JAX-degraded global `hdr_t` / `ldr` / `sunpose_gt`, and per
    run under its prefix `_train_entries`' GAN keys, the gradients
    recovered from the RMSprop moments (`rmsprop_grads`, "gan_grad_digests")
    and the metrics of `skyhdr`'s single-device step on the same batch and
    key ("single_gan_metrics")."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from skyhdr.config import Config, DataConfig, ModelConfig
    from skyhdr.data.degradation import make_banks
    from skyhdr.models.vgg16 import random_vgg16_weights
    from skyhdr.parallel import fsdp
    from skyhdr.parallel.dp import make_parallel_gan_train_step
    from skyhdr.parallel.mesh import make_mesh
    from skyhdr.train import engine
    from skyhdr.utils.io import get_exposure_lists, make_synthetic_dorf
    from skyhdr_torch.utils.transplant import init_gan_vars, tree_digest

    if len(jax.devices()) < 4:
        raise RuntimeError("the width golden needs 4 JAX devices: set XLA_FLAGS="
                           "--xla_force_host_platform_device_count=8 before JAX starts")
    banks = make_banks(make_synthetic_dorf(175, 1024), get_exposure_lists()[0])
    host = dp_batch(seed, WIDTH_BATCH)
    batch = {k: jnp.asarray(v) for k, v in host.items()}
    key = jax.random.PRNGKey(seed + 1)
    vgg = random_vgg16_weights()
    out = {"seed": np.int64(seed), **{k: np.asarray(v) for k, v in host.items()}}
    for prefix, (data, width), use_da, min_bytes in WIDTH_RUNS:
        tcfg = golden_config(use_da_conv=use_da)
        cfg = Config(model=ModelConfig(**vars(tcfg.model)),
                     data=DataConfig(batch_size=WIDTH_BATCH))
        lr = cfg.train.learning_rate
        gv, sv, dv = init_gan_vars(tcfg, seed)
        if "hdr_t" not in out:
            hdr_t, ldr = engine._degrade(cfg, banks, key, batch["hdr"])
            out.update(hdr_t=np.asarray(hdr_t), ldr=np.asarray(ldr), sunpose_gt=np.asarray(
                engine._sunpose_gt_from_elevation(cfg, batch["elevation"])))
        mesh = make_mesh(data=data, width=width)
        if min_bytes is None:
            step, shard = make_parallel_gan_train_step(cfg, banks, vgg, mesh, shard_width=True)
            place = lambda s: s
        else:
            step, place, shard = fsdp.make_fsdp_gan_train_step(
                cfg, banks, vgg, mesh, shard_width=True, min_bytes=min_bytes)
        new, metrics = step(place(_jax_gan_state(engine, gv, sv, dv, lr)), shard(batch), key)
        params, _, entries = _gan_entries(gv, sv, dv, new, metrics)
        old = {"gen": gv["params"], "sun": sv["params"], "disc": dv["params"]}
        _, entries["gan_grad_digests"] = grad_digests(rmsprop_grads(entries.pop("nu"), params,
                                                                    old))
        _, single = jax.jit(engine.make_gan_train_step(cfg, banks, vgg, jit=False))(
            _jax_gan_state(engine, gv, sv, dv, lr), batch, key)
        entries["single_gan_metrics"] = _metric_entries("gan", single)["gan_metrics"]
        entries["weights_digest"] = np.float64(tree_digest({"gen": gv, "sun": sv, "disc": dv}))
        out.update({prefix + k: v for k, v in entries.items()})
    return out


def width_fixture_run(stored, prefix: str) -> dict:
    """The stored run of `prefix` ("da_", "plain_", "fsdp_") under the train
    golden's key names (with the batch's)."""
    n = len(prefix)
    return {**{k[n:]: v for k, v in stored.items() if k.startswith(prefix)},
            **{k: stored[k] for k in ("hdr_t", "ldr", "sunpose_gt")}}


# A step's gradient digests (sum g, sum |g| per leaf, recovered from the
# moments) against `skyhdr`'s: relative to the leaf's sum |g|, as the update
# digests; leaves of zero gradient in exact arithmetic (float noise) are
# skipped, as `compare_train_golden` skips them. The port's width-sharded
# steps on the CPU reach 6.3e-5 (DA), 8.4e-5 (FSDP) and 8.8e-4 (plain
# convs) of it.
WIDTH_GRAD_RTOL = 2e-3


def compare_grad_digests(stored, got, rtol: float = WIDTH_GRAD_RTOL):
    """(failures, worst) of the GAN gradient digests of `got` against
    `stored`'s (`make_width_golden`)."""
    gmax = stored["gan_param_gmax"]
    fails, worst = [], 0.0
    for path, g, w, m in zip(stored["gan_param_paths"], got["gan_grad_digests"],
                             stored["gan_grad_digests"], gmax):
        if m <= 1e-5 * gmax.max():
            continue
        e = float(np.max(np.abs(g - w)) / max(w[1], 1e-30))
        worst = max(worst, e)
        if not e <= rtol:
            fails.append(f"gradient {path}: digests {g} vs {w}")
    return fails, worst


def apply_width_fault(fault: str):
    """Plant one of WIDTH_FAULTS in this process (a rank's) and return the
    function that takes it out: every DA conv's kernel gradient taken as
    the rank's own partial (its columns' terms), not summed over the width
    ring with the other gradients."""
    from skyhdr_torch.ops import distortion
    from skyhdr_torch.parallel import dp

    if fault != "dk_not_width_summed":
        raise ValueError(f"unknown fault {fault!r}")
    init, grads = distortion.DAConv.__init__, dp.BatchReduce.grads
    kernels = set()

    def da_init(self, *a, **kw):
        init(self, *a, **kw)
        kernels.add(id(self.kernel))

    def partial_dk(self, gs, params=None):
        local = list(gs)
        reduced = grads(self, gs, params)
        return [g if id(p) in kernels else r for g, r, p in zip(local, reduced, params)]

    distortion.DAConv.__init__, dp.BatchReduce.grads = da_init, partial_dk

    def undo():
        distortion.DAConv.__init__, dp.BatchReduce.grads = init, grads
    return undo


def _width_trees(spec, use_da_conv: bool):
    """The seeded weights of a width run's config: the file the parent wrote
    (`spec["weights"]` at DA, `spec["weights_plain"]` with plain convs), or
    a draw."""
    import pickle

    from skyhdr_torch.utils.transplant import init_gan_vars

    path = spec.get("weights" if use_da_conv else "weights_plain")
    if path:
        with open(path, "rb") as f:
            return pickle.load(f)
    return init_gan_vars(width_config({"use_da_conv": use_da_conv}, spec["h"], spec["w"],
                                      spec["batch"]), spec["seed"])


def _gan_state(cfg, trees, device):
    from skyhdr_torch.train.engine import empty_gan_state, load_weights

    gan = empty_gan_state(cfg, device)
    load_weights(gan, trees)
    return gan


def width_reference(spec: dict, case: dict, trees=None, fixture=None) -> dict:
    """The port's single-process GAN step of a width case on the whole batch
    (`gan_step_digests`): through the degradation from the key
    the ranks use, or on `fixture`'s stored JAX-degraded inputs."""
    import torch

    from skyhdr_torch.utils import jax_random
    from skyhdr_torch.train.engine import make_gan_train_step

    cfg = width_config(case, spec["h"], spec["w"], spec["batch"])
    banks, vgg, host = _dp_setup(spec)
    device = spec["device"]
    if trees is None:
        trees = _width_trees(spec, case.get("use_da_conv", True))
    step = make_gan_train_step(cfg, banks, vgg)
    if fixture is not None:
        rows = [torch.from_numpy(np.asarray(fixture[k])).to(device)
                for k in ("hdr_t", "ldr", "sunpose_gt")]
        return gan_step_digests(_gan_state(cfg, trees, device), lambda s: step.train_on(s, *rows))
    batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
    key = jax_random.key(spec["seed"] + 1)
    return gan_step_digests(_gan_state(cfg, trees, device), lambda s: step(s, batch, key))


def _rank_setup(spec, rank):
    """A rank process's setup: its threads, the card's TF32 off, cuBLAS
    ready for deterministic algorithms where the spec or a case asks for
    them, the process group; returns the (spec["data"], spec["width"])
    mesh (default: every process over `data`)."""
    import torch

    from skyhdr_torch.parallel.mesh import initialize_distributed, make_mesh

    torch.set_num_threads(spec.get("threads", 1))
    device = spec["device"]
    if device.startswith("cuda"):
        torch.cuda.set_device(torch.device(device).index or 0)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if spec.get("deterministic") or any(c.get("deterministic") for c in spec["cases"]):
        # cuBLAS reads this before its first handle.
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    initialize_distributed(spec["init_method"], spec["world"], rank, device,
                           backend=spec.get("backend"))
    return make_mesh(spec.get("data", 0), spec.get("width", 1))


def width_rank(spec: dict, rank: int) -> dict:
    """One rank of a width-sharded run (`spec["job"] == "width"`, a process
    of `DPRanks`) on the (spec["data"], spec["width"]) mesh: per case of
    `spec["cases"]` the GAN state from the run's seeded weights (the case's
    "use_da_conv"), replicated from rank 0, and one step of
    `make_parallel_gan_train_step(..., shard_width=True)` (or with "fsdp":
    min_bytes `make_fsdp_gan_train_step`'s: sharded, stepped, unsharded;
    with "shard_width": False the batch over `data` alone; with
    "ring_of_one" on a mesh of width 1, the width context on a ring of
    one) on its block: of `spec["fixture"]`'s stored JAX-degraded inputs ("path":
    "fixture"; its rows and columns of hdr_t and ldr, its rows of
    sunpose_gt) or of `dp_batch` through the degradation, the generator
    seeded seed + 1 ("path": "batch"); a case's "fault" is one of
    WIDTH_FAULTS. Returns {case: `gan_step_digests` + "agree" (every rank's
    state bit-equal after the step) + "launches" (K1-K3 of the step, on the
    card) + "width_context" (whether the step ran on width shards)}; with "timing" (a number of steps, on the card) also the step's
    ms, the collectives' share and "act_peak_gib", the step's peak device
    memory above what was allocated before it; with `spec["single"]`
    whether the single-process step in this process gives the same bits
    (NCCL at world size 1 under deterministic algorithms). With
    `spec["ring_kernels"]` (on the card) also `ring_kernel_checks`. Under
    "imported" the top-level modules the rank imported."""
    import statistics
    import time

    import torch

    from skyhdr_torch.utils import jax_random
    from skyhdr_torch.parallel import dp as pdp
    from skyhdr_torch.parallel import fsdp as pfsdp
    from skyhdr_torch.parallel.mesh import batch_sharding, vector_sharding

    mesh = _rank_setup(spec, rank)
    torch.use_deterministic_algorithms(bool(spec.get("deterministic")), warn_only=True)
    device = spec["device"]
    banks, vgg, host = _dp_setup(spec)
    dc = None
    if device.startswith("cuda"):
        from skyhdr_torch.ops.kernels import deform_conv as dc
    out = {"coords": (mesh.data_index, mesh.width_index)}
    rows = vector_sharding(mesh)
    for case in spec["cases"]:
        t_case = time.perf_counter()
        shard_width = case.get("shard_width", True)
        cols = batch_sharding(mesh, shard_width)
        undo = apply_width_fault(case["fault"]) if case.get("fault") else None
        cfg = width_config(case, spec["h"], spec["w"], spec["batch"])
        trees = _width_trees(spec, case.get("use_da_conv", True))
        gan = pdp.replicate_state(_gan_state(cfg, trees, device), mesh)
        min_bytes = case.get("fsdp")
        one = bool(case.get("ring_of_one"))
        if min_bytes is None:
            step, shard = pdp.make_parallel_gan_train_step(cfg, banks, vgg, mesh,
                                                           shard_width=shard_width,
                                                           ring_of_one=one)
            shard_state = None
        else:
            step, shard_state, shard = pfsdp.make_fsdp_gan_train_step(
                cfg, banks, vgg, mesh, shard_width=shard_width, min_bytes=min_bytes,
                ring_of_one=one)
        launches = {}

        def run(state):
            if dc is not None:
                for k in ("K1", "K2", "K3"):
                    setattr(dc, f"{k}_LAUNCHES", 0)
            if shard_state is not None:
                state = shard_state(state)
            if case.get("path") == "fixture":
                with np.load(spec["fixture"]) as f:
                    block = [torch.from_numpy(cols(f[k])).to(device) for k in ("hdr_t", "ldr")]
                    block.append(torch.from_numpy(rows(f["sunpose_gt"])).to(device))
                state, metrics = step.train_on(state, *block)
            else:
                key = jax_random.key(spec["seed"] + 1)
                state, metrics = step(state, shard(host), key)
            if dc is not None:
                launches.update({k: getattr(dc, f"{k}_LAUNCHES") for k in ("K1", "K2", "K3")})
            if shard_state is not None:
                pfsdp.unshard_state(state)
            return state, metrics

        res = gan_step_digests(gan, run)
        res["agree"] = pdp.replicas_agree(gan, mesh)
        res["launches"] = launches
        res["width_context"] = bool(step.reduce.ring)
        if spec.get("single"):
            ref = width_reference(spec, case, trees)
            res["single_equal"] = all(np.array_equal(ref[k], res[k]) for k in (
                "gan_metrics", "gan_param_digests", "gan_stat_digests", "gan_nu"))
        if case.get("timing"):
            # A warm-up step, then `timing` steps timed on the host clock
            # (every rank steps together), then as many with each collective
            # timed after the device's queued work: its share of the step.
            key = jax_random.key(spec["seed"] + 2)
            batch = shard(host)
            if shard_state is not None:
                shard_state(gan)
            walls, shares, peaks = {False: [], True: []}, [], []
            for timed in (None, False, True):
                for _ in range(1 if timed is None else case["timing"]):
                    step.reduce.timed, step.reduce.comm_s = bool(timed), 0.0
                    torch.cuda.synchronize()
                    base = torch.cuda.memory_allocated()
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.perf_counter()
                    step(gan, batch, key)
                    torch.cuda.synchronize()
                    peaks.append(torch.cuda.max_memory_allocated() - base)
                    if timed is not None:
                        walls[timed].append(time.perf_counter() - t0)
                    if timed:
                        shares.append(step.reduce.comm_s / walls[True][-1])
            res["gan_ms"] = 1e3 * statistics.median(walls[False])
            res["gan_ms_all"] = [1e3 * t for t in walls[False]]
            res["gan_comm_share"] = statistics.median(shares)
            res["gan_comm_ms"] = 1e3 * statistics.median(
                sh * t for sh, t in zip(shares, walls[True]))
            res["act_peak_gib"] = max(peaks) / 2**30
            if shard_state is not None:
                res["resident_bytes"] = gan.fsdp.resident_bytes()
                pfsdp.unshard_state(gan)
        res["seconds"] = time.perf_counter() - t_case
        out[case["name"]] = res
        if undo is not None:
            undo()
        del gan
    if spec.get("ring_kernels"):
        out["ring_kernels"] = ring_kernel_checks(spec["ring_kernels"], mesh, device)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    out["imported"] = sorted({m.split(".")[0] for m in sys.modules})
    return out


def ring_kernel_checks(cases, mesh, device) -> list:
    """On the card, per case {"name", "shape": [b, h, w, c] of the whole
    panorama, "f", "k", "seed"}: the rank's width shard of seeded inputs,
    extended by its ring halo through the real exchange, and its cotangent
    block: the ring backward kernels (K2/K3 at k = 3, K7/K6 otherwise)
    against their plain versions and against the whole-panorama kernels run
    with the cotangent zero outside this rank's columns (whose dx at the
    extended columns and whose dK are the ring kernels' own work): the
    largest error relative to the reference's largest value of each, and
    the launches of the ring kernels."""
    import torch

    from skyhdr_torch.ops.kernels import deform_conv as dc
    from skyhdr_torch.parallel import spatial

    rows = []
    for case in cases:
        b, h, w, c = case["shape"]
        k, f = case["k"], case["f"]
        rng = np.random.default_rng(case["seed"])
        x = torch.from_numpy(rng.normal(size=(b, h, w, c)).astype(np.float32)).to(device)
        kern = torch.from_numpy((rng.normal(size=(k * k * c, f)) * 0.2).astype(
            np.float32)).to(device)
        g = torch.from_numpy(rng.normal(size=(b, h, w, f)).astype(np.float32)).to(device)
        wl = w // mesh.width
        own = slice(mesh.width_index * wl, (mesh.width_index + 1) * wl)
        _, halo = spatial.ring_da_plan(h, w, wl, k)
        left, right = spatial._exchange_halos(x[:, :, own].contiguous(), halo, mesh)
        xe = torch.cat([left, x[:, :, own], right], dim=2).contiguous()
        gl = g[:, :, own].contiguous()
        geom = dict(w=w, halo=halo, kernel_size=k)
        for name in ("K1", "K2", "K3", "K5", "K6", "K7"):
            setattr(dc, f"{name}_LAUNCHES", 0)
        dx = dc.da_conv_dx_ring(gl, kern, x_shape=tuple(xe.shape), **geom)
        dk = dc.da_conv_dk_ring(xe, gl, **geom)
        launched = {n: getattr(dc, f"{n}_LAUNCHES") for n in ("K2", "K3", "K6", "K7")}
        dx_plain = dc.da_conv_dx_ring_ref(gl, kern, x_shape=tuple(xe.shape), **geom)
        dk_plain = dc.da_conv_dk_ring_ref(xe, gl, **geom)
        g_own = torch.zeros_like(g)
        g_own[:, :, own] = gl
        if k == 3:
            dx_whole = dc.da_conv_dx_k2(g_own, kern, x_shape=tuple(x.shape))
            dk_whole = dc.da_conv_dk_k3(x, g_own)
        else:
            dx_whole = dc.da_conv_dx_k7(g_own, kern, x_shape=tuple(x.shape), kernel_size=k)
            dk_whole = dc.da_conv_dk_k6(x, g_own, kernel_size=k)
        ext = [(mesh.width_index * wl - halo + j) % w for j in range(wl + 2 * halo)]
        dx_whole = dx_whole[:, :, ext]
        rel = lambda a, r: ((a - r).abs().max() / r.abs().max()).item()
        rows.append({"name": case["name"], "halo": halo, "launches": launched,
                     "dx_vs_plain": rel(dx, dx_plain), "dk_vs_plain": rel(dk, dk_plain),
                     "dx_vs_whole": rel(dx, dx_whole), "dk_vs_whole": rel(dk, dk_whole),
                     "dx_max_abs": (dx - dx_plain).abs().max().item(),
                     "dk_max_abs": (dk - dk_plain).abs().max().item()})
    return rows


def _width_op_case(case):
    """The module and global inputs of a width op case: (fn, x, params,
    cotangent kind) with fn(x) the op on whole or shard inputs, x the global
    input [b, h, w, c] and params the module's parameters (seeded)."""
    import torch

    from skyhdr_torch.models import layers
    from skyhdr_torch.models.vgg16 import perceptual_l1, random_vgg16_weights, vgg_constants
    from skyhdr_torch.ops.distortion import DAConv
    from skyhdr_torch.ops.dog import dog_l1_loss
    from skyhdr_torch.ops.resize import resize_bilinear
    from skyhdr_torch.train import losses

    rng = np.random.default_rng(case["seed"])
    b, h, w, c = case["shape"]
    x = torch.from_numpy(rng.normal(size=(b, h, w, c)).astype(np.float32))
    op, f = case["op"], case.get("f", 4)
    module, kind = None, "sharded"
    if op == "conv":
        module = layers.Conv2D(c, f, case["k"], case["s"])
        fn = lambda t: module(t, case.get("padding", "SAME"))
    elif op == "in":
        module = layers.InstanceNorm(c, fuse=case.get("fuse", False))
        fn = lambda t: module(t, act="lrelu01")
    elif op == "bn":
        module = layers.BatchNorm(c)
        fn = lambda t: module(t, train=True)
    elif op == "spatial_dense":
        module = layers.SpatialDense(h * w * c, f)
        fn, kind = module, "whole"
    elif op == "map_dense":
        module = layers.Dense(h * w * c, 1)
        fn, kind = (lambda t: layers.map_dense(module, t)), "whole"
    elif op == "resize":
        fn = lambda t: resize_bilinear(t, (h * case["scale"], w * case["scale"]))
    elif op == "pool":
        fn = layers.maxpool2
    elif op == "da":
        module = DAConv(c, f, case["k"])
        fn = module
        if case.get("force_gather"):
            from skyhdr_torch.ops import width as wctx
            from skyhdr_torch.parallel.spatial import ring_deformable_conv2d

            def fn(t):
                ring = wctx.current()
                if ring is None:
                    return module(t)
                return ring_deformable_conv2d(t, module.kernel, module.bias, mesh=ring.mesh,
                                              kernel_size=case["k"], force_gather=True)
    elif op == "perceptual":
        consts = vgg_constants(random_vgg16_weights(), "cpu")
        target = torch.from_numpy(rng.uniform(size=(b, h, w, 3)).astype(np.float32))
        x = torch.from_numpy(rng.uniform(size=(b, h, w, 3)).astype(np.float32))
        fn, kind = (lambda t, y=target: perceptual_l1(consts, t, _cols_like(y, t))), "share"
    elif op == "dog":
        target = torch.from_numpy(rng.uniform(size=(b, h, w, 3)).astype(np.float32))
        fn, kind = (lambda t, y=target: dog_l1_loss(t, _cols_like(y, t))), "share"
    elif op == "l1":
        target = torch.from_numpy(rng.normal(size=(b, h, w, c)).astype(np.float32))
        fn, kind = (lambda t, y=target: losses.l1_loss(t, _cols_like(y, t))), "share"
    elif op == "lsgan":
        fn, kind = (lambda t: losses.lsgan_gen_loss(t)), "share"
    elif op == "disc_lsgan":
        # The discriminator on concat(ldr, hdr) = x's two halves, its logits
        # through the LSGAN loss over the whole logits' width.
        from skyhdr_torch.models.discriminator import Discriminator

        module = Discriminator(c // 2)
        fn = lambda t: losses.lsgan_gen_loss(module(t[..., :c // 2], t[..., c // 2:], train=True),
                                             module.logits_width(h, w))
        kind = "share"
    else:
        raise ValueError(f"unknown op {op!r}")
    params = []
    if module is not None:
        with torch.no_grad():
            for p in module.parameters():
                p.copy_(torch.from_numpy(rng.normal(size=tuple(p.shape)).astype(np.float32)
                                         * case.get("scale_w", 0.2)))
            for name, buf in module.named_buffers():
                buf.copy_(torch.from_numpy(np.abs(rng.normal(size=tuple(buf.shape))).astype(
                    np.float32)))
        params = list(module.parameters())
    return fn, x, params, kind, module


def _cols_like(y, t):
    """y's columns that match the width shard t (the whole y outside a width
    context)."""
    from skyhdr_torch.ops import width as wctx

    ring = wctx.current()
    return y if ring is None else y[:, :, ring.cols(y.shape[2])]


def width_op_whole(case) -> dict:
    """The whole-panorama op of a width op case in this process: {"out",
    "dx", "dparams"} as float64 numpy (the cotangent of `_op_cotangent`)."""
    import torch

    fn, x, params, kind, _ = _width_op_case(case)
    x = x.requires_grad_()
    out = fn(x)
    g = _op_cotangent(case, out, 1)
    grads = torch.autograd.grad(out, [x, *params], g, allow_unused=True)
    return {"out": out.detach().double().numpy(),
            "dx": None if grads[0] is None else grads[0].double().numpy(),
            "dparams": [None if d is None else d.double().numpy() for d in grads[1:]]}


def _op_cotangent(case, out, n: int, cols=None):
    """The seeded cotangent of an op's whole output (a width shard's block
    with `cols`; an output whole on every process split over the `n`
    processes; a loss share's cotangent 1)."""
    import torch

    if out.dim() == 0:
        return torch.ones_like(out)
    rng = np.random.default_rng(case["seed"] + 1000)
    shape = list(out.shape)
    if cols is not None:
        shape[2] = case["out_w"]
    g = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    if cols is not None:
        g = g[:, :, cols]
    return g / n


def width_ops_rank(spec: dict, rank: int) -> dict:
    """One rank of a width-op run (`spec["job"] == "width-ops"`) on a width
    ring of spec["width"]: per case of `spec["cases"]` the op on this
    rank's width shard of the global input, in the width context (and
    BatchNorm's batch reduction over every rank), and its gradients for
    the seeded cotangent's block. Returns {case: {"out" (the block, or the
    whole output of rank 0's, or the loss share), "dx" (the block's
    gradient), "dparams" (this rank's partial parameter gradients)} as
    float64 numpy}. A case with "fault" runs with one of
    WIDTH_OP_FAULTS planted."""
    import torch

    from skyhdr_torch.models.layers import batch_across
    from skyhdr_torch.parallel import dp as pdp
    from skyhdr_torch.parallel.spatial import WidthRing, width_across

    mesh = _rank_setup(spec, rank)
    ring = WidthRing(mesh)
    out = {}
    for case in spec["cases"]:
        undo = _apply_width_op_fault(case["fault"]) if case.get("fault") else None
        try:
            if case["op"] == "degrade":
                out[case["name"]] = _degrade_block(case, ring)
                continue
            fn, x, params, kind, _ = _width_op_case(case)
            xl = x[:, :, ring.cols(x.shape[2])].contiguous().requires_grad_()
            with width_across(ring), batch_across(pdp.BatchReduce(mesh, shard_width=True)):
                y = fn(xl)
                if kind == "sharded":
                    # The output columns of this rank: the shards' widths
                    # summed over the ring (the VALID conv's differ).
                    widths = [torch.zeros(1) for _ in range(mesh.width)]
                    torch.distributed.all_gather(widths, torch.tensor([float(y.shape[2])]))
                    starts = np.cumsum([0] + [int(v.item()) for v in widths])
                    case = dict(case, out_w=int(starts[-1]))
                    g = _op_cotangent(case, y, 1, slice(int(starts[mesh.width_index]),
                                                        int(starts[mesh.width_index + 1])))
                else:
                    g = _op_cotangent(case, y, mesh.width if kind == "whole" else 1)
                grads = torch.autograd.grad(y, [xl, *params], g, allow_unused=True)
            out[case["name"]] = {
                "out": y.detach().double().numpy(), "kind": kind,
                "dx": None if grads[0] is None else grads[0].double().numpy(),
                "dparams": [None if d is None else d.double().numpy() for d in grads[1:]]}
        finally:
            if undo is not None:
                undo()
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    out["imported"] = sorted({m.split(".")[0] for m in sys.modules})
    return out


def _degrade_block(case, ring) -> dict:
    """The degradation of this rank's width shard of a seeded HDR batch
    (`degrade_batch` in the width context from the key of
    case["seed"]): {"out": [hdr_t, ldr] blocks}."""
    import torch

    from skyhdr_torch.utils import jax_random
    from skyhdr_torch.data.degradation import degrade_batch, make_banks
    from skyhdr_torch.ops.width import width_across
    from skyhdr_torch.utils.io import get_exposure_lists, make_synthetic_dorf

    banks = make_banks(make_synthetic_dorf(16, 256), get_exposure_lists()[0], device="cpu")
    rng = np.random.default_rng(case["seed"])
    hdr = torch.from_numpy(rng.uniform(0, 2, size=case["shape"]).astype(np.float32))
    key = jax_random.key(case["seed"])
    if ring is None:
        return {"out": [t.double().numpy() for t in degrade_batch(key, hdr, banks)]}
    with width_across(ring):
        block = hdr[:, :, ring.cols(hdr.shape[2])]
        return {"out": [t.double().numpy() for t in degrade_batch(key, block, banks)],
                "kind": "degrade"}


def _apply_width_op_fault(fault: str):
    """Plant one of WIDTH_OP_FAULTS in this process; returns its undo."""
    from skyhdr_torch.data import degradation
    from skyhdr_torch.models import layers
    from skyhdr_torch.ops import width
    from skyhdr_torch.parallel import spatial

    patches = []
    if fault == "in_local_stats":
        # The sums of the shard alone, scaled as the ring's: local moments.
        patches.append((spatial.WidthRing, "sum", lambda self, t: t * self.n))
    elif fault == "fc1_not_reduced":
        patches.append((spatial.WidthRing, "sum", lambda self, t: t))
    elif fault == "halo_grad_dropped":
        def backward(ctx, g):
            lo, hi, ends, mesh, dim, w, nl, nr = ctx.args
            return g.narrow(dim, nl, w).clone(), None, None, None, None, None
        patches.append((spatial._Halo, "backward", staticmethod(backward)))
    elif fault == "valid_no_right_halo":
        halo = layers.width_halo
        patches.append((layers, "width_halo", lambda ring, x, k, s, padding="SAME", dim=2:
                        x if padding == "VALID" else halo(ring, x, k, s, padding, dim)))
    elif fault == "noise_per_shard":
        draw = degradation.draw_degradation
        patches += [(degradation, "shard_cols", lambda draws, cols: draws),
                    (degradation, "draw_degradation", lambda key, shape, banks, device=None: draw(
                        key, (*shape[:2], shape[2] // width.current().n, shape[3]), banks,
                        device))]
    else:
        raise ValueError(f"unknown fault {fault!r}")
    old = [(t, n, t.__dict__[n] if isinstance(t, type) else getattr(t, n)) for t, n, _ in patches]
    for t, n, v in patches:
        setattr(t, n, v)

    def undo():
        for t, n, v in old:
            setattr(t, n, v)
    return undo


def _dp_rank_main(spec_path: str, rank: str) -> None:
    import json
    import pickle

    with open(spec_path) as f:
        spec = json.load(f)
    job = {"spatial": spatial_rank, "width": width_rank, "width-ops": width_ops_rank}
    out = job.get(spec.get("job"), dp_rank)(spec, int(rank))
    with open(os.path.join(os.path.dirname(spec_path), f"dp_rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def compare_dp_steps(ref, got, rtol=None, kinds=("gan", "sun")):
    """Failures (a list of strings) of a data-parallel run's `step_digests`
    against `ref` (the single-process run's, or a stored fixture's), and
    the worst gaps: `compare_train_golden` (metrics, update digests,
    BatchNorm sums at `rtol`'s "metrics", "updates", "stats"; `rtol` a
    `DP_RTOL` entry, default its "float32") and, where
    both hold the moments, per leaf the relative L1 gap of the second
    moments (GAN) and of both of Adam's (sun) within "moments", but for the
    leaves whose gradient is zero in exact arithmetic (float noise, held
    by the update digests' bound)."""
    rtol = DP_RTOL["float32"] if rtol is None else rtol
    fails, worst = compare_train_golden(ref, got, rtol["metrics"], rtol["updates"],
                                        rtol["stats"], kinds)
    if "gan_nu" not in ref or rtol["moments"] is None:
        return fails, worst
    for kind, keys in (("gan", ("gan_nu",)), ("sun", ("sun_mu", "sun_nu"))):
        if kind not in kinds:
            continue
        paths, sizes = ref[f"{kind}_param_paths"], ref[f"{kind}_sizes"]
        gmax = ref[f"{kind}_param_gmax"]
        for key in keys:
            at, gap = 0, 0.0
            for path, n, g in zip(paths, sizes, gmax):
                a, b = (v[key][at:at + n].astype(np.float64) for v in (got, ref))
                at += n
                if g <= 1e-5 * gmax.max():
                    continue  # a zero-gradient leaf's float noise (`compare_train_golden`)
                e = float(np.abs(a - b).sum() / max(np.abs(b).sum(), 1e-30))
                gap = max(gap, e)
                if not e <= rtol["moments"]:
                    fails.append(f"{key} {path}: relative L1 gap {e:.3e}")
            worst[key] = gap
    return fails, worst


def in_fed_biases(paths) -> np.ndarray:
    """[n] bool: which leaves are the bias of a conv whose output goes
    straight into an InstanceNorm (`<prefix>/conv<s>/bias` beside a
    `<prefix>/norm<s>`, or a plain resize-deconv's `<prefix>/conv<s>/conv/
    bias`). The norm subtracts each channel's mean, so such a bias has
    exactly zero gradient; in float arithmetic both packages carry noise
    there, which bf16 makes large."""
    paths = [str(p) for p in paths]
    norms = {p.rsplit("/", 1)[0] for p in paths}
    out = []
    for p in paths:
        parts = p.split("/")
        if len(parts) >= 3 and parts[-2] == "conv" and parts[-3].startswith("conv"):
            parts = parts[:-2] + ["bias"]  # the resize-deconv's inner conv
        fed = (len(parts) >= 2 and parts[-1] == "bias" and parts[-2].startswith("conv")
               and "/".join(parts[:-2] + ["norm" + parts[-2][4:]]) in norms)
        out.append(fed)
    return np.array(out)


# The bf16 golden's tolerances (`bf16_tolerances`). One bf16 ulp is 2^-8 of
# a value. `skyhdr`'s own gap between its bf16 and its float32 steps on the
# same inputs (the fixture's "f32_..." values) is the size of the bf16
# effect on each quantity; a port that rounds where `skyhdr` rounds lands
# well inside it, a port that ignored the compute dtype lands on it. So
# each quantity is held to BF16_GAP_SHARE of its own gap: the float32
# port then fails (test_torch_train_bf16.py:test_bf16_golden_fails_a_float32_port).
BF16_GAP_SHARE = 0.5
# A quantity's own gap is taken at least BF16_FLOOR_SHARE of the median own
# gap of its class: a quantity whose own gap falls far below its class's
# got there by its terms' bf16 errors cancelling, which understates its
# bf16 noise (perceptual: VGG16's pool3 features 4.8e-3 from float32,
# relative L1, the loss 1.5e-5).
BF16_FLOOR_SHARE = 0.25
# Quantities that an amplifier puts outside this resolution, held to their
# class's largest own gap instead: SunRadNet, whose BatchNorm takes the
# statistics of two samples in the train step and divides by their spread
# (its outputs' maxima b_out and g_out, its gradients and running sums),
# and the sky decoder, whose gradient the perceptual loss dominates, routed
# through VGG16's bf16 max-pools (a feature rounded the other way moves a
# pool's gradient to another element). ROADMAP Queue 3 records them.
BF16_UNRESOLVED = ("gan metric b_out", "gan metric g_out", "gan gradient gen/sun/",
                   "gan gradient gen/conv1_f/", "gan gradient gen/conv2_f/",
                   "gan gradient gen/conv3_f/", "gan gradient gen/norm2_f/",
                   "gan gradient gen/norm3_f/", "batch_stats gen/sun/")


# The plain-conv bf16 golden (`use_da_conv=False`): its generator runs in
# bf16 (at DA it stays float32), and twelve bf16 trunk convs between
# InstanceNorms amplify a one-ulp rounding difference as far as bf16 itself
# moves the values: `skyhdr`'s own bf16 generator, fed its input times
# (1 + 2e-7 N(0, 1)), ends the trunk 1.2e-2 (of the max) from itself, its
# float32 run 1.1e-2. Its bf16 steps from weights perturbed by
# PLAIN_BF16_PERTURB (float32 noise: 2^-23 is 1.2e-7; the fixture's
# "pert<k>_..." values, PLAIN_BF16_PERTURB_DRAWS draws) move each GAN-step
# quantity a median 0.98 of its own bf16-vs-f32 gap
# (test_torch_train_plain.py: test_plain_bf16_generator_amplifies_f32_noise).
# So every GAN-step quantity (PLAIN_BF16_AMPLIFIED: the GAN train and eval
# metrics, gradients and BatchNorm sums) is held to its class bound, the
# largest of the class's own and perturbed gaps, times PLAIN_BF16_SPREAD,
# and left out of the median check: each of `skyhdr`'s perturbed draws,
# held to the bound of its own gap and the other draws, exceeds it by up to
# 1.52x (the sky decoder's last kernel gradient), the port's run by 1.02x.
# The sun step and the sun eval step, which run the sun-pose net alone,
# are held per quantity. ROADMAP Queue 3 records it.
PLAIN_BF16_AMPLIFIED = ("gan metric", "gan_eval metric", "gan gradient", "batch_stats")
PLAIN_BF16_PERTURB = 2e-7
PLAIN_BF16_PERTURB_DRAWS = 3
PLAIN_BF16_SPREAD = 2.0


def bf16_gaps(stored, values) -> list:
    """[(class, quantity, gap)] of `values` (a port's `port_eval_bf16` +
    `port_steps` keys, or the stored float32 steps') against the stored
    `skyhdr` bf16 values. Classes: each step's metrics (GAN, sun, GAN eval,
    sun eval; relative); per step the per-leaf gradient digests, kernels
    apart from the rest (the larger gap of sum g and sum |g|, relative to
    the leaf's sum |g|: a kernel's gradient sums products over the batch
    and every position, a norm's or a bias's one channel's cotangents); the
    BatchNorm running sums (relative to max(|sum|, 1e-2 sum |.|), as the
    float32 golden scales them: a sum that cancels is held to its terms'
    scale). The leaves of exactly zero gradient (`in_fed_biases`) are not
    in it."""
    rows = []
    for kind in ("gan", "sun", "gan_eval", "sun_eval"):
        want = stored[f"{kind}_metrics"]
        gaps = np.abs(values[f"{kind}_metrics"] - want) / np.abs(want)
        rows += [(f"{kind}_metrics", f"{kind} metric {n}", float(g))
                 for n, g in zip(stored[f"{kind}_metric_names"], gaps)]
    for kind in ("gan", "sun"):
        want = stored[f"{kind}_grad_digests"]
        gaps = (np.max(np.abs(values[f"{kind}_grad_digests"] - want), axis=1)
                / np.maximum(want[:, 1], 1e-30))
        for path, g, fed in zip(stored[f"{kind}_grad_paths"], gaps,
                                in_fed_biases(stored[f"{kind}_grad_paths"])):
            if not fed:
                cls = "kernel" if str(path).endswith("/kernel") else "other"
                rows.append((f"{kind}_{cls}_grads", f"{kind} gradient {path}", float(g)))
    want = stored["gan_stat_digests"]
    scale = np.maximum(np.abs(want), 1e-2 * stored["gan_stat_abs"])
    gaps = np.abs(values["gan_stat_digests"] - want) / np.maximum(scale, 1e-30)
    rows += [("gan_stats", f"batch_stats {p}", float(g))
             for p, g in zip(stored["gan_stat_paths"], gaps)]
    return rows


def bf16_own_gaps(stored) -> list:
    """`bf16_gaps` of `skyhdr`'s float32 steps stored in the fixture: the
    bf16 effect on each quantity."""
    return bf16_gaps(stored, {k[len("f32_"):]: v for k, v in stored.items()
                              if k.startswith("f32_")})


def bf16_pert_gaps(stored) -> list:
    """`bf16_gaps` of `skyhdr`'s bf16 steps from perturbed weights (the
    plain golden's "pert<k>_..." values), every draw's rows: how far float32
    noise moves each quantity of `skyhdr`'s own bf16 run; [] where the
    fixture has none."""
    rows = []
    for k in range(PLAIN_BF16_PERTURB_DRAWS):
        pert = {key[len(f"pert{k}_"):]: v for key, v in stored.items()
                if key.startswith(f"pert{k}_")}
        rows += bf16_gaps(stored, pert) if pert else []
    return rows


def bf16_tolerances(stored, resolved: bool = True, unresolved=BF16_UNRESOLVED) -> dict:
    """{quantity: tolerance} of the bf16 golden (`bf16_gaps`' quantities):
    BF16_GAP_SHARE of the quantity's own gap (`bf16_own_gaps`), the own gap
    taken at least BF16_FLOOR_SHARE of its class's median; a quantity whose
    name starts with one of `unresolved` (BF16_UNRESOLVED; the plain-conv
    golden's PLAIN_BF16_AMPLIFIED), or every quantity when not `resolved`,
    within its class's largest own gap (where the fixture holds perturbed
    draws, `bf16_pert_gaps`: the largest own or perturbed gap times
    PLAIN_BF16_SPREAD).

    `resolved=False` is the card's: there every layer rounds as on the CPU
    (chip_smoke.py: `bf16_layers`, one ulp), but the float32 sums run in
    other orders, so other elements round the other way, and the bf16
    sun-pose net amplifies such one-ulp differences into the sun metrics
    and gradients as far as `skyhdr`'s own bf16-vs-f32 gap
    (test_torch_train_bf16.py:test_one_ulp_roundings_move_the_bf16_sun_step).
    The CPU run, which rounds as XLA:CPU nearly everywhere, is what resolves
    the bf16 step quantity by quantity."""
    own = bf16_own_gaps(stored)
    pert = bf16_pert_gaps(stored)
    median, largest = {}, {}
    for cls in {c for c, _, _ in own}:
        gaps = [g for c, _, g in own if c == cls]
        median[cls] = float(np.median(gaps))
        largest[cls] = (max(gaps + [g for c, _, g in pert if c == cls]) * PLAIN_BF16_SPREAD
                        if pert else max(gaps))
    return {name: (largest[cls] if not resolved or name.startswith(tuple(unresolved))
                   else BF16_GAP_SHARE * max(g, BF16_FLOOR_SHARE * median[cls]))
            for cls, name, g in own}


def compare_train_golden_bf16(stored, port, resolved: bool = True, amplified=()):
    """Failures (a list of strings) of the port's `port_eval_bf16` and
    `port_steps` values against the stored `skyhdr` bf16 values at
    `bf16_tolerances(stored, resolved)`, and per class the largest gap and
    the largest gap as a share of its tolerance. A leaf of exactly zero
    gradient (`in_fed_biases`) is held to the optimizer's bound on |update|
    instead (3.17 lr for RMSprop, 1.01 lr for Adam's first step).

    Besides, the median over every quantity of its gap as a share of its own
    gap (`worst["median_of_own"]`) stays under BF16_GAP_SHARE in either
    mode: one-ulp differences carry a few quantities as far as their own
    gap, a run that computes in float32 carries all of them there.

    `amplified` (the plain-conv golden's PLAIN_BF16_AMPLIFIED): prefixes of
    the quantities that `skyhdr` itself moves as far as its own gap under
    float32 noise; they are held to their class bound (`bf16_tolerances`)
    in place of BF16_UNRESOLVED and left out of the median."""
    amplified = tuple(amplified)
    tol = bf16_tolerances(stored, resolved, amplified or BF16_UNRESOLVED)
    own = {name: g for _, name, g in bf16_own_gaps(stored)}
    fails, worst, shares = [], {}, []
    for cls, name, g in bf16_gaps(stored, port):
        worst[cls] = max(worst.get(cls, 0.0), g)
        worst[f"{cls}_of_tol"] = max(worst.get(f"{cls}_of_tol", 0.0), g / tol[name])
        if own[name] > 0 and not (amplified and name.startswith(amplified)):
            shares.append(g / own[name])
        if not g <= tol[name]:
            fails.append(f"{name}: gap {g:.3e}, tolerance {tol[name]:.3e}")
    worst["median_of_own"] = float(np.median(shares))
    if not worst["median_of_own"] <= BF16_GAP_SHARE:
        fails.append(f"median gap / own gap {worst['median_of_own']:.3f} over "
                     f"{len(shares)} quantities")
    for kind, lr_bound in (("gan", 3.17e-4), ("sun", 1.01e-4)):
        # The update digests run over the same sorted leaves as the gradients.
        paths = stored[f"{kind}_grad_paths"]
        for path, fed, umax in zip(paths, in_fed_biases(paths),
                                   port[f"{kind}_param_digests"][:, 2]):
            if fed and not umax <= lr_bound:
                fails.append(f"{kind} update {path}: max |update| {umax}")
    return fails, worst


def plain_bf16_adv(steps: int = 8, batch: int = 8, h: int = 32, w: int = 128,
                   seed: int = 0) -> dict:
    """The adversarial loss of `skyhdr` and of the port over `steps` GAN
    steps at plain convs, h x w, b`batch`, on the CPU, from the same seeded
    weights (`init_gan_vars`) and the same JAX-degraded inputs (synthetic
    skies, `tools/make_synth_dataset.synth_panorama`; step i's key is
    seed + 1 + i): {run: {metric: [per step]}} for `skyhdr` in bfloat16 and
    in float32 and the port in bfloat16. A record of whether `skyhdr`'s
    adv grows as the port's does on the card, not a gate."""
    import jax
    import jax.numpy as jnp
    import torch

    jax.config.update("jax_platforms", "cpu")
    from skyhdr.config import Config as JConfig, DataConfig as JData, ModelConfig as JModel
    from skyhdr.data.degradation import make_banks as jax_banks
    from skyhdr.models.vgg16 import random_vgg16_weights
    from skyhdr.train import engine
    from skyhdr.utils.io import get_exposure_lists, make_synthetic_dorf
    from skyhdr_torch.config import Config, DataConfig, ModelConfig
    from skyhdr_torch.data.degradation import make_banks as port_banks
    from skyhdr_torch.train import engine as tengine
    from skyhdr_torch.utils.transplant import init_gan_vars

    spec = importlib.util.spec_from_file_location(
        "make_synth_dataset", os.path.join(ROOT, "tools", "make_synth_dataset.py"))
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(steps):
        imgs, elev = zip(*(synth.synth_panorama(rng, h, w) for _ in range(batch)))
        batches.append({"hdr": jnp.asarray(np.stack(imgs)),
                        "elevation": jnp.asarray(np.array(elev, np.float32))})
    dorf, exposures = make_synthetic_dorf(175, 1024), get_exposure_lists()[0]
    banks = jax_banks(dorf, exposures)
    vgg = random_vgg16_weights()
    out = {}
    for dtype in ("bfloat16", "float32"):
        tcfg = Config(model=ModelConfig(im_height=h, im_width=w, compute_dtype=dtype),
                      data=DataConfig(batch_size=batch))
        cfg = JConfig(model=JModel(**vars(tcfg.model)), data=JData(batch_size=batch))
        gv, sv, dv = init_gan_vars(tcfg, seed)
        lr = cfg.train.learning_rate
        state = engine.GanState(
            gen_vars=gv, sun_vars=sv, disc_vars=dv,
            opt_gen=engine._rmsprop(lr).init((gv["params"], sv["params"])),
            opt_disc=engine._rmsprop(lr).init(dv["params"]),
            step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32))
        step = jax.jit(engine.make_gan_train_step(cfg, banks, vgg, jit=False))
        runs = {f"skyhdr_{dtype}": []}
        if dtype == "bfloat16":
            pstate = harness_gan_state(tcfg, seed, "cpu")
            pstep = tengine.make_gan_train_step(
                tcfg, port_banks(dorf, exposures, device="cpu"), vgg).train_on
            runs["port_bfloat16"] = []
        for i, b in enumerate(batches):
            key = jax.random.PRNGKey(seed + 1 + i)
            state, m = step(state, b, key)
            runs[f"skyhdr_{dtype}"].append({k: float(v) for k, v in m.items()})
            if dtype == "bfloat16":
                hdr_t, ldr = engine._degrade(cfg, banks, key, b["hdr"])
                gt = engine._sunpose_gt_from_elevation(cfg, b["elevation"])
                inputs = (torch.from_numpy(np.array(t)) for t in (hdr_t, ldr, gt))
                pstate, pm = pstep(pstate, *inputs)
                runs["port_bfloat16"].append({k: float(v) for k, v in pm.items()})
            print(f"{dtype} step {i}: " + "; ".join(
                f"{r} adv {v[-1]['adv']:.6g} gen_total {v[-1]['gen_total']:.6g} "
                f"disc_total {v[-1]['disc_total']:.6g}" for r, v in runs.items()), flush=True)
        out.update({r: {k: [m[k] for m in v] for k in v[0]} for r, v in runs.items()})
    return out


# ---------------------------------------------------------------------------
# A multi-step DA trajectory: `skyhdr`'s sun steps, the hand-off, GAN steps
# ---------------------------------------------------------------------------

TRAJ_STEPS = 8
# The weight noise of `trajectory_spread`: about one float32 rounding.
TRAJ_NOISE = 2e-7


def trajectory_batch(i: int):
    """Step i's batch of the trajectory: hdr uniform [0, 2), elevations
    uniform [2, 30)."""
    rng = np.random.default_rng(100 + i)
    hdr = rng.uniform(0.0, 2.0, (BATCH, H, W, 3)).astype(np.float32)
    return hdr, rng.uniform(2.0, 30.0, BATCH).astype(np.float32)


def _export_tool():
    spec = importlib.util.spec_from_file_location(
        "export_jax_checkpoint", os.path.join(ROOT, "tools", "export_jax_checkpoint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class JaxTrajectory:
    """`skyhdr`'s sun-pretrain and GAN steps at the train golden's
    configuration (16x64 DA b2, the XLA DA path), each jitted once, from
    `init_gan_vars(cfg, seed)`; `run` walks a trajectory."""

    def __init__(self, seed: int = 0):
        import jax

        jax.config.update("jax_platforms", "cpu")
        from skyhdr.config import Config, DataConfig, ModelConfig
        from skyhdr.data.degradation import make_banks
        from skyhdr.models.vgg16 import random_vgg16_weights
        from skyhdr.train import engine
        from skyhdr.utils.io import get_exposure_lists, make_synthetic_dorf
        from skyhdr_torch.utils.transplant import init_gan_vars

        self.seed, self.engine, self.tool = seed, engine, _export_tool()
        self.tcfg = golden_config()
        self.cfg = Config(model=ModelConfig(**vars(self.tcfg.model)),
                          data=DataConfig(batch_size=BATCH))
        self.lr = self.cfg.train.learning_rate
        self.vars = init_gan_vars(self.tcfg, seed)
        self.banks = make_banks(make_synthetic_dorf(175, 1024), get_exposure_lists()[0])
        self.sun_step = jax.jit(engine.make_sun_train_step(self.cfg, self.banks, jit=False))
        self.gan_step = jax.jit(engine.make_gan_train_step(
            self.cfg, self.banks, random_vgg16_weights(), jit=False))

    def inputs(self, i: int):
        """(batch, key, (hdr_t, ldr, sunpose_gt) as numpy) of step i: the
        degraded pair is the one the step draws from its key."""
        import jax
        import jax.numpy as jnp

        hdr, elevation = trajectory_batch(i)
        batch = {"hdr": jnp.asarray(hdr), "elevation": jnp.asarray(elevation)}
        key = jax.random.PRNGKey(self.seed + 1000 + i)
        hdr_t, ldr = self.engine._degrade(self.cfg, self.banks, key, batch["hdr"])
        gt = self.engine._sunpose_gt_from_elevation(self.cfg, batch["elevation"])
        return batch, key, tuple(np.asarray(t) for t in (hdr_t, ldr, gt))

    def _host(self, state):
        import jax

        return jax.tree_util.tree_map(np.asarray, state)

    def run(self, steps: int = TRAJ_STEPS, perturb: float = 0.0, draw: int = 0):
        """Yields a record a step: the sun stage's `steps` (Adam), one
        {"stage": "handoff", "sun": the last SUN state's export}, then the
        GAN stage's `steps` (RMSprop) from the seeded generator and
        discriminator and that SUN state's sun-pose net
        (`replace_sun_params`). A step's record: "stage", "step" (from 1 in
        its stage), "before" (the export, `export_jax_checkpoint.export_state`,
        of the state it starts from), "inputs", "metrics", "digests"
        (`update_digests` of its parameters), and "count" (Adam's, after) or
        "stats" and "stat_abs" (the BatchNorm sums after). `perturb`: the seeded weights
        first `perturbed` by that share (seeds 7, 8, 9 plus 10 `draw`)."""
        import jax.numpy as jnp

        eng, tool, lr = self.engine, self.tool, self.lr
        gv, sv, dv = self.vars
        if perturb:
            gv, sv, dv = (perturbed(t, perturb, s + 10 * draw)
                          for t, s in ((gv, 7), (sv, 8), (dv, 9)))
        zero = jnp.zeros((), jnp.int32)
        state = eng.SunState(sun_vars={"params": sv["params"]},
                             opt=eng._adam(lr).init(sv["params"]), step=zero, epoch=zero)
        for i in range(steps):
            old = self._host(state)
            batch, key, inputs = self.inputs(i)
            state, metrics = self.sun_step(state, batch, key)
            new = self._host(state)
            yield {"stage": "sun", "step": i + 1,
                   "before": tool.export_state("sun", 0, old, self.cfg), "inputs": inputs,
                   "metrics": {k: float(v) for k, v in metrics.items()},
                   "digests": update_digests(new.sun_vars["params"], old.sun_vars["params"]),
                   "count": int(tool._moments(new.opt).count)}
        sun_params = self._host(state).sun_vars["params"]
        yield {"stage": "handoff", "sun": tool.export_state("sun", 0, self._host(state), self.cfg)}
        state = eng.GanState(
            gen_vars=gv, sun_vars=sv, disc_vars=dv,
            opt_gen=eng._rmsprop(lr).init((gv["params"], sv["params"])),
            opt_disc=eng._rmsprop(lr).init(dv["params"]), step=zero, epoch=zero)
        state = eng.replace_sun_params(self.cfg, state, sun_params)

        def params(s):
            return {"gen": s.gen_vars["params"], "sun": s.sun_vars["params"],
                    "disc": s.disc_vars["params"]}

        for i in range(steps, 2 * steps):
            old = self._host(state)
            batch, key, inputs = self.inputs(i)
            state, metrics = self.gan_step(state, batch, key)
            new = self._host(state)
            stats = {"gen": new.gen_vars["batch_stats"], "disc": new.disc_vars["batch_stats"]}
            yield {"stage": "gan", "step": i - steps + 1,
                   "before": tool.export_state("gan", 0, old, self.cfg), "inputs": inputs,
                   "metrics": {k: float(v) for k, v in metrics.items()},
                   "digests": update_digests(params(new), params(old)),
                   "stats": stat_digests(stats), "stat_abs": stat_abs_sums(stats)}

    def free_metrics(self, steps: int = TRAJ_STEPS, perturb: float = 0.0, draw: int = 0):
        """{"sun": [metrics], "gan": [metrics]} of a whole run."""
        out = {"sun": [], "gan": []}
        for rec in self.run(steps, perturb, draw):
            if rec["stage"] != "handoff":
                out[rec["stage"]].append(rec["metrics"])
        return out


def port_free_trajectory(traj: JaxTrajectory, steps: int = TRAJ_STEPS) -> dict:
    """The port's own run of `traj`'s trajectory on `skyhdr`'s inputs, each
    step from the port's previous one (the SUN stage's sun-pose net handed
    off by `replace_sun_params`): {"sun": [metrics], "gan": [metrics]}."""
    import torch

    from skyhdr_torch.data.degradation import make_banks
    from skyhdr_torch.models.vgg16 import random_vgg16_weights
    from skyhdr_torch.train import engine
    from skyhdr_torch.utils.io import get_exposure_lists, make_synthetic_dorf

    cfg = traj.tcfg
    banks = make_banks(make_synthetic_dorf(175, 1024), get_exposure_lists()[0], device="cpu")
    tensors = lambda i: [torch.from_numpy(np.array(t)) for t in traj.inputs(i)[2]]
    out = {"sun": [], "gan": []}
    sun = harness_sun_state(cfg, traj.seed, "cpu")
    step = engine.make_sun_train_step(cfg, banks).train_on
    for i in range(steps):
        sun, m = step(sun, *tensors(i))
        out["sun"].append({k: float(v) for k, v in m.items()})
    state = engine.replace_sun_params(cfg, harness_gan_state(cfg, traj.seed, "cpu"),
                                      sun.sun.state_dict())
    step = engine.make_gan_train_step(cfg, banks, random_vgg16_weights()).train_on
    for i in range(steps, 2 * steps):
        state, m = step(state, *tensors(i))
        out["gan"].append({k: float(v) for k, v in m.items()})
    return out


def _metric_gaps(got, want):
    """Per step, the largest relative gap of any metric."""
    return [max(abs(g[k] - w[k]) / (abs(w[k]) + 1e-6) for k in w) for g, w in zip(got, want)]


def trajectory_spread(draws: int = 3) -> dict:
    """How far two free runs of the trajectory drift apart: per stage and
    step, the largest relative metric gap of `skyhdr`'s run with its seeded
    weights times (1 + 2e-7 N(0, 1)) (`draws` draws; the largest) and of
    the port's own run (`port_free_trajectory`), each against `skyhdr`'s
    unperturbed run. `python tools/make_torch_golden.py trajectory-spread`."""
    traj = JaxTrajectory(0)
    base = traj.free_metrics()
    noisy = [traj.free_metrics(perturb=TRAJ_NOISE, draw=d) for d in range(draws)]
    port = port_free_trajectory(traj)
    return {stage: {"skyhdr_noise": [max(g) for g in zip(*(_metric_gaps(n[stage], base[stage])
                                                          for n in noisy))],
                    "port": _metric_gaps(port[stage], base[stage])}
            for stage in ("sun", "gan")}


def untrained_draws(seeds: int = 3) -> dict:
    """The untrained generator's output scale under each package's seeded
    draw: `skyhdr`'s `create_gan_state(cfg, PRNGKey(s))` and the port's
    entry-point draw (`cli.common.restore_model_vars` with no checkpoint:
    `create_gan_state(cfg, s)`'s generator and sun-pose trees), both served
    by `skyhdr`'s inference on one fixed batch of 4 uniform [0, 1)
    panoramas at the default 32x128: plain convs for seeds 0..seeds-1
    ("skyhdr", "port"), and DA convs for seed 0 ("da"), the floors' draws.
    Per draw: mean and max of `y_final_lin`, `sun_pred_lin`'s mean, and
    the largest relative gap of any weight between the two draws.
    `python tools/make_torch_golden.py untrained-draws`."""
    import tempfile

    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from skyhdr.config import Config as JConfig, DataConfig as JData, ModelConfig as JModel
    from skyhdr.train.engine import create_gan_state, make_inference_fn
    from skyhdr_torch.cli.common import restore_model_vars
    from skyhdr_torch.config import Config, DataConfig, ModelConfig
    from skyhdr_torch.utils.transplant import export_model_vars

    x = jnp.asarray(np.random.default_rng(5).uniform(0, 1, (4, 32, 128, 3)).astype(np.float32))

    def gap(got, want):
        return max(float(np.max(np.abs(got[k] - np.asarray(want[k])) /
                                np.maximum(np.abs(np.asarray(want[k])), 1e-30), initial=0))
                   for k in want)

    def draws(use_da_conv: bool, seed_list) -> dict:
        cfg = JConfig(model=JModel(use_da_conv=use_da_conv), data=JData(batch_size=4))
        tcfg = Config(model=ModelConfig(use_da_conv=use_da_conv), data=DataConfig(batch_size=4))
        serve = jax.jit(make_inference_fn(cfg))

        def scale(gv, sv):
            out = serve(gv, sv, x)
            y = np.asarray(out["y_final_lin"], np.float64)
            return {"y_mean": y.mean(), "y_max": y.max(),
                    "sun_mean": float(np.asarray(out["sun_pred_lin"], np.float64).mean())}

        out = {"skyhdr": [], "port": [], "weights_rel_gap": []}
        with tempfile.TemporaryDirectory() as empty:
            for s in seed_list:
                state = create_gan_state(cfg, jax.random.PRNGKey(s))
                out["skyhdr"].append(scale(state.gen_vars, state.sun_vars))
                gen, sun = restore_model_vars(tcfg, empty, seed=s, device="cpu",
                                              log=lambda *a: None)
                gv, sv = export_model_vars(gen), export_model_vars(sun)
                out["port"].append(scale(gv, sv))
                out["weights_rel_gap"].append(max(
                    gap(dict(flat_leaves(gv)), dict(flat_leaves(state.gen_vars))),
                    gap(dict(flat_leaves(sv)), dict(flat_leaves(state.sun_vars)))))
        return out

    return {**draws(False, range(seeds)), "da": draws(True, [0])}


def draws_config():
    """The port's Config of the draws fixture: DA 16x64 b2."""
    from skyhdr_torch.config import Config, DataConfig, ModelConfig

    return Config(model=ModelConfig(im_height=H, im_width=W, use_da_conv=True),
                  data=DataConfig(batch_size=BATCH))


def _digest(a, lead: int) -> np.ndarray:
    """[sum, sum |.|, the first `lead` values (zero-padded)] in float64."""
    a = np.asarray(a, np.float32).ravel().astype(np.float64)
    return np.concatenate([[a.sum(), np.abs(a).sum()], a[:lead], np.zeros(max(0, lead - a.size))])


def draw_digests(trees: dict, draws: dict) -> dict:
    """The draws fixture's entries: "w/<tree>/<leaf path>" -> [sum, sum
    |.|, first DRAWS_LEAD values] of each weight leaf of `trees` ({name:
    Flax-layout tree}); "d/<name>" of the degradation `draws` ({t_idx,
    crf_idx, u_s, u_c, z_s, z_c}): the indices and uniforms whole, the
    noises as the leaves with DRAWS_NOISE_LEAD values."""
    out = {f"w/{path}": _digest(a, DRAWS_LEAD) for name, tree in trees.items()
           for path, a in flat_leaves(tree, name)}
    for k, v in draws.items():
        v = np.asarray(v)
        out[f"d/{k}"] = (v.astype(np.int64).ravel() if k.endswith("idx") else
                         _digest(v, DRAWS_NOISE_LEAD if k.startswith("z") else v.size))
    return out


def jax_degradation_draws(seed: int = 0) -> dict:
    """The draws of `skyhdr`'s `degrade_batch` for the loop's first train
    key (`split(PRNGKey(seed))[1]`) on a DA 16x64 b2 batch, with the train
    banks' sizes: its split in six and its six samplers."""
    import jax

    from skyhdr.utils.io import get_exposure_lists, make_synthetic_dorf

    n_crf, n_exp = len(make_synthetic_dorf(175, 1024)), len(get_exposure_lists()[0])
    key = jax.random.split(jax.random.PRNGKey(seed))[1]
    k_crf, k_t, k_ss, k_sc, k_ns, k_nc = jax.random.split(key, 6)
    shape = (BATCH, H, W, 3)
    return {"t_idx": jax.random.randint(k_t, (BATCH,), 0, n_exp),
            "u_s": jax.random.uniform(k_ss, (BATCH, 1, 1, 3)),
            "u_c": jax.random.uniform(k_sc, (BATCH, 1, 1, 3)),
            "z_s": jax.random.normal(k_ns, shape), "z_c": jax.random.normal(k_nc, shape),
            "crf_idx": jax.random.randint(k_crf, (BATCH,), 0, n_crf)}


def make_draws_golden(seed: int = 0) -> dict:
    """`skyhdr`'s `--seed` draws at DA 16x64 b2: `create_gan_state(cfg,
    PRNGKey(seed))`'s generator, sun-pose and discriminator trees,
    `create_sun_state(cfg, PRNGKey(seed))`'s sun-pose tree, and the
    degradation draws of the loop's first train step (`split(PRNGKey(seed))
    [1]`, split in six as `degrade_batch` splits it) with the train banks'
    sizes, digested by `draw_digests`: the weight leaves' digests as one
    array by name ("w_names", "w_digests"), "w_exact" marking those drawn
    uniform (or zeros, ones), which the port draws bit for bit."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from skyhdr.config import Config, DataConfig, ModelConfig
    from skyhdr.train import engine
    from skyhdr_torch.models.discriminator import Discriminator
    from skyhdr_torch.train.engine import build_models
    from skyhdr_torch.utils.transplant import _leaf_modules

    tcfg = draws_config()
    cfg = Config(model=ModelConfig(**vars(tcfg.model)), data=DataConfig(batch_size=BATCH))
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    gan = engine.create_gan_state(cfg, jax.random.PRNGKey(seed))
    sun = engine.create_sun_state(cfg, jax.random.PRNGKey(seed))
    trees = {"gan/gen": tree(gan.gen_vars), "gan/sun": tree(gan.sun_vars),
             "gan/disc": tree(gan.disc_vars), "sun/sun": tree(sun.sun_vars)}
    draws = jax_degradation_draws(seed)
    gen, sunnet = build_models(tcfg, device="meta")
    modules = {"gan/gen": gen, "gan/sun": sunnet, "gan/disc": Discriminator(3, device="meta"),
               "sun/sun": sunnet}
    exact = set(f"w/{name}/" + "/".join([coll, *path, leaf])
                   for name, m in modules.items() for path, mod in _leaf_modules(m)
                   for coll, leaf, _, _, init in mod.flax_leaves()
                   if init in ("glorot", "zeros", "ones"))
    digests = draw_digests(trees, draws)
    names = sorted(k for k in digests if k.startswith("w/"))
    return {"seed": np.int64(seed), "w_names": np.array(names),
            "w_exact": np.array([k in exact for k in names]),
            "w_digests": np.stack([digests[k] for k in names]),
            **{k: v for k, v in digests.items() if k.startswith("d/")}}


def port_draws(device, seed: int = 0) -> dict:
    """The port's side of `make_draws_golden` on `device`: the entry
    points' draws (`create_gan_state(cfg, seed)`, `create_sun_state(cfg,
    seed)`, `draw_degradation` of the loop's first key) digested alike."""
    from skyhdr_torch.data.degradation import draw_degradation, make_banks
    from skyhdr_torch.train.engine import create_gan_state, create_sun_state
    from skyhdr_torch.utils import jax_random
    from skyhdr_torch.utils.io import get_exposure_lists, make_synthetic_dorf
    from skyhdr_torch.utils.transplant import export_model_vars

    cfg = draws_config()
    gan, sun = create_gan_state(cfg, seed, device), create_sun_state(cfg, seed, device)
    trees = {"gan/gen": export_model_vars(gan.gen), "gan/sun": export_model_vars(gan.sun),
             "gan/disc": export_model_vars(gan.disc), "sun/sun": export_model_vars(sun.sun)}
    banks = make_banks(make_synthetic_dorf(175, 1024), get_exposure_lists()[0], device=device)
    key = jax_random.split(jax_random.key(seed))[1]
    d = draw_degradation(key, (BATCH, H, W, 3), banks)
    return draw_digests(trees, {k: v.cpu().numpy() for k, v in d._asdict().items()})


def _ordered_f32(a) -> np.ndarray:
    i = np.asarray(a, np.float64).astype(np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def compare_draws(stored, got: dict) -> list:
    """Faults of `port_draws` against the fixture: a missing or extra
    entry, an index off, a value more than DRAWS_ULPS ulps away (any ulp
    for an "exact" leaf), a sum off by more than DRAWS_SUM_RTOL of the sum
    of |.|."""
    names = stored["w_names"].tolist()
    want = {**dict(zip(names, stored["w_digests"])),
            **{k: stored[k] for k in stored.files if k.startswith("d/")}}
    exact = {k for k, e in zip(names, stored["w_exact"]) if e}
    fails = [f"entries {sorted(set(got) ^ set(want))[:5]}"] if set(got) != set(want) else []
    for k in sorted(set(got) & set(want)):
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if k.endswith("idx"):
            if not np.array_equal(g, w):
                fails.append(f"{k}: {g.tolist()} != {w.tolist()}")
            continue
        ulps = int(np.abs(_ordered_f32(g[2:]) - _ordered_f32(w[2:])).max(initial=0))
        if ulps > (0 if k in exact or k.startswith("d/u_") else DRAWS_ULPS):
            fails.append(f"{k}: values {ulps} ulps off")
        if abs(g[0] - w[0]) > DRAWS_SUM_RTOL * w[1] or abs(g[1] - w[1]) > DRAWS_SUM_RTOL * w[1]:
            fails.append(f"{k}: sums {g[:2].tolist()} != {w[:2].tolist()}")
    return fails


def main():
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == ["dp-rank"]:
        _dp_rank_main(*sys.argv[2:4])
        return
    if sys.argv[1:2] == ["fsdp"]:
        os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
        np.savez_compressed(FSDP_FIXTURE, **make_fsdp_golden(0))
        print(f"wrote {FSDP_FIXTURE} ({os.path.getsize(FSDP_FIXTURE)} bytes)")
        return
    if sys.argv[1:2] == ["width"]:
        os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
        np.savez_compressed(WIDTH_FIXTURE, **make_width_golden(0))
        print(f"wrote {WIDTH_FIXTURE} ({os.path.getsize(WIDTH_FIXTURE)} bytes)")
        return
    if sys.argv[1:2] == ["plain-bf16-adv"]:
        import json

        print(json.dumps(plain_bf16_adv()))
        return
    if sys.argv[1:2] == ["trajectory-spread"]:
        import json

        print(json.dumps(trajectory_spread()))
        return
    if sys.argv[1:2] == ["draws"]:
        np.savez_compressed(DRAWS_FIXTURE, **make_draws_golden(0))
        print(f"wrote {DRAWS_FIXTURE} ({os.path.getsize(DRAWS_FIXTURE)} bytes)")
        return
    if sys.argv[1:2] == ["untrained-draws"]:
        import json

        print(json.dumps(untrained_draws()))
        return
    # The DP golden runs on two of eight virtual CPU devices, as the tests do.
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    for path, make in ((FIXTURE, lambda: make_golden(0)),
                       (TRAIN_FIXTURE, lambda: make_train_golden(0)),
                       (DA5_FIXTURE, lambda: make_golden(0, da_kernel_size=5)),
                       (DA5_TRAIN_FIXTURE, lambda: make_train_golden(0, da_kernel_size=5)),
                       (RESUME_FIXTURE, lambda: make_resume_golden(0)),
                       (BF16_TRAIN_FIXTURE, lambda: make_train_golden_bf16(0)),
                       (KNOBS_FIXTURE, lambda: make_train_golden_knobs(0)),
                       (PLAIN_TRAIN_FIXTURE, lambda: make_train_golden(0, use_da_conv=False)),
                       (PLAIN_BF16_TRAIN_FIXTURE,
                        lambda: make_train_golden_bf16(0, use_da_conv=False)),
                       (DP_FIXTURE, lambda: make_dp_golden(0)),
                       (FSDP_FIXTURE, lambda: make_fsdp_golden(0))):
        np.savez_compressed(path, **make())
        print(f"wrote {path} ({os.path.getsize(path)} bytes)")


if __name__ == "__main__":
    main()
