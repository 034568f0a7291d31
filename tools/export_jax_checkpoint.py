"""Export the newest SKY and/or SUN checkpoint of `skyhdr` (Orbax) to the
plain form that the PyTorch port imports (`skyhdr_torch.utils.flax_export`).

Run it where `skyhdr` runs (JAX and Orbax; the CPU is enough), with the
model flags the checkpoints were trained with:

  python tools/export_jax_checkpoint.py --workdir RUN --out EXPORT \
      --imheight 64 --imwidth 256 --da-conv true

It reads the newest checkpoint under <workdir>/checkpoints/SKY (or --sky
DIR) and under <workdir>/checkpoints/SUN (or --sun DIR) to host memory,
through an abstract template of `create_gan_state` / `create_sun_state`. A
checkpoint trained with `param_dtype=bfloat16` has another tree shape (its
optimizer state is a `MasterParamsState`), so each `param_dtype` is tried
in turn, as `skyhdr.cli.common.restore_model_vars` does. It writes
EXPORT/SKY/ and EXPORT/SUN/: the parameters and BatchNorm statistics, the
optimizer moments in their stored dtype (and, for bfloat16 parameters, the
float32 master of the `MasterParamsState`), the step, the epoch and Adam's
count. Then, where the port runs:

  python -m skyhdr_torch.cli.import_checkpoint --export EXPORT --workdir W \
      --imheight 64 --imwidth 256 --da-conv true
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from skyhdr.cli.common import add_common_flags, config_from_args  # noqa: E402
from skyhdr.train.checkpoints import CheckpointManager  # noqa: E402
from skyhdr.train.engine import (MasterParamsState, create_gan_state,  # noqa: E402
                                 create_sun_state)
from skyhdr_torch.utils.flax_export import flatten, write_export  # noqa: E402

# Checkpoint directory -> (state kind, its factory).
STATES = {"SKY": ("gan", create_gan_state), "SUN": ("sun", create_sun_state)}


def restore_host(cfg, ckpt_dir: str, factory, seed: int = 0):
    """(Orbax step, host state with numpy leaves) of the newest checkpoint
    under `ckpt_dir`, or None if it holds none. Tries the templates of
    `cfg`'s param_dtype, then float32, then bfloat16; raises the last
    failure if none fits."""
    mgr = CheckpointManager(ckpt_dir, cfg.train.ckpt_max_to_keep)
    try:
        step = mgr.latest_step()
        if step is None:
            return None
        err = None
        for pd in dict.fromkeys([cfg.train.param_dtype, "float32", "bfloat16"]):
            c = cfg.replace(train=dataclasses.replace(cfg.train, param_dtype=pd))
            abstract = jax.eval_shape(lambda k: factory(c, k), jax.random.PRNGKey(seed))
            try:
                return step, mgr.restore_latest_host(abstract)
            except ValueError as e:  # another tree shape: try the next param_dtype
                err = e
        raise err
    finally:
        mgr.close()


def _moments(opt):
    """The optax state that holds the moments (ScaleByRmsState or
    ScaleByAdamState: the first node with a `nu`) inside an opt state."""
    if hasattr(opt, "nu"):
        return opt
    if isinstance(opt, tuple):
        for node in opt:
            found = _moments(node)
            if found is not None:
                return found
    return None


def export_state(kind: str, orbax_step: int, state, cfg):
    """(manifest, {path: numpy leaf}) of a host GanState ("gan") or
    SunState ("sun"), in the leaf paths of `skyhdr_torch.train.convert`."""
    opt = state.opt_gen if kind == "gan" else state.opt
    bf16_params = isinstance(opt, MasterParamsState)
    names = ("gen_vars", "sun_vars", "disc_vars") if kind == "gan" else ("sun_vars",)
    leaves = {}
    for name in names:
        leaves.update(flatten(getattr(state, name), name))
    moments = {}
    if kind == "gan":
        nu_gen, nu_sun = _moments(state.opt_gen).nu
        moments.update(flatten(nu_gen, "opt_gen/nu/0"))
        moments.update(flatten(nu_sun, "opt_gen/nu/1"))
        moments.update(flatten(_moments(state.opt_disc).nu, "opt_disc/nu"))
        if bf16_params:
            master_gen, master_sun = state.opt_gen.master
            leaves.update(flatten(master_gen, "opt_gen/master/0"))
            leaves.update(flatten(master_sun, "opt_gen/master/1"))
            leaves.update(flatten(state.opt_disc.master, "opt_disc/master"))
        count = None
    else:
        adam = _moments(state.opt)
        moments.update(flatten(adam.mu, "opt/mu"))
        moments.update(flatten(adam.nu, "opt/nu"))
        if bf16_params:
            leaves.update(flatten(state.opt.master, "opt/master"))
        count = int(adam.count)
    leaves.update(moments)
    m = cfg.model
    manifest = {"kind": kind, "orbax_step": int(orbax_step), "step": int(state.step),
                "epoch": int(state.epoch), "count": count,
                "param_dtype": "bfloat16" if bf16_params else "float32",
                "opt_state_dtype": next(np.asarray(v).dtype.name for v in moments.values()),
                "im_height": m.im_height, "im_width": m.im_width,
                "use_da_conv": m.use_da_conv, "da_kernel_size": m.da_kernel_size}
    return manifest, leaves


def main(argv=None):
    parser = argparse.ArgumentParser(description="export skyhdr checkpoints for "
                                                 "skyhdr_torch.cli.import_checkpoint")
    add_common_flags(parser)
    parser.add_argument("--sky", type=str, default=None,
                        help="SKY checkpoint dir (default: <workdir>/checkpoints/SKY)")
    parser.add_argument("--sun", type=str, default=None,
                        help="SUN checkpoint dir (default: <workdir>/checkpoints/SUN)")
    parser.add_argument("--out", type=str, required=True,
                        help="new directory for the export (SKY/ and SUN/)")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)

    root = os.path.join(args.workdir, cfg.train.checkpoint_dir)
    wrote = 0
    for name, ckpt_dir in (("SKY", args.sky), ("SUN", args.sun)):
        ckpt_dir = ckpt_dir or os.path.join(root, name)
        kind, factory = STATES[name]
        if not os.path.isdir(ckpt_dir):
            continue
        t0 = time.perf_counter()
        found = restore_host(cfg, ckpt_dir, factory, args.seed)
        if found is None:
            continue
        manifest, leaves = export_state(kind, *found, cfg)
        write_export(os.path.join(args.out, name), manifest, leaves)
        size = sum(np.asarray(v).nbytes for v in leaves.values())
        print(f"{name} checkpoint {manifest['orbax_step']} (epoch {manifest['epoch']}, "
              f"param_dtype {manifest['param_dtype']}, moments "
              f"{manifest['opt_state_dtype']}): {len(leaves)} leaves, {size / 1e9:.3f} GB "
              f"-> {os.path.join(args.out, name)} in {time.perf_counter() - t0:.3f} s")
        wrote += 1
    if not wrote:
        raise SystemExit(f"error: no SKY or SUN checkpoint under {root!r} "
                         "(or --sky / --sun)")


if __name__ == "__main__":
    main()
