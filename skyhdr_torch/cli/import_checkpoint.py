"""Import checkpoints of the JAX package (`skyhdr`, Orbax) as the port's own,
on a CUDA card by default.

The conversion has two steps, because Orbax cannot be read without JAX:
where `skyhdr` runs,

  python tools/export_jax_checkpoint.py --workdir RUN --out EXPORT <model flags>

writes the newest SKY and SUN checkpoints to EXPORT/SKY and EXPORT/SUN in a
plain form (`skyhdr_torch.utils.flax_export`); then, where the port runs,

  python -m skyhdr_torch.cli.import_checkpoint --export EXPORT --workdir W <model flags>

writes them as `<W>/checkpoints/{SKY,SUN}/<orbax step>/state.pt`, through
the port's `CheckpointManager.save`. `skyhdr_torch.cli.inference --workdir
W` then serves them and `skyhdr_torch.cli.train --workdir W` resumes from
them, as the JAX CLIs do from Orbax's. The model flags are those the
checkpoint was trained with; the storage dtypes are the export's (its
manifest), whatever `--param-dtype` / `--opt-state-dtype` say.
"""

from __future__ import annotations

import argparse
import os
import time

from skyhdr_torch.cli.common import add_common_flags, config_from_args
from skyhdr_torch.train.checkpoints import CheckpointManager
from skyhdr_torch.train.convert import state_from_export
from skyhdr_torch.utils.flax_export import MANIFEST, read_export

# The state each checkpoint directory holds.
_KINDS = {"SKY": "gan", "SUN": "sun"}


def main(argv=None):
    parser = argparse.ArgumentParser(description="import skyhdr checkpoints "
                                                 "exported by tools/export_jax_checkpoint.py")
    add_common_flags(parser)
    parser.add_argument("--export", type=str, required=True,
                        help="the export tool's --out directory (SKY/ and/or SUN/)")
    args = parser.parse_args(argv)
    # The storage dtypes come from the manifest: the port's state is float32.
    for knob in ("opt_state_dtype", "grad_dtype", "param_dtype"):
        setattr(args, knob, "float32")
    cfg = config_from_args(args)

    found = [name for name in _KINDS
             if os.path.isfile(os.path.join(args.export, name, MANIFEST))]
    if not found:
        raise SystemExit(f"error: no SKY/{MANIFEST} or SUN/{MANIFEST} under "
                         f"{args.export!r}")
    for name in found:
        t0 = time.perf_counter()
        manifest, leaves = read_export(os.path.join(args.export, name))
        if manifest["kind"] != _KINDS[name]:
            raise ValueError(f"{name}: an export of a {manifest['kind']} state, "
                             f"not a {_KINDS[name]} state")
        state = state_from_export((manifest, leaves), cfg, args.device)
        t1 = time.perf_counter()
        step = int(manifest["orbax_step"])
        ckpt = CheckpointManager(os.path.join(args.workdir, cfg.train.checkpoint_dir, name),
                                 cfg.train.ckpt_max_to_keep)
        ckpt.save(step, state)
        t2 = time.perf_counter()
        print(f"{name} checkpoint {step} imported (epoch {state.epoch}, step "
              f"{state.step}, param_dtype {manifest['param_dtype']}, moments "
              f"{manifest['opt_state_dtype']}) to {ckpt.directory}/{step} in "
              f"{t2 - t0:.3f} s (read onto {args.device} {t1 - t0:.3f} s, saved "
              f"{t2 - t1:.3f} s)")
        del state, leaves


if __name__ == "__main__":
    main()
