"""Checkpoints of the JAX package in the port: a `skyhdr` GanState or
SunState, exported by `tools/export_jax_checkpoint.py` in the plain form of
`skyhdr_torch.utils.flax_export`, becomes a state of `train.engine`, which
`train.checkpoints.CheckpointManager` then saves as the port's own
checkpoint (`cli/import_checkpoint.py`).

  state_from_export((manifest, leaves), cfg, device) -> GanState / SunState
  export_from_state(state) -> (manifest, leaves), the inverse

The leaf paths are the Flax state's:
  GanState  gen_vars/{params,batch_stats}/..., sun_vars/params/...,
            disc_vars/{params,batch_stats}/...; optax rmsprop's nu over
            (generator params, sun-pose params) as opt_gen/nu/0/...,
            opt_gen/nu/1/..., and over the discriminator's as opt_disc/nu/...
  SunState  sun_vars/params/...; optax adam's opt/mu/..., opt/nu/..., and
            its count in the manifest.
Parameters and BatchNorm statistics go through `transplant.load_model_vars`.
Each moment is copied into the port optimizer's moment of the parameter it
belongs to, found from the parameter tensor itself (`RMSprop.moments()`,
`Adam.moments()`), with the parameter's relayout.

A state trained with bfloat16 parameters (`param_dtype`) is imported with
its stored parameters, upcast exactly, and without optimizer state: it
serves and hands its sun-pose net off, and `engine.load_state` refuses to
resume it. Moments stored in bfloat16 (`opt_state_dtype`) are upcast
exactly, and the state serves and resumes in float32.
"""

from __future__ import annotations

import torch

from skyhdr_torch.train.engine import empty_gan_state, empty_sun_state
from skyhdr_torch.utils.flax_export import flatten, unflatten
from skyhdr_torch.utils.transplant import (export_model_vars, leaf_paths,
                                           load_model_vars)

_BOTH = ("params", "batch_stats")
_SHAPE = ("im_height", "im_width", "use_da_conv", "da_kernel_size")


def _layout(state):
    """[(export prefix, module, collections, moment_of)] of every leaf the
    state holds: moment_of maps a parameter to its moment (None for the
    module's own leaves, whose collections are the prefix's first level)."""
    if state.kind == "gan":
        rows = [("gen_vars", state.gen, _BOTH, None), ("sun_vars", state.sun, _BOTH, None),
                ("disc_vars", state.disc, _BOTH, None)]
        if state.param_dtype == "float32":
            nu = state.opt_gen.moments()["nu"]
            rows += [("opt_gen/nu/0", state.gen, ("params",), nu.__getitem__),
                     ("opt_gen/nu/1", state.sun, ("params",), nu.__getitem__),
                     ("opt_disc/nu", state.disc, ("params",),
                      state.opt_disc.moments()["nu"].__getitem__)]
        return rows
    rows = [("sun_vars", state.sun, _BOTH, None)]
    if state.param_dtype == "float32":
        moments = state.opt.moments()
        rows += [(f"opt/{name}", state.sun, ("params",), moments[name].__getitem__)
                 for name in ("mu", "nu")]
    return rows


def _paths(state):
    """The export paths of every leaf `_layout(state)` names."""
    out = set()
    for prefix, module, colls, moment_of in _layout(state):
        for path in leaf_paths(module, colls):
            # A moment tree mirrors the params collection without its name.
            out.add(f"{prefix}/{path if moment_of is None else path[len('params/'):]}")
    return out


def state_from_export(export, cfg, device="cuda"):
    """The GanState or SunState of an export (`flax_export.read_export`'s
    (manifest, leaves)), built by `empty_gan_state` / `empty_sun_state` for
    `cfg` on `device` and filled. Raises ValueError, before any copy, when
    the manifest's model shape disagrees with `cfg` or the export's leaves
    are not exactly the state's, and for a leaf of another shape."""
    manifest, leaves = export
    kind = manifest.get("kind")
    if kind not in ("gan", "sun"):
        raise ValueError(f"export of kind {kind!r}: neither 'gan' nor 'sun'")
    bad = {k: (manifest.get(k), getattr(cfg.model, k)) for k in _SHAPE
           if manifest.get(k) != getattr(cfg.model, k)}
    if bad:
        raise ValueError("the export's model shape disagrees with the config "
                         "(export, config): " + ", ".join(f"{k} {v}" for k, v in bad.items()))
    param_dtype = manifest.get("param_dtype")
    if param_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"param_dtype {param_dtype!r}: neither float32 nor bfloat16")
    state = {"gan": empty_gan_state, "sun": empty_sun_state}[kind](cfg, device)
    state.param_dtype = param_dtype
    want = _paths(state)
    missing, extra = sorted(want - set(leaves)), sorted(set(leaves) - want)
    if missing or extra:
        raise ValueError(f"the export's leaves are not the {kind} state's: missing "
                         f"{missing[:5]} ({len(missing)}), unexpected {extra[:5]} "
                         f"({len(extra)})")
    for prefix, module, colls, moment_of in _layout(state):
        tree = unflatten(leaves, prefix)
        load_model_vars(module, tree if moment_of is None else {"params": tree},
                        target_of=moment_of, collections=colls)
    state.step, state.epoch = int(manifest["step"]), int(manifest["epoch"])
    if kind == "sun" and param_dtype == "float32":
        state.opt.count = int(manifest["count"])
    return state


@torch.no_grad()
def export_from_state(state):
    """(manifest, {path: float32 array}) of a port state, as
    `tools/export_jax_checkpoint.py` writes a `skyhdr` state: the inverse of
    `state_from_export`. Its `orbax_step` (the directory a checkpoint is
    saved under) is the state's epoch, as the training loops save."""
    leaves = {}
    for prefix, module, colls, moment_of in _layout(state):
        tree = export_model_vars(module, value_of=moment_of, collections=colls)
        leaves.update(flatten(tree if moment_of is None else tree["params"], prefix))
    model = state.sun.cfg
    f32 = state.param_dtype == "float32"
    manifest = {"kind": state.kind, "step": int(state.step), "epoch": int(state.epoch),
                "orbax_step": int(state.epoch),
                "count": int(state.opt.count) if state.kind == "sun" and f32 else None,
                "param_dtype": state.param_dtype,
                "opt_state_dtype": "float32" if f32 else None,
                **{k: getattr(model, k) for k in _SHAPE}}
    return manifest, leaves
