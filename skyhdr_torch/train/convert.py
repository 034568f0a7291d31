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
A state trained with bfloat16 parameters (`param_dtype`) also holds the
float32 master of its `MasterParamsState` as opt_gen/master/{0,1}/...,
opt_disc/master/... and opt/master/..., and its stored parameters are the
master rounded. Parameters and BatchNorm statistics go through
`transplant.load_model_vars`. Each moment (and master) is copied into the
port optimizer's tensor of the parameter it belongs to, found from the
parameter tensor itself (`RMSprop.moments()`, `Adam.moments()`), with the
parameter's relayout.

The state's `param_dtype` is the export's (it fixes the optimizer state's
structure, as it does `skyhdr`'s tree). The moments keep their exported
values: they are held in the run's `opt_state_dtype` where that holds them
exactly, and float32 moments stay float32 in a bfloat16-storing state
until its next step rounds them, as `skyhdr`'s restore keeps the saved
dtype and its next update rounds.
"""

from __future__ import annotations

import dataclasses

import torch

from skyhdr_torch.train.engine import empty_gan_state, empty_sun_state
from skyhdr_torch.train.optim import storage_dtype
from skyhdr_torch.utils.flax_export import flatten, unflatten
from skyhdr_torch.utils.transplant import export_model_vars, leaf_tensors, load_model_vars

_BOTH = ("params", "batch_stats")
_SHAPE = ("im_height", "im_width", "use_da_conv", "da_kernel_size")


def state_rows(state):
    """[(export prefix, module, collections, optimizer, moment name)] of
    every leaf the state holds: the module's own leaves (optimizer and name
    None; the collections are the prefix's first level), then per optimizer
    each moment ("nu", "mu") and the float32 "master" of the module's
    parameters."""
    if state.kind == "gan":
        rows = [("gen_vars", state.gen, _BOTH, None, None),
                ("sun_vars", state.sun, _BOTH, None, None),
                ("disc_vars", state.disc, _BOTH, None, None)]
        for name in state.opt_gen.moments():
            rows += [(f"opt_gen/{name}/0", state.gen, ("params",), state.opt_gen, name),
                     (f"opt_gen/{name}/1", state.sun, ("params",), state.opt_gen, name)]
        rows += [(f"opt_disc/{name}", state.disc, ("params",), state.opt_disc, name)
                 for name in state.opt_disc.moments()]
        return rows
    return [("sun_vars", state.sun, _BOTH, None, None)] + [
        (f"opt/{name}", state.sun, ("params",), state.opt, name) for name in state.opt.moments()]


def _layout(state):
    """[(export prefix, module, collections, tensor_of)] of `state_rows`:
    tensor_of maps a parameter to its moment or master (None for the
    module's own leaves)."""
    return [(prefix, module, colls, None if opt is None else opt.moments()[name].__getitem__)
            for prefix, module, colls, opt, name in state_rows(state)]


def state_from_export(export, cfg, device="cuda"):
    """The GanState or SunState of an export (`flax_export.read_export`'s
    (manifest, leaves)), built by `empty_gan_state` / `empty_sun_state` for
    `cfg` with the export's `param_dtype` on `device` and filled. Raises
    ValueError, before any copy, when the manifest's model shape disagrees
    with `cfg` or the export's leaves are not exactly the state's, and for
    a leaf of another shape."""
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
    moment_dtype = manifest.get("opt_state_dtype")
    for knob, value in (("param_dtype", param_dtype), ("opt_state_dtype", moment_dtype)):
        if value not in ("float32", "bfloat16"):
            raise ValueError(f"{knob} {value!r}: neither float32 nor bfloat16")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, param_dtype=param_dtype))
    state = {"gan": empty_gan_state, "sun": empty_sun_state}[kind](cfg, device)
    if storage_dtype(moment_dtype) == torch.float32:
        for opt in state.optimizers().values():
            if opt.store != torch.float32:
                opt.hold_moments(torch.float32)
    want = set(leaf_dtypes(state))
    missing, extra = sorted(want - set(leaves)), sorted(set(leaves) - want)
    if missing or extra:
        raise ValueError(f"the export's leaves are not the {kind} state's: missing "
                         f"{missing[:5]} ({len(missing)}), unexpected {extra[:5]} "
                         f"({len(extra)})")
    for prefix, module, colls, tensor_of in _layout(state):
        tree = unflatten(leaves, prefix)
        load_model_vars(module, tree if tensor_of is None else {"params": tree},
                        target_of=tensor_of, collections=colls)
    state.step, state.epoch = int(manifest["step"]), int(manifest["epoch"])
    if kind == "sun":
        state.opt.count = int(manifest["count"])
    return state


def leaf_dtypes(state) -> dict:
    """{export path: dtype name} of every leaf `export_from_state` writes,
    in the dtype the state holds it."""
    out = {}
    for prefix, module, colls, tensor_of in _layout(state):
        for path, tensor in leaf_tensors(module, colls):
            t = tensor if tensor_of is None else tensor_of(tensor)
            key = path if tensor_of is None else path[len("params/"):]
            out[f"{prefix}/{key}"] = str(t.dtype).replace("torch.", "")
    return out


@torch.no_grad()
def export_from_state(state):
    """(manifest, {path: float32 array}) of a port state, as
    `tools/export_jax_checkpoint.py` writes a `skyhdr` state: the inverse of
    `state_from_export` (bfloat16 leaves upcast exactly; `leaf_dtypes`
    names their dtypes). Its `orbax_step` (the directory a checkpoint is
    saved under) is the state's epoch, as the training loops save."""
    leaves = {}
    for prefix, module, colls, tensor_of in _layout(state):
        tree = export_model_vars(module, value_of=tensor_of, collections=colls)
        leaves.update(flatten(tree if tensor_of is None else tree["params"], prefix))
    model = state.sun.cfg
    opt = next(iter(state.optimizers().values()))
    manifest = {"kind": state.kind, "step": int(state.step), "epoch": int(state.epoch),
                "orbax_step": int(state.epoch),
                "count": int(state.opt.count) if state.kind == "sun" else None,
                "param_dtype": state.param_dtype,
                "opt_state_dtype": str(opt.nu[0].dtype).replace("torch.", ""),
                **{k: getattr(model, k) for k in _SHAPE}}
    return manifest, leaves
