"""Weights carried across: one Flax-layout tree of NumPy arrays that both
packages consume, and `skyhdr`'s own seeded draw.

`init_model_vars(cfg, seed)` draws `(gen_vars, sun_vars)` with the tree,
names, shapes and `params` / `batch_stats` split of
`skyhdr.train.engine.create_gan_state(...).gen_vars / .sun_vars`, from
`numpy.random.default_rng(seed)` with the Flax initialisers' own
distributions (glorot_uniform, lecun_normal — a normal truncated at two
standard deviations —, normal(0.02), zeros, ones; BN running mean 0 and var
1). Draws are float32: at 64x256 the sun-pose FCs alone are 3.2 GB. These
are the test harness's weights, from which the goldens and fixtures were
made; they are not the weights `--seed` draws.

`init_gan_vars(cfg, seed)` draws the Discriminator's tree as well, from
the same stream AFTER the generator and sun trees, so the gen/sun draws
stay those of `init_model_vars`.

`draw_model_vars(module, key)` fills a port module with the weights that
Flax's `init` draws from the key `key` (a `utils.jax_random` key) for
`skyhdr`'s module: each parameter's key is Flax's, folded from the scope's
path and the parameter's place among the scope's `self.param` calls, and
its values those of `skyhdr`'s initialiser; on the module's device. The
entry points' `--seed` weights (`train.engine.create_gan_state` /
`create_sun_state`) are this draw.

`load_model_vars(module, tree)` copies such a tree into a port module;
`export_model_vars(module)` is the way back, module -> Flax-layout NumPy
tree (optionally of other tensors shaped like the parameters: gradients,
optimizer moments).
Every leaf module names its leaves in `flax_leaves()` as (collection, name,
tensor, layout, initializer), its `params` in the order of `skyhdr`'s
`self.param` calls (kernel then bias, scale then bias); the layouts are
  "same"  — as is (DA kernels [k*k*c, f], biases, norm scales, BN stats),
  "hwio"  — conv kernel HWIO -> OIHW,
  "dense" — Dense kernel [in, out] -> Linear weight [out, in].
Flattening Dense layers (SpatialDense fc1, SunRadNet gamma/beta) read NHWC
flattens in both packages, so their rows carry over unpermuted.
"""

from __future__ import annotations

import numpy as np
import torch

from skyhdr_torch.utils import jax_random

# Flax lecun_normal: truncated_normal(-2, 2) scaled to unit variance.
_TRUNC_STD = 0.87962566103423978


def _flax_shape(t: torch.Tensor, layout: str):
    shape = tuple(t.shape)
    if layout == "hwio":
        o, i, kh, kw = shape
        return (kh, kw, i, o)
    if layout == "dense":
        return shape[::-1]
    return shape


def _fans(shape):
    receptive = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
    return shape[-2] * receptive, shape[-1] * receptive


def _draw(rng: np.random.Generator, init: str, shape) -> np.ndarray:
    if init == "zeros":
        return np.zeros(shape, np.float32)
    if init == "ones":
        return np.ones(shape, np.float32)
    if init == "normal02":
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
    fan_in, fan_out = _fans(shape)
    if init == "glorot":
        limit = np.float32(np.sqrt(6.0 / (fan_in + fan_out)))
        u = rng.random(shape, dtype=np.float32)
        return (u * np.float32(2.0) - np.float32(1.0)) * limit
    if init == "lecun":
        z = rng.standard_normal(shape, dtype=np.float32)
        out = np.abs(z) > 2.0
        while out.any():
            z[out] = rng.standard_normal(int(out.sum()), dtype=np.float32)
            out = np.abs(z) > 2.0
        return z * np.float32(np.sqrt(1.0 / fan_in) / _TRUNC_STD)
    raise ValueError(f"unknown initializer {init!r}")


def _leaf_modules(module: torch.nn.Module):
    for name, mod in module.named_modules():
        if hasattr(mod, "flax_leaves"):
            yield (name.split(".") if name else []), mod


def _node(tree: dict, path):
    for key in path:
        tree = tree.setdefault(key, {})
    return tree


def init_tree(module: torch.nn.Module, rng: np.random.Generator) -> dict:
    """A Flax-layout variable tree for `module`, drawn from `rng`."""
    tree = {}
    for path, mod in _leaf_modules(module):
        for coll, name, tensor, layout, init in mod.flax_leaves():
            _node(tree, [coll, *path])[name] = _draw(
                rng, init, _flax_shape(tensor, layout))
    return tree


def init_model_vars(cfg, seed: int = 0):
    """(gen_vars, sun_vars) of the Generator and SunPoseNet for `cfg`
    (a Config), drawn from `numpy.random.default_rng(seed)`: the test
    harness's weights, not `--seed`'s (`draw_model_vars`)."""
    from skyhdr_torch.train.engine import build_models

    gen, sun = build_models(cfg, device="meta")
    rng = np.random.default_rng(seed)
    return init_tree(gen, rng), init_tree(sun, rng)


def init_gan_vars(cfg, seed: int = 0):
    """(gen_vars, sun_vars, disc_vars): `init_model_vars`' two trees, then
    the Discriminator's, all from `numpy.random.default_rng(seed)`: the
    test harness's weights, not `--seed`'s (`draw_model_vars`)."""
    from skyhdr_torch.models.discriminator import Discriminator
    from skyhdr_torch.train.engine import build_models

    gen, sun = build_models(cfg, device="meta")
    rng = np.random.default_rng(seed)
    return (init_tree(gen, rng), init_tree(sun, rng),
            init_tree(Discriminator(cfg.model.channels, device="meta"), rng))


# Flax layout -> torch layout.
_PERM = {"hwio": (3, 2, 0, 1), "dense": (1, 0)}


def _jax_draw(key, init: str, shape, device) -> torch.Tensor:
    """`skyhdr`'s initialiser `init` at the Flax `shape` from `key`, as
    `jax.nn.initializers` computes it in float32."""
    if init == "zeros":
        return torch.zeros(shape, device=device)
    if init == "ones":
        return torch.ones(shape, device=device)
    if init == "normal02":
        return jax_random.normal(key, shape, device).mul_(float(np.float32(0.02)))
    fan_in, fan_out = _fans(shape)
    if init == "glorot":
        variance = np.float32(1.0 / ((fan_in + fan_out) / 2))
        limit = np.sqrt(np.float32(3) * variance)
        return jax_random.uniform(key, shape, -1.0, 1.0, device).mul_(float(limit))
    if init == "lecun":
        std = np.sqrt(np.float32(1.0 / fan_in)) / np.float32(_TRUNC_STD)
        return jax_random.truncated_normal(key, -2.0, 2.0, shape, device).mul_(float(std))
    raise ValueError(f"unknown initializer {init!r}")


@torch.no_grad()
def draw_model_vars(module: torch.nn.Module, key, target_of=None) -> torch.nn.Module:
    """Fill `module`'s leaves with Flax's init of `skyhdr`'s module from
    the init key `key`: the `counter`-th `params` leaf of the scope at
    `path` from `jax_random.flax_param_key(key, path, counter)` (zeros and
    ones count too), drawn on the leaf's device in the Flax layout, then
    relaid. `target_of(tensor)` names another tensor to take a `params`
    leaf (an optimizer's float32 master); the BatchNorm statistics always
    go to the module."""
    for path, mod in _leaf_modules(module):
        counter = 0
        for coll, name, tensor, layout, init in mod.flax_leaves():
            dst, sub = tensor, None
            if coll == "params":
                counter += 1
                sub = jax_random.flax_param_key(key, path, counter)
                dst = tensor if target_of is None else target_of(tensor)
            value = _jax_draw(sub, init, _flax_shape(tensor, layout), dst.device)
            if layout in _PERM:
                value = value.permute(*_PERM[layout])
            dst.copy_(value)
    return module


def tree_digest(tree) -> float:
    """Sum of |w| over every leaf in float64: a cheap fingerprint that the
    same seed drew the same weights on another machine."""
    if isinstance(tree, dict):
        return sum(tree_digest(tree[k]) for k in sorted(tree))
    return float(np.abs(np.asarray(tree, np.float64)).sum())


@torch.no_grad()
def load_model_vars(module: torch.nn.Module, tree: dict, target_of=None,
                    collections=("params", "batch_stats")) -> torch.nn.Module:
    """Copy a Flax-layout tree (NumPy or anything `np.asarray` takes) into
    `module`'s parameters and buffers; shapes must match exactly. The
    inverse of `export_model_vars`: `target_of(tensor)` names another
    tensor of the same shape to fill for each leaf (an optimizer moment),
    and `collections` selects the Flax collections loaded."""
    for path, mod in _leaf_modules(module):
        for coll, name, tensor, layout, _ in mod.flax_leaves():
            if coll not in collections:
                continue
            node = tree[coll]
            for key in path:
                node = node[key]
            dst = tensor if target_of is None else target_of(tensor)
            # Copy to the device first, then relayout there.
            src = torch.from_numpy(np.ascontiguousarray(node[name]))
            src = src.to(dst.device)
            if layout in _PERM:
                src = src.permute(*_PERM[layout])
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"{'/'.join([coll, *path, name])}: shape "
                                 f"{tuple(src.shape)} != {tuple(dst.shape)}")
            dst.copy_(src)
    return module


def leaf_tensors(module: torch.nn.Module, collections=("params", "batch_stats")):
    """[(Flax path, tensor)] of `module`'s leaves in `collections`, the
    paths ('params/res0/conv1/kernel', ...) as `export_model_vars` would
    name them."""
    return [("/".join([coll, *path, name]), tensor)
            for path, mod in _leaf_modules(module)
            for coll, name, tensor, *_ in mod.flax_leaves() if coll in collections]


@torch.no_grad()
def export_model_vars(module: torch.nn.Module, value_of=None,
                      collections=("params", "batch_stats")) -> dict:
    """`module`'s leaves as a Flax-layout tree of float32 NumPy arrays, the
    inverse of `load_model_vars`. `value_of(tensor)` substitutes another
    tensor of the same shape for each leaf (a gradient, an optimizer
    moment); `collections` selects the Flax collections exported."""
    tree = {}
    for path, mod in _leaf_modules(module):
        for coll, name, tensor, layout, _ in mod.flax_leaves():
            if coll not in collections:
                continue
            t = tensor if value_of is None else value_of(tensor)
            t = t.detach().float()
            if layout in _PERM:
                # Relayout on the tensor's own device: a strided copy of a
                # transposed 1.6 GB FC kernel on the host runs at ~0.1 GB/s.
                t = t.permute(*map(int, np.argsort(_PERM[layout]))).contiguous()
            # A CUDA tensor's .cpu() is a copy already; a CPU one may be the
            # module's own memory.
            arr = t.cpu().numpy()
            _node(tree, [coll, *path])[name] = arr.copy() if t.device.type == "cpu" else arr
    return tree
