"""The plain on-disk form in which a checkpoint of the JAX package crosses
to the port: Orbax cannot be read without JAX (it goes through
tensorstore), and the card's machine has neither. So a conversion is two
steps that meet here. `tools/export_jax_checkpoint.py` writes an export
where `skyhdr` runs; `skyhdr_torch.cli.import_checkpoint` reads it on the
card. This module imports numpy, json and os only, so that the JAX side
can use it without torch.

An export is a directory:

  manifest.json       — `format`, `version`, the state's `kind` ("gan" or
                        "sun"), `orbax_step` (the Orbax step it came
                        from), `step`,
                        `epoch`, Adam's `count` (null for "gan"), the model
                        shape (`im_height`, `im_width`, `use_da_conv`,
                        `da_kernel_size`), the dtypes found (`param_dtype`,
                        and `opt_state_dtype`, the moments'), and `leaves`:
                        per leaf path its original `dtype` and its `shape`;
  <leaf path>.npy     — one array per leaf, at the leaf's Flax path:
                        `gen_vars/params/res0/conv1/kernel.npy`,
                        `opt_gen/nu/1/fc1/kernel.npy`, and under bfloat16
                        parameters the float32 master,
                        `opt_gen/master/1/fc1/kernel.npy`, ...

numpy has no bfloat16 without `ml_dtypes`, which the card's machine may
lack, so a bfloat16 leaf is stored upcast to float32 (exact) and the
manifest keeps its original dtype. The manifest is written last: a
directory without one is not an export.
"""

from __future__ import annotations

import json
import os

import numpy as np

FORMAT = "skyhdr-flax-export"
VERSION = 1
MANIFEST = "manifest.json"


def _leaf_file(directory: str, path: str) -> str:
    parts = path.split("/")
    if not path or any(p in ("", ".", "..") for p in parts):
        raise ValueError(f"bad leaf path {path!r}")
    return os.path.join(directory, *parts) + ".npy"


def flatten(tree, prefix: str = "") -> dict:
    """{'a/b/c': leaf} of a nested dict (keys joined by '/', under
    `prefix`)."""
    out = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            out.update(flatten(value, path))
        else:
            out[path] = value
    return out


def unflatten(leaves: dict, prefix: str) -> dict:
    """The nested dict of the leaves under `prefix` (the inverse of
    `flatten(tree, prefix)`)."""
    tree = {}
    for path, value in leaves.items():
        if not path.startswith(prefix + "/"):
            continue
        *keys, name = path[len(prefix) + 1:].split("/")
        node = tree
        for key in keys:
            node = node.setdefault(key, {})
        node[name] = value
    return tree


def write_export(directory: str, manifest: dict, leaves: dict) -> None:
    """Write `leaves` ({path: array}) and `manifest` (the keys above but
    `format`, `version` and `leaves`, which this adds) to the new directory
    `directory`."""
    os.makedirs(directory)
    entries = {}
    for path, value in leaves.items():
        arr = np.asarray(value)
        dtype = arr.dtype.name
        if dtype == "bfloat16":
            arr = arr.astype(np.float32)
        file = _leaf_file(directory, path)
        os.makedirs(os.path.dirname(file), exist_ok=True)
        np.save(file, arr, allow_pickle=False)
        entries[path] = {"dtype": dtype, "shape": list(arr.shape)}
    with open(os.path.join(directory, MANIFEST), "w") as f:
        json.dump(dict(manifest, format=FORMAT, version=VERSION, leaves=entries),
                  f, indent=1, sort_keys=True)


def read_export(directory: str):
    """(manifest, {path: array}) of an export. The arrays map their files
    copy-on-write (the files are never written; torch takes only writable
    arrays), so that the host holds no second copy of a state (9.7 GB for a
    SunState at 64x256)."""
    with open(os.path.join(directory, MANIFEST)) as f:
        manifest = json.load(f)
    if manifest.get("format") != FORMAT or manifest.get("version") != VERSION:
        raise ValueError(f"{directory}: not a {FORMAT} version {VERSION} export "
                         f"(format {manifest.get('format')!r}, version "
                         f"{manifest.get('version')!r})")
    leaves = {}
    for path, entry in manifest["leaves"].items():
        arr = np.load(_leaf_file(directory, path), mmap_mode="c", allow_pickle=False)
        if list(arr.shape) != entry["shape"]:
            raise ValueError(f"{path}: shape {list(arr.shape)} on disk, "
                             f"{entry['shape']} in the manifest")
        leaves[path] = arr
    return manifest, leaves
