"""Parameter dtype casts (`skyhdr.utils.params`: `cast_floating`,
`cast_model_vars`)."""

from __future__ import annotations

import numpy as np
import torch


def _torch_dtype(dtype) -> torch.dtype:
    """A torch dtype, its name ("bfloat16") or a NumPy dtype as a torch dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, dtype if isinstance(dtype, str) else np.dtype(dtype).name)


def cast_floating(tree, dtype):
    """A copy of `tree` (nested dicts, lists and tuples, such as a
    `state_dict` or an exported Flax-layout tree) with every floating leaf
    cast to `dtype`: torch tensors with `.to`, NumPy arrays with `astype`
    (NumPy has no bfloat16: such a leaf raises TypeError). Integer and bool
    leaves (step counters, masks) and non-array leaves pass unchanged."""
    dtype = _torch_dtype(dtype)

    def cast(x):
        if isinstance(x, dict):
            return type(x)((k, cast(v)) for k, v in x.items())
        if isinstance(x, (list, tuple)):
            return type(x)(cast(v) for v in x)
        if isinstance(x, torch.Tensor):
            return x.to(dtype) if x.is_floating_point() else x
        if isinstance(x, np.ndarray) and np.issubdtype(x.dtype, np.floating):
            if dtype == torch.bfloat16:
                raise TypeError("NumPy has no bfloat16: cast a torch tensor instead")
            return x.astype(torch.empty((), dtype=dtype).numpy().dtype)
        return x

    return cast(tree)


@torch.no_grad()
def cast_model_vars(module: torch.nn.Module, dtype) -> torch.nn.Module:
    """Cast every floating parameter of `module` to `dtype` in place (the
    Flax `params` collection); buffers — the BatchNorm running moments, the
    Flax `batch_stats` — stay as they are. Used for `--weights-dtype`."""
    dtype = _torch_dtype(dtype)
    for p in module.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return module
