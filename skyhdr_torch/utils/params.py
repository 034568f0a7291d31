"""Parameter dtype casts (`skyhdr.utils.params.cast_model_vars`)."""

from __future__ import annotations

import torch


@torch.no_grad()
def cast_model_vars(module: torch.nn.Module, dtype) -> torch.nn.Module:
    """Cast every floating parameter of `module` to `dtype` in place (the
    Flax `params` collection); buffers — the BatchNorm running moments, the
    Flax `batch_stats` — stay as they are. Used for `--weights-dtype`."""
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    for p in module.parameters():
        if p.is_floating_point():
            p.data = p.data.to(dtype)
    return module
