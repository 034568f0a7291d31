"""Bilinear resize of NHWC tensors (`skyhdr.ops.resize.resize_bilinear`).

TF2's default bilinear map: half-pixel centres, source coordinate
(dst + 0.5) * (in / out) - 0.5 clamped to [0, in - 1], no antialiasing. The
JAX package computes this one linear map in three TPU speed forms (a dilated
depthwise conv, a phase interleave, two interpolation matmuls); here it is
one two-tap gather-and-blend per axis.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _taps(n_in: int, n_out: int, device: torch.device):
    """(i0, i1, w1) for each output index, as device tensors built once:
    out = (1-w1) x[i0] + w1 x[i1]."""
    src = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    src = np.clip(src, 0.0, n_in - 1)
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    w1 = (src - i0).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (i0, i1, w1))


def _resize_axis(x: torch.Tensor, axis: int, n_out: int) -> torch.Tensor:
    i0, i1, w1 = _taps(x.shape[axis], n_out, x.device)
    shape = [1] * x.dim()
    shape[axis] = n_out
    w1 = w1.reshape(shape)
    x0 = x.index_select(axis, i0)
    x1 = x.index_select(axis, i1)
    return ((1 - w1) * x0 + w1 * x1).to(x.dtype)


def resize_bilinear(img: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Resize [..., h, w, c] -> [..., H, W, c]."""
    H, W = int(size[0]), int(size[1])
    out = img
    if out.shape[-3] != H:
        out = _resize_axis(out, out.dim() - 3, H)
    if out.shape[-2] != W:
        out = _resize_axis(out, out.dim() - 2, W)
    return out
