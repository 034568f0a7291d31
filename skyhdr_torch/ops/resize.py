"""Bilinear resize of NHWC tensors (`skyhdr.ops.resize.resize_bilinear`).

TF2's default bilinear map: half-pixel centres, source coordinate
(dst + 0.5) * (in / out) - 0.5 clamped to [0, in - 1], no antialiasing. The
JAX package computes this one linear map in three forms, and in bfloat16
each rounds in its own places, which the port follows:

  - an integer upscale of a 4-d tensor with >= 8 channels (the decoders'
    resize-deconvs): one dilated depthwise conv over the input edge-padded
    by one, accumulated in float32 and rounded to the input's dtype once;
    its gradient likewise, then the pad's gradient added into the edge in
    the input's dtype (`_upsample_2d`);
  - any other integer upscale (the Grad-CAM maps, c = 1): per axis, each
    output phase (1 - t) x[lo] + t x[hi] in the input's dtype, every
    operation rounding (`_upsample_axis_int`);
  - otherwise two interpolation matrices; here a two-tap gather-and-blend
    per axis, rounded per axis (`_resize_axis`).

A bfloat16 resize rounded per axis instead of once moved 28% of a
resize-deconv's outputs by one ulp (ROADMAP Queue 3, F3).

In a width context (`ops.width`) the image is a width shard and `size` the
whole panorama's: an integer upscale reads one column of each ring
neighbour where it reads past the shard, and the edge pad stays at the
panorama's two ends (`WidthRing.halo`, "edge").
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from skyhdr_torch.ops import width


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


def _phase_taps(s: int):
    """Per output phase r of an integer upscale by s: the offset of its low
    source sample (-1 or 0) and the weight t of the high one."""
    out = []
    for r in range(s):
        f = (r + 0.5) / s - 0.5
        out.append((-1, 1.0 + f) if f < 0 else (0, f))
    return out


def _interleave(phases, axis: int) -> torch.Tensor:
    return torch.stack(phases, dim=axis + 1).flatten(axis, axis + 1)


def _edge_pad(x: torch.Tensor, axis: int, ring=None) -> torch.Tensor:
    """x with its first and last slice along `axis` repeated once outside,
    by concatenation (`jnp.pad(mode="edge")`: its gradient adds the pad's
    into the edge in x's dtype); with `ring` (x a width shard along
    `axis`), the neighbours' columns, the edge at the panorama's ends."""
    if ring is not None:
        return ring.halo(x, 1, 1, "edge", axis)
    n = x.shape[axis]
    return torch.cat([x.narrow(axis, 0, 1), x, x.narrow(axis, n - 1, 1)], dim=axis)


def _upsample_2d(x: torch.Tensor, sh: int, sw: int, ring=None) -> torch.Tensor:
    """[b, h, w, c] -> [b, sh h, sw w, c] as `skyhdr`'s dilated depthwise
    conv: the input edge-padded by one along each upscaled axis (in its
    dtype), the two-tap blends in float32 (exact for bfloat16 inputs), one
    rounding to x's dtype. `ring`: x is a width shard (`_edge_pad`)."""
    out = x
    for axis, s in ((1, sh), (2, sw)):
        if s > 1:
            out = _edge_pad(out, axis, ring if axis == 2 else None)
    out = out.float()
    for axis, s in ((1, sh), (2, sw)):
        if s > 1:
            n = out.shape[axis] - 2
            out = _interleave([(1.0 - t) * out.narrow(axis, 1 + lo, n)
                               + t * out.narrow(axis, 2 + lo, n)
                               for lo, t in _phase_taps(s)], axis)
    return out.to(x.dtype)


def _upsample_axis_int(x: torch.Tensor, axis: int, s: int, ring=None) -> torch.Tensor:
    """An integer upscale by s along `axis` in x's dtype, each phase (1 - t)
    x[clip(i + lo)] + t x[clip(i + lo + 1)] (`skyhdr`'s phase interleave).
    `ring`: x is a width shard along `axis` (`_edge_pad`)."""
    n = x.shape[axis]
    if ring is None:
        shifted = {-1: torch.cat([x.narrow(axis, 0, 1), x.narrow(axis, 0, n - 1)], dim=axis),
                   0: x,
                   1: torch.cat([x.narrow(axis, 1, n - 1), x.narrow(axis, n - 1, 1)], dim=axis)}
    else:
        xe = _edge_pad(x, axis, ring)
        shifted = {-1: xe.narrow(axis, 0, n), 0: x, 1: xe.narrow(axis, 2, n)}
    return _interleave([(1.0 - t) * shifted[lo] + t * shifted[lo + 1]
                        for lo, t in _phase_taps(s)], axis)


def resize_bilinear(img: torch.Tensor, size: Sequence[int]) -> torch.Tensor:
    """Resize [..., h, w, c] -> [..., H, W, c]; in a width context img is a
    width shard [b, h, w_local, c] of a panorama of width w_local * n and
    (H, W) the whole result's size (an integer upscale)."""
    H, W = int(size[0]), int(size[1])
    ring = width.current()
    h, w = img.shape[-3], img.shape[-2] * (1 if ring is None else ring.n)
    if (h, w) == (H, W):
        return img
    if H % h == 0 and W % w == 0 and H >= h and W >= w:
        if img.dim() == 4 and img.shape[-1] >= 8:
            return _upsample_2d(img, H // h, W // w, ring)
        out = img
        if H > h:
            out = _upsample_axis_int(out, out.dim() - 3, H // h)
        if W > w:
            out = _upsample_axis_int(out, out.dim() - 2, W // w, ring)
        return out
    if ring is not None:
        raise ValueError(f"a resize of a width shard from {(h, w)} to {(H, W)}: an integer "
                         "upscale only")
    out = img
    if out.shape[-3] != H:
        out = _resize_axis(out, out.dim() - 3, H)
    if out.shape[-2] != W:
        out = _resize_axis(out, out.dim() - 2, W)
    return out
