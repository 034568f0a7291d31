"""JPEG round-trip model (`skyhdr.ops.jpeg`): 8-bit quantisation, JFIF
YCbCr, optional 4:2:0 chroma subsampling, blockwise 8x8 DCT quantisation
with IJG-scaled Annex K tables per sample, and back to RGB in [0, 1].

`torch.round` rounds half to even, as `jnp.round` does. A DCT coefficient
that lies exactly on a .5 quantisation step can still round the other way
when the two packages sum the DCT in another order; the tests state their
tolerance for that.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_Q_LUMA = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], np.float32)

_Q_CHROMA = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
], np.float32)


def _dct8() -> np.ndarray:
    """Orthonormal 8-point DCT-II matrix."""
    k = np.arange(8)
    m = np.cos(np.pi * (2 * k[None, :] + 1) * k[:, None] / 16.0)
    m[0] *= 1.0 / np.sqrt(2.0)
    return (m * 0.5).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _const(name: str, device: torch.device) -> torch.Tensor:
    arr = {"dct": _dct8(), "luma": _Q_LUMA, "chroma": _Q_CHROMA}[name]
    return torch.from_numpy(arr).to(device)


def quant_table(quality, base: torch.Tensor) -> torch.Tensor:
    """IJG quality scaling of an 8x8 base table, batched: quality [b] ->
    [b, 8, 8]."""
    q = torch.clamp(quality.float(), 1.0, 100.0)
    scale = torch.where(q < 50.0, 5000.0 / q, 200.0 - 2.0 * q)
    t = torch.floor((base * scale[:, None, None] + 50.0) / 100.0)
    return torch.clamp(t, 1.0, 255.0)


def _rgb_to_ycbcr(rgb):
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0
    return y, cb, cr


def _ycbcr_to_rgb(y, cb, cr):
    cb = cb - 128.0
    cr = cr - 128.0
    return torch.stack([y + 1.402 * cr, y - 0.344136 * cb - 0.714136 * cr,
                        y + 1.772 * cb], dim=-1)


def _quantize_plane(plane, qtab):
    """DCT -> quantise -> dequantise -> IDCT of a [b, h, w] plane with a
    per-sample [b, 8, 8] table."""
    b, h, w = plane.shape
    d = _const("dct", plane.device)
    blocks = (plane - 128.0).reshape(b, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4)
    coef = torch.einsum("ij,bmnjk,lk->bmnil", d, blocks, d)
    q = qtab[:, None, None, :, :]
    coef = torch.round(coef / q) * q
    rec = torch.einsum("ji,bmnjk,kl->bmnil", d, coef, d)
    return rec.permute(0, 1, 3, 2, 4).reshape(b, h, w) + 128.0


def jpeg_simulate(img01, quality, chroma_subsample: bool = True):
    """img01 [b, h, w, 3] in [0, 1] (h, w multiples of 8, of 16 with
    subsampling), quality [b] in [1, 100] -> [b, h, w, 3] in [0, 1]."""
    b, h, w, _ = img01.shape
    x = torch.round(torch.clamp(img01, 0.0, 1.0) * 255.0)
    y, cb, cr = _rgb_to_ycbcr(x)
    qy = quant_table(quality, _const("luma", x.device))
    qc = quant_table(quality, _const("chroma", x.device))
    y = _quantize_plane(y, qy)
    if chroma_subsample:
        def down(p):
            return p.reshape(b, h // 2, 2, w // 2, 2).mean(dim=(2, 4))

        def up(p):
            return p.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)

        cb = up(_quantize_plane(down(cb), qc))
        cr = up(_quantize_plane(down(cr), qc))
    else:
        cb = _quantize_plane(cb, qc)
        cr = _quantize_plane(cr, qc)
    rgb = torch.clamp(torch.round(_ycbcr_to_rgb(y, cb, cr)), 0.0, 255.0)
    return rgb / 255.0
