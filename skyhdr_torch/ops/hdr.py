"""mu-law HDR log compression and the colour helpers (`skyhdr.ops.hdr`):
BT.2020 luma and the RGB <-> BGR channel flips."""

from __future__ import annotations

import math

import torch


def hdr_log_compression(x: torch.Tensor, valid_dr: float = 10.0) -> torch.Tensor:
    """y = log(1 + valid_dr * x) / log(1 + valid_dr)."""
    return torch.log1p(valid_dr * x) / math.log1p(valid_dr)


def hdr_log_decompression(x: torch.Tensor, valid_dr: float = 10.0) -> torch.Tensor:
    """Inverse of `hdr_log_compression`."""
    return torch.expm1(x * math.log1p(valid_dr)) / valid_dr


def rgb2gray(rgb: torch.Tensor) -> torch.Tensor:
    """BT.2020 luma of an RGB image [..., 3], keeping the channel: [..., 1]."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return (0.2627 * r + 0.6780 * g + 0.0593 * b)[..., None]


def rgb2bgr(rgb: torch.Tensor) -> torch.Tensor:
    """Channel flip of [..., 3]."""
    return torch.flip(rgb, (-1,))


def bgr2rgb(bgr: torch.Tensor) -> torch.Tensor:
    """Channel flip of [..., 3]."""
    return torch.flip(bgr, (-1,))
