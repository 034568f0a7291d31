"""mu-law HDR log compression (`skyhdr.ops.hdr`)."""

from __future__ import annotations

import math

import torch


def hdr_log_compression(x: torch.Tensor, valid_dr: float = 10.0) -> torch.Tensor:
    """y = log(1 + valid_dr * x) / log(1 + valid_dr)."""
    return torch.log1p(valid_dr * x) / math.log1p(valid_dr)


def hdr_log_decompression(x: torch.Tensor, valid_dr: float = 10.0) -> torch.Tensor:
    """Inverse of `hdr_log_compression`."""
    return torch.expm1(x * math.log1p(valid_dr)) / valid_dr
