"""Sky-dome geometry and the von Mises-Fisher sun-pose ground truth
(`skyhdr.ops.geometry`: `sphere2world`, `sunpose_bins`,
`positional_encoding`, `vmf_pdf`).

The panorama is an equirectangular sky dome: elevation 0-90 degrees top
down over `h` rows, azimuth 0-360 degrees over `w` columns; unit vectors
are (cos(phi)cos(theta), sin(phi), cos(phi)sin(theta)). `sunpose_bins` is a
NumPy copy; the tests hold it equal to the original.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

PI = np.pi


def sphere2world(x, y, h: int, w: int, skydome: bool = True) -> torch.Tensor:
    """Pixel coordinate (x, y) (tensors, broadcasting) -> unit vector [..., 3]."""
    x = torch.as_tensor(x, dtype=torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32)
    unit_w = 2.0 * PI / w
    unit_h = PI / (h * 2 if skydome else h)
    theta = (x - 0.5 * w) * unit_w
    phi = (h - y) * unit_h if skydome else (h * 0.5 - y) * unit_h
    return torch.stack([torch.cos(phi) * torch.cos(theta), torch.sin(phi),
                        torch.cos(phi) * torch.sin(theta)], dim=-1)


@functools.lru_cache(maxsize=None)
def sunpose_bins(h: int, w: int) -> np.ndarray:
    """[h*w, 3] bin-centre unit vectors, row-major over the panorama."""
    i = np.arange(h * w, dtype=np.float32)
    x = ((i + 1.0) - np.floor(i / w) * w - 1.0) * (360.0 / w) + 360.0 / (2.0 * w)
    y = np.floor(i / w) * (90.0 / h) + 90.0 / (2.0 * h)
    phi = y * (PI / 180.0)
    theta = (x - 180.0) * (PI / 180.0)
    return np.stack([np.cos(phi) * np.cos(theta), np.sin(phi),
                     np.cos(phi) * np.sin(theta)], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _bins_on(h: int, w: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(sunpose_bins(h, w)).to(device)


def positional_encoding(x: torch.Tensor, with_r: bool = False) -> torch.Tensor:
    """x [b, h, w, c] with coord-conv channels appended: the column and row
    grids on [-1, 1] and, with `with_r`, sqrt((gx - w/2)^2 + (gy - h/2)^2)
    of those [-1, 1] grids, as the JAX package builds it."""
    b, h, w, _ = x.shape
    gy, gx = torch.meshgrid(torch.linspace(-1.0, 1.0, h, device=x.device),
                            torch.linspace(-1.0, 1.0, w, device=x.device), indexing="ij")
    coords = [gx, gy]
    if with_r:
        coords.append(torch.sqrt((gx - w * 0.5) ** 2 + (gy - h * 0.5) ** 2))
    grid = torch.stack(coords, dim=-1).to(x.dtype)
    return torch.cat([x, grid.expand(b, h, w, len(coords))], dim=-1)


def vmf_pdf(x, y, h: int, w: int, kappa: float = 80.0, bins=None) -> torch.Tensor:
    """Discrete vMF PDF over the h*w bins for a sun at pixel (x, y); batched
    (x, y) broadcast to [..., h*w]. `bins` may be a precomputed
    `sunpose_bins(h, w)` table (NumPy or tensor). The max is subtracted
    before exp, as in the JAX package."""
    sp = sphere2world(x, y, h, w, skydome=True)
    if bins is None:
        bins = _bins_on(h, w, sp.device)
    else:
        bins = torch.as_tensor(bins, dtype=torch.float32, device=sp.device)
    dots = kappa * (sp @ bins.T)
    pdf = torch.exp(dots - dots.amax(dim=-1, keepdim=True))
    return pdf / pdf.sum(dim=-1, keepdim=True)


def sunpose_gt_from_elevation(model_cfg, elevation: torch.Tensor) -> torch.Tensor:
    """`skyhdr.train.engine._sunpose_gt_from_elevation`: the vMF ground truth
    [b, h*w] with the azimuth pinned to column w*0.5-1 (the data loader
    rolls the sun there)."""
    h, w = model_cfg.im_height, model_cfg.im_width
    azimuth = torch.full_like(elevation, w * 0.5 - 1.0)
    return vmf_pdf(azimuth, elevation, h, w, kappa=model_cfg.vmf_kappa)
