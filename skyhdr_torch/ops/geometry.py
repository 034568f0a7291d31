"""Sky-dome geometry and the von Mises-Fisher sun-pose ground truth
(`skyhdr.ops.geometry`: `sphere2world`, `sunpose_bins`, `vmf_pdf`).

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


def vmf_pdf(x, y, h: int, w: int, kappa: float = 80.0) -> torch.Tensor:
    """Discrete vMF PDF over the h*w bins for a sun at pixel (x, y); batched
    (x, y) broadcast to [..., h*w]. The max is subtracted before exp, as in
    the JAX package."""
    sp = sphere2world(x, y, h, w, skydome=True)
    dots = kappa * (sp @ _bins_on(h, w, sp.device).T)
    pdf = torch.exp(dots - dots.amax(dim=-1, keepdim=True))
    return pdf / pdf.sum(dim=-1, keepdim=True)


def sunpose_gt_from_elevation(model_cfg, elevation: torch.Tensor) -> torch.Tensor:
    """`skyhdr.train.engine._sunpose_gt_from_elevation`: the vMF ground truth
    [b, h*w] with the azimuth pinned to column w*0.5-1 (the data loader
    rolls the sun there)."""
    h, w = model_cfg.im_height, model_cfg.im_width
    azimuth = torch.full_like(elevation, w * 0.5 - 1.0)
    return vmf_pdf(azimuth, elevation, h, w, kappa=model_cfg.vmf_kappa)
