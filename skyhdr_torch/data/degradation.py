"""LDR degradation (`skyhdr.data.degradation`): HDR -> (exposed, noised HDR
target, degraded LDR input), on the device.

  1. exposure t from the bank;
  2. x = relu(hdr*t + z_s*sigma_s*(hdr*t) + z_c*sigma_c), with sigma_s and
     sigma_c uniform per (sample, channel) and z standard normal;
  3. clip to [0, 1];
  4. a camera response curve from the bank (Chebyshev form when the banks
     carry coefficients, as `make_banks` gives by default);
  5. 8-bit quantisation and the JPEG model at the quality ramp
     round(i/(b-1)*(hi-lo)+lo).

The random draws and their use are two functions: `draw_degradation`
takes them from a `torch.Generator` in the order the JAX package takes them
(exposure index, sigma_s, sigma_c, both noises, CRF index), and
`degrade_with` applies given draws. `jax.random` streams cannot be
reproduced in torch, so the tests feed JAX's draws to `degrade_with`.

In a width context (`ops.width`, the width-sharded train step) `hdr` is a
width shard: the draws are the whole panorama's (the per-pixel noise drawn
at its whole width), of which the shard keeps its columns, and the JPEG
model runs on the shard where its blocks (16 columns under chroma
subsampling, else 8) lie within it, else on the whole 3-channel image
gathered over the ring, of which the shard keeps its columns.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from skyhdr_torch.ops import width
from skyhdr_torch.ops.crf import apply_rf, apply_rf_chebyshev, chebyshev_fit
from skyhdr_torch.ops.jpeg import jpeg_simulate


class DegradationBanks(NamedTuple):
    """CRF curves [n, k], exposures [m] and, optionally, Chebyshev CRF
    coefficients [n, d], as device tensors."""

    crfs: torch.Tensor
    exposures: torch.Tensor
    crf_coeffs: Optional[torch.Tensor] = None


class Draws(NamedTuple):
    """One batch's random draws: indices [b], uniforms [b,1,1,3] (before
    scaling by sigma_*_scale), standard normals [b,h,w,3]."""

    t_idx: torch.Tensor
    u_s: torch.Tensor
    u_c: torch.Tensor
    z_s: torch.Tensor
    z_c: torch.Tensor
    crf_idx: torch.Tensor


def make_banks(crfs, exposures, fit_chebyshev: bool = True,
               device="cuda") -> DegradationBanks:
    coeffs = (torch.from_numpy(chebyshev_fit(crfs)).to(device)
              if fit_chebyshev else None)
    return DegradationBanks(torch.from_numpy(np.asarray(crfs, np.float32)).to(device),
                            torch.from_numpy(np.asarray(exposures, np.float32)).to(device),
                            coeffs)


def jpeg_quality_ramp(batch: int, lo: float = 90.0, hi: float = 100.0,
                      device="cpu") -> torch.Tensor:
    """Per-sample quality round(i/(b-1)*(hi-lo)+lo)."""
    i = torch.arange(batch, dtype=torch.float32, device=device)
    return torch.round(i / max(batch - 1, 1) * (hi - lo) + lo)


def draw_degradation(generator: torch.Generator, shape, banks: DegradationBanks) -> Draws:
    """The draws for an HDR batch of `shape` [b, h, w, 3], on the
    generator's device."""
    b = shape[0]
    kw = dict(generator=generator, device=generator.device)
    t_idx = torch.randint(0, banks.exposures.shape[0], (b,), **kw)
    u_s = torch.rand((b, 1, 1, 3), **kw)
    u_c = torch.rand((b, 1, 1, 3), **kw)
    z_s = torch.randn(tuple(shape), **kw)
    z_c = torch.randn(tuple(shape), **kw)
    crf_idx = torch.randint(0, banks.crfs.shape[0], (b,), **kw)
    return Draws(t_idx, u_s, u_c, z_s, z_c, crf_idx)


def shard_rows(draws: Draws, index: int, count: int) -> Draws:
    """Shard `index` of `count` equal shards of a batch's draws."""
    b = draws.t_idx.shape[0] // count
    return Draws(*(t[index * b:(index + 1) * b] for t in draws))


def shard_cols(draws: Draws, cols: slice) -> Draws:
    """The draws of a width shard: the noises' columns `cols`."""
    return draws._replace(z_s=draws.z_s[:, :, cols], z_c=draws.z_c[:, :, cols])


def _jpeg(ldr, quality, chroma_subsample: bool):
    """`jpeg_simulate` of ldr, a width shard in a width context: on the
    shard where whole JPEG blocks tile it, else on the gathered image."""
    ring = width.current()
    if ring is None or ldr.shape[2] % (16 if chroma_subsample else 8) == 0:
        return jpeg_simulate(ldr, quality, chroma_subsample=chroma_subsample)
    full = jpeg_simulate(ring.gather(ldr), quality, chroma_subsample=chroma_subsample)
    return full[:, :, ring.cols(full.shape[2])].contiguous()


def degrade_with(hdr, banks: DegradationBanks, draws: Draws, *,
                 jpeg_lo: float = 90.0, jpeg_hi: float = 100.0,
                 sigma_s_scale: float = 0.08 / 6.0, sigma_c_scale: float = 0.005,
                 chroma_subsample: bool = True, shard=(0, 1)):
    """hdr [b, h, w, 3] -> (hdr_t, ldr) with the given draws. `shard`
    (index, count): the samples are shard `index` of a batch `count` times
    b, whose JPEG quality ramp they take their rows of."""
    b = hdr.shape[0]
    hdr_t = hdr * banks.exposures[draws.t_idx].reshape(b, 1, 1, 1)
    noise_s = draws.z_s * (sigma_s_scale * draws.u_s * hdr_t)
    noise_c = draws.z_c * (sigma_c_scale * draws.u_c)
    hdr_t = torch.relu(hdr_t + noise_s + noise_c)
    clipped = torch.clamp(hdr_t, 0.0, 1.0)
    if banks.crf_coeffs is not None:
        ldr = apply_rf_chebyshev(clipped, banks.crf_coeffs[draws.crf_idx])
    else:
        ldr = apply_rf(clipped, banks.crfs[draws.crf_idx])
    index, count = shard
    quality = jpeg_quality_ramp(b * count, jpeg_lo, jpeg_hi, hdr.device)[index * b:(index + 1) * b]
    return hdr_t, _jpeg(ldr, quality, chroma_subsample)


def degrade_batch(generator: torch.Generator, hdr, banks: DegradationBanks,
                  shard=(0, 1), **kw):
    """Draw, then degrade: `skyhdr.data.degradation.degrade_batch` with a
    torch.Generator in place of the key. `shard` (index, count): `hdr` is
    shard `index` of a batch `count` times its size (a data-parallel
    rank's); the draws and the JPEG quality ramp are the whole batch's, of
    which the shard takes its rows, so that each sample degrades as it
    would in the whole batch. In a width context `hdr` is a width shard and
    the draws are the whole panorama's, of which it keeps its columns."""
    index, count = shard
    ring = width.current()
    b, h, w, c = hdr.shape
    w_full = w if ring is None else w * ring.n
    draws = shard_rows(draw_degradation(generator, (b * count, h, w_full, c), banks), index,
                       count)
    if ring is not None:
        draws = shard_cols(draws, ring.cols(w_full))
    return degrade_with(hdr, banks, draws, shard=shard, **kw)
