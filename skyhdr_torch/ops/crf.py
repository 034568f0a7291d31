"""Camera response functions (`skyhdr.ops.crf`).

`apply_rf` is the exact per-sample LUT interpolation. `chebyshev_fit` (a
NumPy copy) fits each curve with a degree-31 Chebyshev series in the warped
domain u = x^(1/4), and `apply_rf_chebyshev` evaluates it by Clenshaw's
recurrence. The degradation uses the Chebyshev form, as the JAX package
does by default (`make_banks(fit_chebyshev=True)`), so both packages feed
the model the same LDR.
"""

from __future__ import annotations

import numpy as np
import torch

CRF_WARP = 4.0


def interp1d_batched(curves, pos):
    """Linear interpolation into per-batch curves [b, k] at fractional
    positions pos [b, n] in [0, k-1], clamped to the edges."""
    k = curves.shape[-1]
    i0 = torch.floor(pos)
    w1 = pos - i0
    i0c = torch.clamp(i0.long(), 0, k - 1)
    i1c = torch.clamp(i0.long() + 1, 0, k - 1)
    v0 = torch.gather(curves, -1, i0c)
    v1 = torch.gather(curves, -1, i1c)
    return (1.0 - w1) * v0 + w1 * v1


def apply_rf(x, rf):
    """Exact per-sample response curves rf [b, k] applied to x [b, ...] in
    [0, 1]."""
    b, k = x.shape[0], rf.shape[-1]
    out = interp1d_batched(rf, (k - 1.0) * x.reshape(b, -1))
    return out.reshape(x.shape)


def chebyshev_fit(curves: np.ndarray, degree: int = 31,
                  warp: float = CRF_WARP) -> np.ndarray:
    """Least-squares Chebyshev coefficients [n, degree+1] per curve [n, k]
    (samples on a uniform grid of [0, 1]) in the warped domain u = x^(1/warp)."""
    curves = np.asarray(curves, np.float64)
    k = curves.shape[1]
    xs = np.linspace(0.0, 1.0, k)
    u = np.linspace(0.0, 1.0, 4096)
    resampled = np.stack([np.interp(u ** warp, xs, c) for c in curves])
    v = np.polynomial.chebyshev.chebvander(2.0 * u - 1.0, degree)
    coeffs, *_ = np.linalg.lstsq(v, resampled.T, rcond=None)
    return np.ascontiguousarray(coeffs.T.astype(np.float32))


def apply_rf_chebyshev(x, coeffs, warp: float = CRF_WARP):
    """Per-sample Chebyshev CRFs coeffs [b, d] at x [b, ...] in [0, 1]."""
    t = 2.0 * torch.pow(torch.clamp(x, min=0.0), 1.0 / warp) - 1.0
    c = coeffs.reshape(coeffs.shape + (1,) * (x.dim() - 1))
    b1 = torch.zeros_like(x)
    b2 = torch.zeros_like(x)
    for i in range(coeffs.shape[-1] - 1, 0, -1):
        b1, b2 = c[:, i] + 2.0 * t * b1 - b2, b1
    return c[:, 0] + t * b1 - b2
