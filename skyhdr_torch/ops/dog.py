"""Difference-of-Gaussian L1 loss (`skyhdr.ops.dog.dog_l1_loss`, the
band-matrix form the train step runs).

The DoG pyramid (2x half-pixel upsample, a base 3x3 Gaussian blur, then four
bands blur(sigma2) - blur(sigma1), every blur with REFLECT padding) is linear
along each axis, so it composes into one [2n, n] base operator and eight
[2n, 2n] band operators per axis, and DoG(pred) - DoG(target) =
DoG(pred - target). The operator builders are NumPy copies of the JAX
package's (`_dog_axis_operators` and the `_interp_matrix` it reads); the
products are plain einsums, as the JAX package leaves them to XLA.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

BASE_SIGMA = 1.2489996
SIGMAS_1 = (1.2262735, 1.5450078, 1.9465878, 2.452547)
SIGMAS_2 = (1.5450078, 1.9465878, 2.452547, 3.0900156)


def _interp_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] bilinear interpolation matrix with half-pixel centres
    (`skyhdr.ops.resize._interp_matrix`)."""
    if n_in == n_out:
        return np.eye(n_in, dtype=np.float32)
    src = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    src = np.clip(src, 0.0, n_in - 1)
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    w1 = src - i0
    m = np.zeros((n_out, n_in), dtype=np.float64)
    m[np.arange(n_out), i0] += 1.0 - w1
    m[np.arange(n_out), i1] += w1
    return m.astype(np.float32)


def _gaussian_1d(ksize: int, sigma: float) -> np.ndarray:
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return g / g.sum()


@functools.lru_cache(maxsize=None)
def dog_axis_operators(n: int, ksize: int = 3):
    """(A0 [2n, n], S [8, 2n, 2n]) float32: the upsample + reflect-pad + base
    blur chain, and the eight band blurs (SIGMAS_1 then SIGMAS_2) with their
    reflect pads, along one axis."""
    m = 2 * n
    pad = ksize // 2
    idx = np.pad(np.arange(m), (pad, pad), mode="reflect")
    R = np.zeros((m + 2 * pad, m), np.float64)
    R[np.arange(m + 2 * pad), idx] = 1.0

    def blur_mat(sigma):
        g = _gaussian_1d(ksize, float(sigma))
        D = np.zeros((m, m + 2 * pad), np.float64)
        for t in range(ksize):
            D[np.arange(m), np.arange(m) + t] += g[t]
        return D @ R

    U = _interp_matrix(n, m).astype(np.float64)
    A0 = (blur_mat(BASE_SIGMA) @ U).astype(np.float32)
    S = np.stack([blur_mat(s) for s in SIGMAS_1 + SIGMAS_2]).astype(np.float32)
    return A0, S


@functools.lru_cache(maxsize=None)
def _operators_on(n: int, ksize: int, device: torch.device):
    return tuple(torch.from_numpy(a).to(device) for a in dog_axis_operators(n, ksize))


def dog_l1_loss(pred, target, ksize: int = 3):
    """Sum over the four DoG bands of mean |DoG(pred) - DoG(target)|."""
    d = pred - target
    A0h, Sh = _operators_on(d.shape[1], ksize, d.device)
    A0w, Sw = _operators_on(d.shape[2], ksize, d.device)
    y = torch.einsum("Hh,bhwc->bHwc", A0h, d)
    y = torch.einsum("Ww,bHwc->bHWc", A0w, y)
    z = torch.einsum("jKH,bHWc->bjKWc", Sh, y)
    z = torch.einsum("jLW,bjKWc->bjKLc", Sw, z)
    return 4.0 * torch.mean(torch.abs(z[:, 4:] - z[:, :4]))
