"""Difference-of-Gaussian L1 loss (`skyhdr.ops.dog.dog_l1_loss`, the
band-matrix form the train step runs), and the depthwise-conv forms of the
same pyramid (`gaussian_filter2d`, `dog_pyramid`, `dog_l1_loss_conv`,
which no step calls: the JAX package keeps them as the cross-check of the
matrix form, and runs them as XLA convs outside any Pallas kernel, so here
they are `F.conv2d(groups=c)`).

The DoG pyramid (2x half-pixel upsample, a base 3x3 Gaussian blur, then four
bands blur(sigma2) - blur(sigma1), every blur with REFLECT padding) is linear
along each axis, so it composes into one [2n, n] base operator and eight
[2n, 2n] band operators per axis, and DoG(pred) - DoG(target) =
DoG(pred - target). The operator builders are NumPy copies of the JAX
package's (`_dog_axis_operators` and the `_interp_matrix` it reads); the
products are plain einsums, as the JAX package leaves them to XLA.

In a width context (`ops.width`) the bands mix the whole width, so the
difference (3 channels) is gathered over the ring, the loss computed whole
on every process, and each process's share is the loss over the ring's
size (the gather's gradient, summed over the ring, gives each its
columns').
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from skyhdr_torch.ops import width
from skyhdr_torch.ops.resize import resize_bilinear

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
def _gaussian_kernel_2d(ksize: int, sigma: float) -> np.ndarray:
    """The normalised 2-D Gaussian [k, k] float32 (tfa.image.gaussian_filter2d's
    truncated-and-normalised construction)."""
    g = _gaussian_1d(ksize, sigma)
    k = np.outer(g, g)
    return (k / k.sum()).astype(np.float32)


_PAD_MODES = {"REFLECT": "reflect", "SYMMETRIC": "symmetric", "CONSTANT": "constant"}


def _pad_hw(img: torch.Tensor, pad: int, padding: str) -> torch.Tensor:
    """img [b, h, w, c] padded by `pad` on both sides of h and w: REFLECT
    and SYMMETRIC (NumPy's modes; F.pad has no symmetric one) by index,
    CONSTANT with zeros."""
    mode = _PAD_MODES[padding]
    if mode == "constant":
        return F.pad(img, (0, 0, pad, pad, pad, pad))
    for dim in (1, 2):
        idx = np.pad(np.arange(img.shape[dim]), (pad, pad), mode=mode)
        img = img.index_select(dim, torch.from_numpy(idx).to(img.device))
    return img


def _depthwise(x: torch.Tensor, kernels, pad: int, padding: str) -> torch.Tensor:
    """Each channel of x [b, h, w, c] blurred by every [k, k] kernel of
    `kernels` [m, k, k] after padding: [b, h, w, c * m], channel ci * m + j
    the j-th kernel's blur of channel ci (a channel multiplier m)."""
    c = x.shape[-1]
    m, k, _ = kernels.shape
    weight = torch.from_numpy(np.ascontiguousarray(np.tile(kernels, (c, 1, 1))))
    weight = weight.reshape(c * m, 1, k, k).to(x.device, x.dtype)
    xp = _pad_hw(x, pad, padding).permute(0, 3, 1, 2)
    return F.conv2d(xp, weight, groups=c).permute(0, 2, 3, 1)


def gaussian_filter2d(img: torch.Tensor, ksize: int = 3, sigma: float = 1.0,
                      padding: str = "REFLECT") -> torch.Tensor:
    """Depthwise Gaussian blur of img [b, h, w, c] with a static kernel,
    padded by ksize // 2 (`padding`: REFLECT, SYMMETRIC or CONSTANT)."""
    kern = _gaussian_kernel_2d(ksize, float(sigma))[None]
    return _depthwise(img, kern, ksize // 2, padding)


def dog_pyramid(img: torch.Tensor, ksize: int = 3):
    """The four DoG bands of img [b, h, w, c]: a 2x upsample, the base blur,
    then blur(sigma2_i) - blur(sigma1_i); a tuple of four [b, 2h, 2w, c]."""
    h, w = img.shape[1], img.shape[2]
    base = gaussian_filter2d(resize_bilinear(img, (2 * h, 2 * w)), ksize, BASE_SIGMA)
    return tuple(gaussian_filter2d(base, ksize, s2) - gaussian_filter2d(base, ksize, s1)
                 for s1, s2 in zip(SIGMAS_1, SIGMAS_2))


def dog_l1_loss_conv(pred: torch.Tensor, target: torch.Tensor, ksize: int = 3):
    """`dog_l1_loss` by depthwise convs: pred and target batched together,
    upsampled, base-blurred, then all eight band blurs as ONE depthwise conv
    with channel multiplier 8 (channel ci * 8 + j: blur j of channel ci,
    SIGMAS_1 then SIGMAS_2); the sum over the bands of mean |DoG(pred) -
    DoG(target)|."""
    b = pred.shape[0]
    both = torch.cat([pred, target], dim=0)
    h, w, c = both.shape[1:]
    base = gaussian_filter2d(resize_bilinear(both, (2 * h, 2 * w)), ksize, BASE_SIGMA)
    bands = np.stack([_gaussian_kernel_2d(ksize, float(s)) for s in SIGMAS_1 + SIGMAS_2])
    blurred = _depthwise(base, bands, ksize // 2, "REFLECT").reshape(2 * b, 2 * h, 2 * w, c, 8)
    dog = blurred[..., 4:] - blurred[..., :4]
    return torch.abs(dog[:b] - dog[b:]).mean(dim=(0, 1, 2, 3)).sum()


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
    ring = width.current()
    if ring is not None:
        return _dog_l1(ring.gather(d), ksize) / ring.n
    return _dog_l1(d, ksize)


def _dog_l1(d, ksize: int):
    A0h, Sh = _operators_on(d.shape[1], ksize, d.device)
    A0w, Sw = _operators_on(d.shape[2], ksize, d.device)
    y = torch.einsum("Hh,bhwc->bHwc", A0h, d)
    y = torch.einsum("Ww,bHwc->bHWc", A0w, y)
    z = torch.einsum("jKH,bHWc->bjKWc", Sh, y)
    z = torch.einsum("jLW,bjKWc->bjKLc", Sw, z)
    return 4.0 * torch.mean(torch.abs(z[:, 4:] - z[:, :4]))
