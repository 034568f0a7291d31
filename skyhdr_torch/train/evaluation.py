"""Eval metrics (`skyhdr.train.evaluation`): PSNR, si-RMSE (scale-invariant,
log domain) and EMD luminance, each per image of [b, h, w, c] batches. A
bf16 prediction against a float32 target gives float32 metrics."""

from __future__ import annotations

import torch

from skyhdr_torch.ops.emd import compare_luminance


def psnr(pred, target, max_val: float = None):
    """Per-image PSNR; `max_val` defaults to the maximum of the whole target
    batch, not of each image."""
    if max_val is None:
        max_val = torch.max(target)
    mse = torch.mean(torch.square(pred - target), dim=(1, 2, 3))
    return 10.0 * torch.log10((max_val ** 2) / torch.clamp(mse, min=1e-12))


def si_rmse(pred, target, eps: float = 1e-6):
    """Scale-invariant RMSE in log space (Eigen et al.): per image,
    sqrt(max(mean(d^2) - mean(d)^2, 0)) with d = log(pred) - log(target),
    in that form (not `torch.var`, which cancels another way)."""
    d = torch.log(torch.clamp(pred, min=eps)) - torch.log(torch.clamp(target, min=eps))
    d = d.reshape(d.shape[0], -1)
    return torch.sqrt(torch.clamp(torch.mean(d ** 2, -1) - torch.mean(d, -1) ** 2,
                                  min=0.0))


def emd_luminance(pred, target):
    """Wasserstein-1 of per-channel value distributions, averaged over RGB."""
    return compare_luminance(pred, target)[:, 0, 0, 0]


def evaluate_batch(pred, target):
    return {
        "psnr": psnr(pred, target),
        "si_rmse": si_rmse(pred, target),
        "emd": emd_luminance(pred, target),
    }
