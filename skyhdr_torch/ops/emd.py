"""Earth-mover's (Wasserstein-1) luminance comparison, the eval metric
(`skyhdr.ops.emd`). For two equal-size empirical samples SciPy's general
CDF formula collapses to the mean absolute difference of the sorted
samples: one sort per image and channel."""

from __future__ import annotations

import torch


def wasserstein_1d(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """W1 distance between the value distributions of x and y.

    x, y: [b, n] equal-length samples. Returns [b]."""
    xs = torch.sort(x, dim=-1).values
    ys = torch.sort(y, dim=-1).values
    return torch.mean(torch.abs(xs - ys), dim=-1)


def compare_luminance(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Per-channel W1 averaged over RGB (reference tf_utils.py:38-59).

    pred, gt: [b, h, w, 3]. Returns [b, 1, 1, 1] as the reference does."""
    b = pred.shape[0]
    d = [wasserstein_1d(pred[..., ch].reshape(b, -1), gt[..., ch].reshape(b, -1))
         for ch in range(3)]
    return ((d[0] + d[1] + d[2]) / 3.0).reshape(-1, 1, 1, 1)
