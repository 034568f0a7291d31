"""Loss functions of `skyhdr.train.losses`: Keras-semantics KL, the LSGAN
losses and L1."""

from __future__ import annotations

import torch

_EPS = 1e-7


def kl_divergence(y_true, y_pred):
    """mean_b sum_bins t*log(t/p), both clipped to [1e-7, 1] (Keras)."""
    t = torch.clamp(y_true, _EPS, 1.0)
    p = torch.clamp(y_pred, _EPS, 1.0)
    return torch.mean(torch.sum(t * torch.log(t / p), dim=-1))


def lsgan_gen_loss(disc_generated):
    """mean((D(G) - 1)^2)."""
    return torch.mean(torch.square(disc_generated - 1.0))


def lsgan_disc_loss(disc_real, disc_generated):
    """(0.5 * (real + generated), real, generated) with
    real = mean((D(real)-1)^2) and generated = mean(D(G)^2)."""
    real = torch.mean(torch.square(disc_real - 1.0))
    generated = torch.mean(torch.square(disc_generated))
    return 0.5 * (real + generated), real, generated


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))
