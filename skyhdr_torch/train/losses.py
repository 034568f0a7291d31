"""Loss functions of `skyhdr.train.losses`: Keras-semantics KL, the LSGAN
losses and L1. In a width context (`ops.width`) the inputs of the LSGAN
losses and L1 are width shards, and each of them is this process's share
of the whole panorama's mean (`WidthRing.mean`): the shares sum to it over
the ring. The LSGAN losses take the whole logits' width, since the last
shard's VALID logits are narrower."""

from __future__ import annotations

import torch

from skyhdr_torch.ops import width

_EPS = 1e-7


def _mean(x, w_full=None):
    ring = width.current()
    return torch.mean(x) if ring is None else ring.mean(x, w_full)


def kl_divergence(y_true, y_pred):
    """mean_b sum_bins t*log(t/p), both clipped to [1e-7, 1] (Keras)."""
    t = torch.clamp(y_true, _EPS, 1.0)
    p = torch.clamp(y_pred, _EPS, 1.0)
    return torch.mean(torch.sum(t * torch.log(t / p), dim=-1))


def lsgan_gen_loss(disc_generated, w_full=None):
    """mean((D(G) - 1)^2). On width shards `w_full` is the whole logits'
    width (`Discriminator.logits_width`)."""
    return _mean(torch.square(disc_generated - 1.0), w_full)


def lsgan_disc_loss(disc_real, disc_generated, w_full=None):
    """(0.5 * (real + generated), real, generated) with
    real = mean((D(real)-1)^2) and generated = mean(D(G)^2); `w_full` as
    `lsgan_gen_loss`'s."""
    real = _mean(torch.square(disc_real - 1.0), w_full)
    generated = _mean(torch.square(disc_generated), w_full)
    return 0.5 * (real + generated), real, generated


def l1_loss(pred, target):
    return _mean(torch.abs(pred - target))
