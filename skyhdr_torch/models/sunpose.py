"""Sun-pose estimator (`skyhdr.models.sunpose`): three conv stages with
max-pooling, two dense layers, a softmax over the h*w sun-position bins,
and the three stage activations for Grad-CAM."""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from skyhdr_torch.models.layers import (Conv2D, Dense, InstanceNorm,
                                        SpatialDense, compute_dtype, maxpool2)
from skyhdr_torch.ops import width
from skyhdr_torch.ops.distortion import DAConv


class SunPoseLayer(nn.Module):
    """(conv-IN-relu) x2; the convs are DA convs when the config asks for
    them and the kernel is the DA kernel size."""

    def __init__(self, cfg, in_features: int, features: int, kernel: int = 3,
                 device=None):
        super().__init__()

        def conv(ci):
            if cfg.use_da_conv and kernel == cfg.da_kernel_size:
                return DAConv(ci, features, kernel_size=kernel,
                              dilation_rate=cfg.dilation_rate, device=device)
            return Conv2D(ci, features, kernel, dtype=compute_dtype(cfg),
                          device=device)

        self.conv1 = conv(in_features)
        fuse = cfg.fused_instance_norm
        self.norm1 = InstanceNorm(features, fuse=fuse, device=device)
        self.conv2 = conv(features)
        self.norm2 = InstanceNorm(features, fuse=fuse, device=device)

    def forward(self, x):
        x = self.norm1(self.conv1(x), act="relu")
        return self.norm2(self.conv2(x), act="relu")


class SunPoseNet(nn.Module):

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        h, w = cfg.im_height, cfg.im_width
        bins = cfg.num_bins
        dt = compute_dtype(cfg)
        self.sunlayer1 = SunPoseLayer(cfg, cfg.channels, 32, 7, device=device)
        self.sunlayer2 = SunPoseLayer(cfg, 32, 64, 3, device=device)
        self.sunlayer3 = SunPoseLayer(cfg, 64, 128, 3, device=device)
        # Three SAME 2x2 pools: ceil(n / 8) rows and columns remain.
        self.fc1 = SpatialDense((-(-h // 8)) * (-(-w // 8)) * 128, bins,
                                dtype=dt, device=device)
        self.fc2 = Dense(bins, bins, dtype=dt, device=device)

    def activation_shapes(self, batch: int):
        """The three activations' shapes (on a width shard, the shard's)."""
        ring = width.current()
        h, w = self.cfg.im_height, self.cfg.im_width // (1 if ring is None else ring.n)
        return ((batch, h, w, 32), (batch, h // 2, w // 2, 64),
                (batch, h // 4, w // 4, 128))

    def forward(self, x, eps: Optional[Sequence[torch.Tensor]] = None):
        """Returns (softmax over h*w bins [b, h*w] in float32, (a1, a2, a3)).
        `eps` are additive perturbations of the three activations: the
        gradient w.r.t. them at zero is the Grad-CAM gradient. On a width
        shard x and the activations are the shard's, and the softmax is
        whole on every process of the ring (fc1 is `layers.map_dense`)."""
        a1 = self.sunlayer1(x)
        if eps is not None:
            a1 = a1 + eps[0]
        a2 = self.sunlayer2(maxpool2(a1))
        if eps is not None:
            a2 = a2 + eps[1]
        a3 = self.sunlayer3(maxpool2(a2))
        if eps is not None:
            a3 = a3 + eps[2]
        y = F.relu(self.fc1(maxpool2(a3)))
        y = F.relu(self.fc2(y)).float()
        # Softmax over non-negative logits (relu first), in float32.
        return torch.softmax(y, dim=-1), (a1, a2, a3)
