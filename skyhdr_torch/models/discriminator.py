"""Conditional PatchGAN discriminator on concat(LDR, HDR)
(`skyhdr.models.discriminator`): four Downsampling stages (64 without
norm, 128 and 256 with BatchNorm at stride 2, 512 with BatchNorm at stride
1) and a 1-channel 4x4 output conv with bias, normal(0.02) kernels. The
output conv is VALID, or SAME when the map is under 4 pixels on a side
(the 16x64 size: d4 gives 2x8 there). LSGAN: no sigmoid."""

from __future__ import annotations

import torch
from torch import nn

from skyhdr_torch.models.layers import Conv2D, Downsampling


class Discriminator(nn.Module):

    def __init__(self, channels: int = 3, device=None):
        super().__init__()
        dev = dict(device=device)
        self.d1 = Downsampling(2 * channels, 64, 4, 2, apply_norm=False, **dev)
        self.d2 = Downsampling(64, 128, 4, 2, **dev)
        self.d3 = Downsampling(128, 256, 4, 2, **dev)
        self.d4 = Downsampling(256, 512, 4, 1, **dev)
        self.out = Conv2D(512, 1, 4, 1, init_scale="gan", **dev)

    def forward(self, ldr, hdr, train: bool = False):
        """Patch logits [b, h', w', 1]. With `train` the BatchNorm layers use
        batch statistics and refresh their running buffers in place."""
        x = torch.cat([ldr, hdr], dim=-1)
        for layer in (self.d1, self.d2, self.d3, self.d4):
            x = layer(x, train)
        return self.out(x, padding="VALID" if min(x.shape[1], x.shape[2]) >= 4
                        else "SAME")
