"""Conditional PatchGAN discriminator on concat(LDR, HDR)
(`skyhdr.models.discriminator`): four Downsampling stages (64 without
norm, 128 and 256 with BatchNorm at stride 2, 512 with BatchNorm at stride
1) and a 1-channel 4x4 output conv with bias, normal(0.02) kernels. The
output conv is VALID, or SAME when the map is under 4 pixels on a side
(the 16x64 size: d4 gives 2x8 there). LSGAN: no sigmoid. On a width shard
(`ops.width`) the VALID conv reads k - 1 columns of the right neighbour,
and the last shard's logits end where the panorama's do: the shards'
logits differ in width, and the losses take the whole logits' width
(`logits_width`, `WidthRing.mean`)."""

from __future__ import annotations

import torch
from torch import nn

from skyhdr_torch.models.layers import Conv2D, Downsampling
from skyhdr_torch.ops import width


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
        ring = width.current()
        w = x.shape[2] * (1 if ring is None else ring.n)
        return self.out(x, padding="VALID" if _valid(x.shape[1], w) else "SAME")

    @staticmethod
    def logits_width(h: int, w: int) -> int:
        """The width of the logits of an h x w panorama: d4's map (each of
        the three stride-2 stages halves it, rounding up), less the VALID
        conv's k - 1."""
        for _ in range(3):
            h, w = -(-h // 2), -(-w // 2)
        return w - 3 if _valid(h, w) else w


def _valid(h: int, w: int) -> bool:
    """Whether the output conv of d4's h x w map is VALID."""
    return min(h, w) >= 4
