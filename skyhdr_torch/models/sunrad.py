"""Sun-radiance head (`skyhdr.models.sunrad`): a CNN over LDR and CAMs
gives two scalars (gamma, beta) that shape an analytic Dirac-delta radiance
on the normalised sun-pose PDF. The radiance math is float32."""

from __future__ import annotations

import math

import torch
from torch import nn

from skyhdr_torch.models.layers import Dense, Downsampling, map_dense


class SunRadNet(nn.Module):

    def __init__(self, im_height: int, im_width: int, in_features: int = 6,
                 epsilon: float = 1e-5, clip_value: float = 30000.0,
                 dtype=None, device=None):
        super().__init__()
        self.epsilon, self.clip_value = epsilon, clip_value
        self.d1 = Downsampling(in_features, 64, 4, 2, apply_norm=False,
                               dtype=dtype, device=device)
        self.d2 = Downsampling(64, 128, 4, 2, dtype=dtype, device=device)
        self.d3 = Downsampling(128, 256, 4, 2, dtype=dtype, device=device)
        self.d4 = Downsampling(256, 512, 4, 1, dtype=dtype, device=device)
        flat = (-(-im_height // 8)) * (-(-im_width // 8)) * 512
        self.gamma = Dense(flat, 1, device=device)
        self.beta = Dense(flat, 1, device=device)

    def forward(self, x, actv_map, train: bool = False):
        """x: normalised sun-pose PDF [b, h, w, 1]; actv_map: LDR ++ CAMs
        [b, h, w, 6]. Returns (radiance [b, h, w, 1], gamma, beta). With
        `train` the BatchNorm layers use batch statistics and refresh their
        running buffers in place. On a width shard x and actv_map are the
        shard's, and gamma and beta (`layers.map_dense` of the shard's part
        of the flattened map) are whole on every process of the ring."""
        d = actv_map
        for layer in (self.d1, self.d2, self.d3, self.d4):
            d = layer(d, train)
        d = d.float()  # flattened in NHWC order, as the Dense rows are
        gamma_in = torch.sigmoid(map_dense(self.gamma, d)).reshape(-1, 1, 1, 1).float()
        beta_in = torch.sigmoid(map_dense(self.beta, d)).reshape(-1, 1, 1, 1).float()

        x = x.float()
        rad = -torch.square(1.0 - x)
        rad = rad / (beta_in + self.epsilon)
        rad = torch.exp(rad) * gamma_in
        rad = rad / (beta_in * math.sqrt(math.pi) + self.epsilon)
        rad = torch.where(rad > self.clip_value,
                          torch.full_like(rad, self.clip_value), rad)
        return rad, gamma_in, beta_in
