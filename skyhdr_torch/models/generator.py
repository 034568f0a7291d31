"""Generator (`skyhdr.models.generator`): shared conv encoder and residual
trunk, twin resize-deconv decoders (sky, sun), the analytic sun-radiance
head, additive blending. With `use_da_conv` the 3x3 stride-1 convs of the
trunk and the decoders are distortion-aware."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from skyhdr_torch.models.layers import (Conv2D, InstanceNorm, ResizeDeconv,
                                        compute_dtype, leaky_relu_01)
from skyhdr_torch.models.sunrad import SunRadNet
from skyhdr_torch.ops.distortion import DAConv, DADeconv
from skyhdr_torch.ops.resize import resize_bilinear


def _conv(cfg, in_features: int, features: int, kernel: int, device=None):
    if cfg.use_da_conv and kernel == cfg.da_kernel_size:
        return DAConv(in_features, features, kernel_size=kernel,
                      dilation_rate=cfg.dilation_rate, device=device)
    return Conv2D(in_features, features, kernel, dtype=compute_dtype(cfg),
                  device=device)


def _deconv(cfg, in_features: int, features: int, out_hw, kernel: int = 3,
            device=None):
    if cfg.use_da_conv and kernel == cfg.da_kernel_size:
        return DADeconv(in_features, features, out_hw, kernel_size=kernel,
                        dilation_rate=cfg.dilation_rate, device=device)
    return ResizeDeconv(in_features, features, out_hw, kernel,
                        dtype=compute_dtype(cfg), device=device)


class ResBlock(nn.Module):
    """conv-IN-lrelu(0.1)-conv-IN + identity."""

    def __init__(self, cfg, features: int, kernel: int = 3, device=None):
        super().__init__()
        self.conv1 = _conv(cfg, features, features, kernel, device)
        fuse = cfg.fused_instance_norm
        self.norm1 = InstanceNorm(features, fuse=fuse, device=device)
        self.conv2 = _conv(cfg, features, features, kernel, device)
        self.norm2 = InstanceNorm(features, fuse=fuse, device=device)

    def forward(self, x):
        y = self.norm1(self.conv1(x), act="lrelu01")
        y = self.norm2(self.conv2(y))
        return x + y


class Generator(nn.Module):

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        h, w = cfg.im_height, cfg.im_width
        f1, f2, f3 = cfg.enc_filters
        d1, d2 = cfg.dec_filters
        c = cfg.channels
        dev = dict(device=device)
        fuse = cfg.fused_instance_norm

        # Encoder. Its convs take no compute dtype, as in the JAX model.
        self.conv1_d = Conv2D(c, f1, 7, 1, **dev)
        self.norm1_d = InstanceNorm(f1, fuse=fuse, **dev)
        self.conv2_d = Conv2D(f1, f2, 3, 2, **dev)
        self.norm2_d = InstanceNorm(f2, fuse=fuse, **dev)
        self.conv3_d = Conv2D(f2, f3, 3, 2, **dev)
        self.norm3_d = InstanceNorm(f3, fuse=fuse, **dev)
        self.num_res_blocks = cfg.num_res_blocks
        for i in range(cfg.num_res_blocks):
            self.add_module(f"res{i}", ResBlock(cfg, f3, cfg.da_kernel_size, **dev))

        # Sky decoder.
        self.conv3_f = _deconv(cfg, f3, d1, (h // 2, w // 2), **dev)
        self.norm3_f = InstanceNorm(d1, fuse=fuse, **dev)
        self.conv2_f = _deconv(cfg, d1, d2, (h, w), **dev)
        self.norm2_f = InstanceNorm(d2, fuse=fuse, **dev)
        self.conv1_f = Conv2D(d2, c, 7, 1, **dev)

        # Sun decoder.
        self.conv3_u = _deconv(cfg, f3, d1, (h // 2, w // 2), **dev)
        self.norm3_u = InstanceNorm(d1, fuse=fuse, **dev)
        self.conv2_u = _deconv(cfg, d1, d2, (h, w), **dev)
        self.norm2_u = InstanceNorm(d2, fuse=fuse, **dev)
        self.conv1_u = Conv2D(d2, c, 7, 1, **dev)

        # Sun-radiance head: LDR (c) + three CAMs.
        self.sun = SunRadNet(h, w, c + 3, clip_value=cfg.sun_rad_clip,
                             dtype=compute_dtype(cfg), **dev)

    def encode(self, x):
        """conv x3 + residual trunk."""
        y = self.norm1_d(self.conv1_d(x), act="lrelu01")
        y = self.norm2_d(self.conv2_d(y), act="lrelu01")
        y = self.norm3_d(self.conv3_d(y), act="lrelu01")
        for i in range(self.num_res_blocks):
            y = getattr(self, f"res{i}")(y)
        return y

    def sky_decode(self, x, inp):
        """Two resize-deconvs + 7x7 conv + input skip-add + relu."""
        y = self.norm3_f(self.conv3_f(x), act="lrelu01")
        y = self.norm2_f(self.conv2_f(y), act="lrelu01")
        y = leaky_relu_01(self.conv1_f(y))
        return F.relu(inp + y)

    def sun_decode(self, x, sun_rad):
        """Sun decoder; adds the analytic radiance in the gamma domain."""
        y = self.norm3_u(self.conv3_u(x), act="lrelu01")
        y = self.norm2_u(self.conv2_u(y), act="lrelu01")
        y = leaky_relu_01(self.conv1_u(y))
        return F.relu(sun_rad + y)

    def sun_rad_estimation(self, ldr, sun_cam1, sun_cam2, sun_cam3,
                           sunpose_pred, train: bool = False):
        """Dirac-delta sun radiance from LDR + CAM attention. The PDF is
        normalised by its maximum over the whole batch, as in the JAX
        model, so batch members are coupled. `train`: SunRadNet's BatchNorm
        in training mode (its running buffers refreshed in place)."""
        h, w = self.cfg.im_height, self.cfg.im_width
        normed = sunpose_pred / torch.max(sunpose_pred)
        cam2 = resize_bilinear(sun_cam2, (h, w))
        cam3 = resize_bilinear(sun_cam3, (h, w))
        feats = torch.cat([ldr, sun_cam1, cam2, cam3], dim=-1)
        sun_rad, gamma, beta = self.sun(normed, feats, train)
        return sun_rad.repeat(1, 1, 1, self.cfg.channels), gamma, beta

    def blending(self, sky_pred, sun_pred):
        return sky_pred + sun_pred
