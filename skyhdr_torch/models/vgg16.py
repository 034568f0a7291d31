"""Frozen VGG16 perceptual backbone, conv1_1 .. pool3 (`skyhdr.models.vgg16`).

Weights are a dict name -> (kernel HWIO [3,3,cin,cout], bias [cout]) of
NumPy arrays, as the JAX package holds them: `load_vgg16_npy` reads the
SingleHDR `vgg16.npy` (conv1_1's input channels flipped from BGR to RGB),
`random_vgg16_weights` draws the same He-normal stand-in from the same numpy
stream. `vgg_constants` moves them to the device once as frozen OIHW
tensors (no gradient); the features run in the compute dtype.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

VGG_MEAN_RGB = (123.68, 116.779, 103.939)

_LAYERS = (
    ("conv1_1", 3, 64), ("conv1_2", 64, 64),
    ("conv2_1", 64, 128), ("conv2_2", 128, 128),
    ("conv3_1", 128, 256), ("conv3_2", 256, 256), ("conv3_3", 256, 256),
)
_POOL_AFTER = {"conv1_2", "conv2_2", "conv3_3"}


def load_vgg16_npy(path: str) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Parse the SingleHDR vgg16.npy dict; conv1_1 flipped to take RGB."""
    data = np.load(path, encoding="latin1", allow_pickle=True).item()
    out = {}
    for name, cin, cout in _LAYERS:
        w = np.asarray(data[name][0], np.float32)
        b = np.asarray(data[name][1], np.float32)
        assert w.shape == (3, 3, cin, cout), (name, w.shape)
        if name == "conv1_1":
            w = w[:, :, ::-1, :]
        out[name] = (w, b)
    return out


def random_vgg16_weights(seed: int = 0) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Deterministic He-normal frozen stand-in when vgg16.npy is absent."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, cin, cout in _LAYERS:
        std = np.sqrt(2.0 / (3 * 3 * cin))
        w = rng.normal(0.0, std, size=(3, 3, cin, cout)).astype(np.float32)
        out[name] = (w, np.zeros((cout,), np.float32))
    return out


def vgg_constants(weights, device) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """The weight dict on `device` as frozen (OIHW kernel, bias) tensors."""
    return {name: (torch.from_numpy(np.ascontiguousarray(w)).to(device).permute(3, 2, 0, 1)
                   .contiguous(), torch.from_numpy(np.asarray(b)).to(device))
            for name, (w, b) in weights.items()}


def vgg16_features(consts, rgb01, dtype=torch.float32):
    """rgb01 [b,h,w,3] in [0,1] -> (pool1, pool2, pool3), NHWC, in `dtype`.
    `consts` from `vgg_constants`; x255 and the mean subtraction in float32."""
    mean = torch.tensor(VGG_MEAN_RGB, dtype=torch.float32, device=rgb01.device)
    x = (rgb01.float() * 255.0 - mean).to(dtype).permute(0, 3, 1, 2)
    outs = []
    for name, _, _ in _LAYERS:
        w, b = consts[name]
        x = F.relu(F.conv2d(x, w.to(dtype), b.to(dtype), padding=1))
        if name in _POOL_AFTER:
            x = F.max_pool2d(x, 2, 2, ceil_mode=True)  # SAME 2x2 stride 2
            outs.append(x.permute(0, 2, 3, 1))
    return tuple(outs)


def perceptual_l1(consts, pred_gamma, target_gamma, dtype=torch.float32):
    """Sum over pool1-3 of mean |features(pred) - features(target)|, each
    mean in float32."""
    loss = 0.0
    for a, b in zip(vgg16_features(consts, pred_gamma, dtype),
                    vgg16_features(consts, target_gamma, dtype)):
        loss = loss + torch.mean(torch.abs(a - b).float())
    return loss
