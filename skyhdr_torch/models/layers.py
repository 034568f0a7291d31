"""Building blocks of `skyhdr.models.layers`, in PyTorch.

Activations are NHWC at every module boundary, as in the JAX package;
convolutions permute to NCHW views around `F.conv2d`. In a width context
(`ops.width`, the width-sharded train step) each layer holds a width shard
of its map and takes what it needs of the rest through the ring: a conv
its halos, InstanceNorm its sums, a Dense over a flattened map a partial
contraction summed over the ring. Parameters are
allocated empty on the requested device and filled from a Flax-layout tree
by `skyhdr_torch.utils.transplant` (each module's `flax_leaves` names its
leaves, their layout and their initializer). Dtype rules follow Flax: an
explicit `dtype` casts operands and weights to it, None promotes them.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from skyhdr_torch.ops import width
from skyhdr_torch.ops.kernels.instnorm import instance_norm_act
from skyhdr_torch.ops.resize import resize_bilinear


# The batch of a data-parallel step spans processes: `skyhdr_torch.parallel.
# dp` sets this, for the step's duration, to an object whose `sum(t)` is a
# differentiable all-reduce over the ranks, `max(t)` the batch maximum whose
# gradient reaches the rank holding it, and `world` the number of equal
# shards. None: the batch is this process's own.
_BATCH_REDUCE = None


@contextlib.contextmanager
def batch_across(reduce):
    """Within: train-mode BatchNorm statistics and `batch_max` take the
    whole batch through `reduce` (see `_BATCH_REDUCE`)."""
    global _BATCH_REDUCE
    outer, _BATCH_REDUCE = _BATCH_REDUCE, reduce
    try:
        yield
    finally:
        _BATCH_REDUCE = outer


def batch_max(x: torch.Tensor) -> torch.Tensor:
    """The maximum of `x` over the whole batch: its gradient split among the
    elements that hold it, as `torch.max` and JAX's max do."""
    return torch.max(x) if _BATCH_REDUCE is None else _BATCH_REDUCE.max(x)


def compute_dtype(cfg) -> Optional[torch.dtype]:
    """The conv-stack dtype of a ModelConfig (None = promote, as in Flax)."""
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA "SAME" padding (lo, hi): asymmetric when the total is odd, e.g.
    (0, 1) for k3 s2 and (1, 2) for k4 s1 on even sizes."""
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def width_halo(ring, x, k: int, s: int, padding: str = "SAME", dim: int = 2):
    """A width shard x extended along `dim` by the columns that a conv of
    kernel k and stride s reads beyond it, with a gradient: under "SAME"
    the whole panorama's pads, `same_pads(W, k, s)` = (lo, k - s - lo) for
    a width W that s divides, as lo columns of the left neighbour and
    k - s - lo of the right one, zero at the panorama's ends (output column
    j of the shard then reads its input columns j s - lo ...); under
    "VALID" (stride 1) the right neighbour's first k - 1 columns and none
    at the right end, so that each shard keeps the outputs of its own
    input columns and the last shard's end where the panorama's do (its
    shard k - 1 narrower)."""
    wl = x.shape[dim]
    if padding == "SAME":
        if wl % s:
            raise ValueError(f"a stride of {s} over a width shard of {wl}")
        lo, _ = same_pads(wl * ring.n, k, s)
        return ring.halo(x, lo, k - s - lo, "zeros", dim)
    if s != 1:
        raise ValueError(f"a VALID conv of stride {s} on width shards")
    return ring.halo(x, 0, k - 1, "drop", dim)


def _param(*shape, device=None) -> nn.Parameter:
    return nn.Parameter(torch.empty(*shape, device=device))


class Conv2D(nn.Module):
    """SAME-padded conv with Flax `nn.Conv` semantics; kernel stored OIHW
    (Flax HWIO). On a width shard its width pads are `width_halo`'s."""

    def __init__(self, in_features: int, features: int, kernel: int,
                 strides: int = 1, *, use_bias: bool = True,
                 init_scale: str = "glorot", dtype=None, device=None):
        super().__init__()
        self.k, self.s, self.dtype = kernel, strides, dtype
        self.init = "glorot" if init_scale == "glorot" else "normal02"
        self.kernel = _param(features, in_features, kernel, kernel, device=device)
        self.bias = _param(features, device=device) if use_bias else None

    def flax_leaves(self):
        leaves = [("params", "kernel", self.kernel, "hwio", self.init)]
        if self.bias is not None:
            leaves.append(("params", "bias", self.bias, "same", "zeros"))
        return leaves

    def forward(self, x, padding: str = "SAME"):
        ct = self.dtype or torch.promote_types(x.dtype, self.kernel.dtype)
        ring = width.current()
        ph = pw = (0, 0)
        if padding == "SAME":
            ph = same_pads(x.shape[1], self.k, self.s)
            if ring is None:
                pw = same_pads(x.shape[2], self.k, self.s)
        if ring is not None:
            x = width_halo(ring, x, self.k, self.s, padding)
        xn = F.pad(x.to(ct).permute(0, 3, 1, 2), (pw[0], pw[1], ph[0], ph[1]))
        y = F.conv2d(xn, self.kernel.to(ct), stride=self.s).permute(0, 2, 3, 1)
        return y if self.bias is None else y + self.bias.to(y.dtype)


_ACT_ALPHA = {"none": 1.0, "relu": 0.0, "lrelu01": 0.1}


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalisation over (H, W), biased variance,
    eps 1e-3, statistics in float32; output in x.dtype. `act` applies the
    follower activation: 'relu', 'lrelu01' or 'none'. With `fuse`
    (ModelConfig.fused_instance_norm) the normalisation and the activation
    run as one op, `ops.kernels.instnorm.instance_norm_act` (K8 forward, K9
    backward on the card); otherwise as the composition below. On a width
    shard the mean and variance are the whole (h, w)'s, their sums taken
    over the ring in float32, and the composition runs whatever `fuse` says
    (K8/K9 take their statistics over one process's (sample, channel), as
    `skyhdr`'s `_mesh_cfg` routes its fused InstanceNorm off on a mesh)."""

    def __init__(self, features: int, epsilon: float = 1e-3, fuse: bool = False,
                 device=None):
        super().__init__()
        self.epsilon, self.fuse = epsilon, fuse
        self.scale = _param(features, device=device)
        self.bias = _param(features, device=device)

    def flax_leaves(self):
        return [("params", "scale", self.scale, "same", "ones"),
                ("params", "bias", self.bias, "same", "zeros")]

    def forward(self, x, act: str = "none"):
        ring = width.current()
        if self.fuse and ring is None:
            return instance_norm_act(x, self.scale, self.bias, eps=self.epsilon,
                                     alpha=_ACT_ALPHA[act])
        xf = x.float()
        if ring is None:
            mean = xf.mean(dim=(1, 2), keepdim=True)
            var = xf.var(dim=(1, 2), keepdim=True, unbiased=False)
            d = xf - mean
        else:
            n = x.shape[1] * x.shape[2] * ring.n
            d = xf - ring.sum(xf.sum(dim=(1, 2), keepdim=True)) / n
            var = ring.sum((d * d).sum(dim=(1, 2), keepdim=True)) / n
        y = d * torch.rsqrt(var + self.epsilon)
        y = (y * self.scale + self.bias).to(x.dtype)
        if act == "relu":
            return F.relu(y)
        if act == "lrelu01":
            return leaky_relu_01(y)
        return y


class BatchNorm(nn.Module):
    """Flax `nn.BatchNorm(momentum=0.99, epsilon=1e-3)`: float32 math,
    output in `dtype` (None: promote x with the parameters).

    Eval normalises with the running statistics. Train normalises with the
    batch mean and the biased batch variance E[x^2] - E[x]^2 (clipped at 0,
    as Flax computes it) over (b, h, w), and updates the running buffers IN
    PLACE, once per call: ra = 0.99 ra + 0.01 stat, with that same biased
    variance (`F.batch_norm` would use momentum 0.01 and an unbiased running
    variance). The moments are sums over (b, h, w) divided by the count; in
    a data-parallel step (`batch_across`) the sums and the count are the
    whole batch's, the sums through a differentiable all-reduce, so every
    rank normalises alike and its backward carries the other ranks' terms."""

    def __init__(self, features: int, epsilon: float = 1e-3, dtype=None,
                 device=None):
        super().__init__()
        self.epsilon, self.dtype = epsilon, dtype
        self.scale = _param(features, device=device)
        self.bias = _param(features, device=device)
        self.register_buffer("mean", torch.empty(features, device=device))
        self.register_buffer("var", torch.empty(features, device=device))

    def flax_leaves(self):
        return [("params", "scale", self.scale, "same", "ones"),
                ("params", "bias", self.bias, "same", "zeros"),
                ("batch_stats", "mean", self.mean, "same", "zeros"),
                ("batch_stats", "var", self.var, "same", "ones")]

    def forward(self, x, train: bool = False):
        out = self.dtype or torch.promote_types(
            torch.promote_types(x.dtype, self.scale.dtype), self.bias.dtype)
        mean, var = self.mean, self.var
        if train:
            xf = x.float()
            sums = torch.stack([xf.sum(dim=(0, 1, 2)), (xf * xf).sum(dim=(0, 1, 2))])
            count = xf.numel() // xf.shape[-1]
            if _BATCH_REDUCE is not None:
                sums, count = _BATCH_REDUCE.sum(sums), count * _BATCH_REDUCE.world
            mean = sums[0] / count
            var = torch.clamp(sums[1] / count - mean * mean, min=0.0)
            with torch.no_grad():
                self.mean.copy_(0.99 * self.mean + 0.01 * mean)
                self.var.copy_(0.99 * self.var + 0.01 * var)
        mul = torch.rsqrt(var + self.epsilon) * self.scale
        return ((x - mean) * mul + self.bias).to(out)


class Dense(nn.Module):
    """Flax `nn.Dense`; weight stored as `Linear` [out, in] (Flax [in, out])."""

    def __init__(self, in_features: int, features: int, *, dtype=None,
                 init: str = "lecun", device=None):
        super().__init__()
        self.dtype, self.init = dtype, init
        self.weight = _param(features, in_features, device=device)
        self.bias = _param(features, device=device)

    def flax_leaves(self):
        return [("params", "kernel", self.weight, "dense", self.init),
                ("params", "bias", self.bias, "same", "zeros")]

    def _dtype(self, x):
        return self.dtype or torch.promote_types(x.dtype, self.weight.dtype)

    def forward(self, x):
        dt = self._dtype(x)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


def map_dense(dense: Dense, x):
    """`dense` over the map x [b, h, w, c] flattened in NHWC order (its
    weight's rows ordered (h, w, c)). On a width shard: the partial
    contraction of the shard with its columns' rows of the weight, summed
    over the ring in float32 (a differentiable all-reduce), then the bias;
    the result is whole on every process of the ring, and the weight's
    gradient this process's partial."""
    ring = width.current()
    if ring is None:
        return Dense.forward(dense, x.reshape(x.shape[0], -1))
    b, h, wl, c = x.shape
    dt = dense._dtype(x)
    # The shard placed in a zero map of the whole width: the product with
    # the whole weight is the shard's rows' (no copy of the weight, and its
    # gradient is the whole weight's, zero outside the shard's rows).
    cols = ring.cols(wl * ring.n)
    xz = F.pad(x, (0, 0, cols.start, wl * ring.n - cols.stop))
    part = F.linear(xz.reshape(b, -1).to(dt), dense.weight.to(dt))
    return ring.sum(part.float()).to(dt) + dense.bias.to(dt)


class SpatialDense(Dense):
    """`skyhdr.models.sunpose.SpatialDense`: a Dense over [b, h, w, c]
    flattened in NHWC order, computed in `dtype` or float32 (`map_dense`:
    on a width shard, a partial contraction summed over the ring)."""

    def _dtype(self, x):
        return self.dtype or torch.float32

    def forward(self, x):
        return map_dense(self, x)


class ResizeDeconv(nn.Module):
    """Bilinear resize to `out_hw`, then a SAME conv named `conv`."""

    def __init__(self, in_features: int, features: int, out_hw, kernel: int = 3,
                 dtype=None, device=None):
        super().__init__()
        self.out_hw = tuple(out_hw)
        self.conv = Conv2D(in_features, features, kernel, dtype=dtype,
                           device=device)

    def forward(self, x):
        return self.conv(resize_bilinear(x, self.out_hw))


class Downsampling(nn.Module):
    """conv(k, s, no bias, normal(0.02)) -> [BatchNorm] -> LeakyReLU(0.3)."""

    def __init__(self, in_features: int, features: int, kernel: int = 4,
                 strides: int = 2, apply_norm: bool = True, dtype=None,
                 device=None):
        super().__init__()
        self.conv = Conv2D(in_features, features, kernel, strides,
                           use_bias=False, init_scale="gan", dtype=dtype,
                           device=device)
        self.bn = (BatchNorm(features, dtype=dtype, device=device)
                   if apply_norm else None)

    def forward(self, x, train: bool = False):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x, train)
        return leaky_relu(x, 0.3)


def leaky_relu(x, slope: float):
    """`F.leaky_relu` with the slope first rounded to x's dtype, as JAX
    rounds a weakly typed Python scalar against an array (bfloat16: 0.1 ->
    0.10009765625, 0.3 -> 0.30078125); forward and gradient then scale by
    the same number as `flax.linen.leaky_relu`."""
    if x.dtype != torch.float32:
        slope = torch.tensor(slope, dtype=x.dtype).item()
    return F.leaky_relu(x, slope)


def leaky_relu_01(x):
    """The generator-side activation, slope 0.1."""
    return leaky_relu(x, 0.1)


def maxpool2(x):
    """2x2 max pool, stride 2, SAME, on NHWC. A width shard must hold an
    even number of columns (then its pools are the whole panorama's)."""
    ring = width.current()
    if ring is not None and x.shape[2] % 2:
        raise ValueError(f"a 2x2 pool over a width shard of {x.shape[2]} columns")
    y = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2, ceil_mode=True)
    return y.permute(0, 2, 3, 1)
