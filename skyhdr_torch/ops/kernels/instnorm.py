"""Fused InstanceNorm + activation on Hopper: kernel wrappers, their plain
PyTorch versions, and the autograd glue (the twin of
skyhdr/ops/pallas/instnorm.py).

  K8 `instance_norm_act_k8` — CUDA forward (csrc/instnorm.cu), replacing
     `_fwd_kernel` / `_pallas_fwd`. Plain version: `instance_norm_act_ref`,
     the TPU kernel's formula in torch.
  K9 `instance_norm_act_bwd_k9` — CUDA backward, replacing `_bwd_kernel` /
     `_pallas_bwd`. Plain version: `instance_norm_act_bwd_ref`, the same
     closed form in torch (not autograd of the forward, so the CPU tests
     hold the very algorithm K9 runs against `jax.vjp`).
  `InstanceNormActFunction` — the custom-VJP wiring (`_fused` /
     `_fused_fwd` / `_fused_bwd`): K8 forward, K9 backward.

The op: per (sample, channel), over (H, W), y = act((x - mean) * rstd *
gamma + beta) with biased variance and rstd = 1/sqrt(var + eps), statistics
in float32, output in x.dtype; act is leaky-ReLU with slope `alpha` (1: none,
0: relu, 0.1: the generator's). As in the TPU kernel, the activation's mask
is taken on the float32 pre-activation, and its slope multiplies the output
cast to x.dtype (in bfloat16, alpha is rounded to bfloat16 first, as JAX
promotes a Python float). The backward masks dy by `ypre >= 0`: at a
pre-activation of exactly 0 the fused op passes dy with slope 1, where the
unfused graph's `F.relu` / `F.leaky_relu` (mask `> 0`) gives `alpha`.

Dispatch is by device only: a CPU tensor takes the plain version, a CUDA
tensor launches the kernel or raises; there is no shape gate (the TPU's
VMEM gate has no counterpart here). `K8_LAUNCHES` / `K9_LAUNCHES` count
wrapper calls that launch.
"""

from __future__ import annotations

import torch

K8_LAUNCHES = 0
K9_LAUNCHES = 0


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _ptrs(*tensors):
    for t in tensors:
        _require(t.is_contiguous(), "instance-norm kernel operands must be contiguous")
    return [t.data_ptr() for t in tensors]


def _alpha_in(dtype: torch.dtype, alpha: float) -> float:
    """`alpha` as JAX multiplies a `dtype` array by it: rounded to dtype."""
    return float(torch.tensor(alpha, dtype=dtype).float())


def _splits(b: int, hw: int, c: int, device) -> int:
    """Pixel splits per sample: about 8 blocks per SM over the batch, each
    split at least 4 rows of the block's pixel stride."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    rows = max(1, 256 // c)
    want = -(-8 * sms // b)
    return max(1, min(want, hw // (4 * rows)))


def _check_operands(x, gamma, beta, what):
    _require(x.is_cuda and gamma.device == x.device and beta.device == x.device,
             f"{what} takes CUDA tensors on one device")
    _require(x.dim() == 4, f"{what}: x must be [b,h,w,c], got {tuple(x.shape)}")
    b, h, w, c = x.shape
    _require(x.dtype in (torch.float32, torch.bfloat16),
             f"{what} takes float32 or bfloat16 x, got {x.dtype}")
    _require(tuple(gamma.shape) == (c,) and tuple(beta.shape) == (c,),
             f"{what}: gamma and beta must be [{c}]")
    _require(1 <= c <= 1024 and 1 <= b <= 65535 and h * w * c < 2 ** 31,
             f"{what} takes 1 <= C <= 1024, B <= 65535 and H*W*C < 2^31, "
             f"got {tuple(x.shape)}")
    return b, h * w, c


def instance_norm_act_k8(x, gamma, beta, *, eps: float = 1e-3,
                         alpha: float = 1.0):
    """K8 on the card: (y in x.dtype, mean [b,c] f32, rstd [b,c] f32)."""
    global K8_LAUNCHES
    from skyhdr_torch.ops.kernels.build import check, library

    b, hw, c = _check_operands(x, gamma, beta, "K8")
    x = x.contiguous()
    g32 = gamma.float().contiguous()
    b32 = beta.float().contiguous()
    s = _splits(b, hw, c, x.device)
    ws = torch.empty((b, s, c, 2), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    mean = torch.empty((b, c), dtype=torch.float32, device=x.device)
    rstd = torch.empty((b, c), dtype=torch.float32, device=x.device)
    code = library().skyhdr_in_fwd_k8(
        *_ptrs(x, g32, b32, ws, y, mean, rstd), b, hw, c, s, float(eps),
        _alpha_in(x.dtype, alpha), int(x.dtype == torch.bfloat16),
        x.device.index, _stream(x))
    check(code, "K8 (instance-norm forward)")
    K8_LAUNCHES += 1
    return y, mean, rstd


def instance_norm_act_bwd_k9(x, dy, gamma, beta, mean, rstd, *,
                             alpha: float = 1.0):
    """K9 on the card: (dx in x.dtype, dgamma [c] f32, dbeta [c] f32), the
    batch sums in a fixed order (deterministic). dy is taken in x.dtype."""
    global K9_LAUNCHES
    from skyhdr_torch.ops.kernels.build import check, library

    b, hw, c = _check_operands(x, gamma, beta, "K9")
    _require(dy.shape == x.shape and dy.device == x.device,
             f"K9: dy must be {tuple(x.shape)} on {x.device}")
    _require(tuple(mean.shape) == (b, c) and tuple(rstd.shape) == (b, c),
             f"K9: mean and rstd must be [{b}, {c}]")
    x = x.contiguous()
    dy = dy.to(x.dtype).contiguous()
    g32 = gamma.float().contiguous()
    b32 = beta.float().contiguous()
    mean, rstd = mean.float().contiguous(), rstd.float().contiguous()
    s = _splits(b, hw, c, x.device)
    ws = torch.empty((b, s, c, 2), dtype=torch.float32, device=x.device)
    scratch = torch.empty((2, b, c, 2), dtype=torch.float32, device=x.device)
    dgamma = torch.empty(c, dtype=torch.float32, device=x.device)
    dbeta = torch.empty(c, dtype=torch.float32, device=x.device)
    dx = torch.empty_like(x)
    code = library().skyhdr_in_bwd_k9(
        *_ptrs(x, dy, g32, b32, mean, rstd, ws, scratch[0], scratch[1], dgamma,
               dbeta, dx), b, hw, c, s, float(alpha),
        int(x.dtype == torch.bfloat16), x.device.index, _stream(x))
    check(code, "K9 (instance-norm backward)")
    K9_LAUNCHES += 1
    return dx, dgamma, dbeta


def instance_norm_act_ref(x, gamma, beta, *, eps: float = 1e-3,
                          alpha: float = 1.0):
    """Plain version of K8 (`_fwd_kernel`'s formula): (y, mean, rstd)."""
    xf = x.float()
    mean = xf.mean(dim=(1, 2), keepdim=True)
    var = (xf - mean).square().mean(dim=(1, 2), keepdim=True)
    rstd = torch.reciprocal(torch.sqrt(var + eps))
    yf = (xf - mean) * rstd * gamma.float() + beta.float()
    y = yf.to(x.dtype)
    if alpha != 1.0:
        neg = (_alpha_in(x.dtype, alpha) * y.float()).to(x.dtype)
        y = torch.where(yf >= 0, y, neg)
    return y, mean[:, 0, 0], rstd[:, 0, 0]


def instance_norm_act_bwd_ref(x, dy, gamma, beta, mean, rstd, *,
                              alpha: float = 1.0):
    """Plain version of K9 (`_bwd_kernel`'s closed form): (dx in x.dtype,
    dgamma [c] f32, dbeta [c] f32)."""
    xf = x.float()
    m, r = mean.float()[:, None, None, :], rstd.float()[:, None, None, :]
    g = gamma.float()
    xhat = (xf - m) * r
    ypre = xhat * g + beta.float()
    dyf = dy.float()
    if alpha != 1.0:
        dyf = torch.where(ypre >= 0, dyf, alpha * dyf)
    dbeta = dyf.sum(dim=(1, 2)).sum(0)
    dgamma = (dyf * xhat).sum(dim=(1, 2)).sum(0)
    dxhat = dyf * g
    m1 = dxhat.mean(dim=(1, 2), keepdim=True)
    m2 = (dxhat * xhat).mean(dim=(1, 2), keepdim=True)
    dx = (r * (dxhat - m1 - xhat * m2)).to(x.dtype)
    return dx, dgamma, dbeta


class InstanceNormActFunction(torch.autograd.Function):
    """InstanceNorm + activation with K8 forward and K9 backward."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps: float, alpha: float):
        run = instance_norm_act_k8 if x.is_cuda else instance_norm_act_ref
        y, mean, rstd = run(x, gamma, beta, eps=eps, alpha=alpha)
        ctx.save_for_backward(x, gamma, beta, mean, rstd)
        ctx.alpha = alpha
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, mean, rstd = ctx.saved_tensors
        run = instance_norm_act_bwd_k9 if dy.is_cuda else instance_norm_act_bwd_ref
        dx, dgamma, dbeta = run(x, dy, gamma, beta, mean, rstd, alpha=ctx.alpha)
        need = ctx.needs_input_grad
        return (dx if need[0] else None,
                dgamma.to(gamma.dtype) if need[1] else None,
                dbeta.to(beta.dtype) if need[2] else None, None, None)


def instance_norm_act(x, gamma, beta, *, eps: float = 1e-3,
                      alpha: float = 1.0) -> torch.Tensor:
    """InstanceNorm of x [b,h,w,c] followed by leaky_relu(alpha)."""
    return InstanceNormActFunction.apply(x, gamma, beta, eps, alpha)
