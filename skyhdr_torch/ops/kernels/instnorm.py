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
VMEM gate has no counterpart here). Each launch follows `in_tiling`, a
pure-Python plan (cluster size, channel groups, threads, whether the
blocks hold their share). `K8_LAUNCHES` / `K9_LAUNCHES` count wrapper
calls that launch.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

K8_LAUNCHES = 0
K9_LAUNCHES = 0

# The plan's limits and aims (csrc/instnorm.cu mirrors the first two).
IN_SMEM = 232448 - 1024       # dynamic shared memory a block may use, bytes
IN_CLUSTERS = (1, 2, 4, 8, 16)  # blocks a cluster may have (16: non-portable)
IN_SHARE = 64 * 1024          # bytes of x (K9: and dy) a block aims to hold
IN_FILL = 2                   # blocks per SM a plan aims for
IN_PER_THREAD = 16            # 16-byte vectors a thread aims to hold, over x (and dy)


class InTiling(NamedTuple):
    """A K8/K9 launch: `cluster` blocks per (sample, channel group) split
    H*W, `groups` channel groups, `threads` a block, `per_thread` pixels
    each thread walks at most, `holds` whether each block keeps its share
    in shared memory (else it reads it again in each pass), `vec` elements
    per load (16 bytes, or 1), `smem` dynamic shared memory bytes."""
    cluster: int
    groups: int
    threads: int
    per_thread: int
    holds: bool
    vec: int
    smem: int


def in_smem_bytes(hw: int, c: int, elem_bytes: int, tensors: int, cluster: int,
                  groups: int, threads: int, vec: int, holds: bool) -> int:
    """Dynamic shared memory of a launch, as `smem_bytes` in instnorm.cu:
    the held shares (each padded to 16 bytes), then the cluster partials
    and totals (4 floats a channel) and the block reduction's rows (two
    quantities a channel and a count)."""
    cg = c // groups
    lanes = cg // vec
    rows = threads // 32 if 32 % lanes == 0 else threads // lanes
    held = -(-(-(-hw // cluster) * cg * elem_bytes) // 16) * 16 if holds else 0
    return tensors * held + 4 * (4 * cg + rows * (2 * cg + 1))


def _threads(pixels: int, lanes: int, vec: int, tensors: int = 1) -> int:
    """Threads of a block of `lanes` along the channels and `pixels` pixels:
    enough rows that each walks about IN_PER_THREAD / tensors pixels; a
    multiple of 32 where whole rows fit a warp; at most 512 with 16-byte
    vectors (1024 with one element a thread), 256 where rows straddle warps
    (their reduction keeps a row each)."""
    want = lanes * -(-pixels // max(1, IN_PER_THREAD // tensors))
    if 32 % lanes == 0:
        return min(512 if vec > 1 else 1024, max(32, -(-want // 32) * 32))
    return max(lanes, min(want, max(256, lanes)) // lanes * lanes)


@functools.lru_cache(maxsize=None)
def in_tiling(b: int, hw: int, c: int, elem_bytes: int, sms: int, tensors: int = 1,
              aligned: bool = True) -> InTiling:
    """The plan of a K8 (`tensors` = 1: x) or K9 (2: x and dy) launch over x
    [b, hw, c] of `elem_bytes` elements on `sms` SMs. 16-byte vectors where
    the rows allow (`aligned` pointers, c a multiple of the vector);
    channel groups keep a pixel's run >= 32 bytes. Of the (groups, cluster)
    splits whose blocks hold at most IN_SHARE, the fewest splits that give
    IN_FILL blocks per SM (else the most blocks), and of those the ones
    with runs of >= 64 bytes, then portable clusters (<= 8 blocks), then
    the fewest groups; where none holds IN_SHARE, the smallest share that
    fits; where none fits, the blocks read their share again in each pass.
    (The order is the fastest of those swept on the H100, PERF.md.)"""
    vec = 16 // elem_bytes if aligned and c % (16 // elem_bytes) == 0 else 1
    groups = [g for g in (2 ** i for i in range(11)) if c % g == 0 and (c // g) % vec == 0
              and (g == 1 or (vec > 1 and c // g * elem_bytes >= 32))]
    splits = sorted(((g, n) for g in groups for n in IN_CLUSTERS),
                    key=lambda gn: (gn[0] * gn[1], c // gn[0] * elem_bytes < 64, gn[1] > 8,
                                    gn[0]))

    def most(gns):  # the most blocks, then as `splits` orders them
        return max(gns, key=lambda gn: (gn[0] * gn[1], -splits.index(gn)))

    def threads(gn):
        return _threads(-(-hw // gn[1]), c // gn[0] // vec, vec, tensors)

    def share(gn):
        return tensors * -(-hw // gn[1]) * (c // gn[0]) * elem_bytes

    def smem(gn, holds):
        return in_smem_bytes(hw, c, elem_bytes, tensors, gn[1], gn[0], threads(gn), vec, holds)

    fits = [gn for gn in splits if smem(gn, True) <= IN_SMEM]
    held = [gn for gn in fits if share(gn) <= IN_SHARE]
    full = [gn for gn in (held or splits) if b * gn[0] * gn[1] >= IN_FILL * sms]
    if held:
        g, n = full[0] if full else most(held)
    elif fits:
        g, n = min(fits, key=share)
    else:
        g, n = full[0] if full else most(splits)
    holds = bool(fits)
    rows = threads((g, n)) // (c // g // vec)
    return InTiling(n, g, threads((g, n)), -(-(-(-hw // n)) // rows), holds, vec,
                    smem((g, n), holds))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _plan(x: torch.Tensor, tensors: int, *others: torch.Tensor) -> InTiling:
    b, h, w, c = x.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, *others))
    return in_tiling(b, h * w, c, x.element_size(), _sm_count(x.device.index), tensors,
                     aligned)


# K9's ticket counters, one per (device, stream): zeroed once, left zero
# by every K9 launch.
_COUNTERS = {}


def _counter(device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    t = _COUNTERS.get(key)
    if t is None:
        t = _COUNTERS[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return t


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
    """`alpha` as JAX multiplies a `dtype` array by it: rounded to dtype
    (float32, then bfloat16 by round-to-nearest-even of the float32 bits)."""
    a = np.float32(alpha)
    if dtype != torch.bfloat16 or a != a:
        return float(a)
    bits = int(a.view(np.uint32))
    return float(np.uint32((bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000).view(np.float32))


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
    y = torch.empty_like(x)
    stats = torch.empty((2, b, c), dtype=torch.float32, device=x.device)
    p = _plan(x, 1)
    code = library().skyhdr_in_fwd_k8(
        *_ptrs(x, g32, b32, y, stats[0], stats[1]), b, hw, c, p.cluster, p.groups,
        p.threads, p.vec, int(p.holds), float(eps), _alpha_in(x.dtype, alpha),
        int(x.dtype == torch.bfloat16), x.device.index, _stream(x))
    check(code, "K8 (instance-norm forward)")
    K8_LAUNCHES += 1
    return y, stats[0], stats[1]


def instance_norm_act_bwd_k9(x, dy, gamma, beta, mean, rstd, *,
                             alpha: float = 1.0):
    """K9 on the card: (dx in x.dtype, dgamma [c] f32, dbeta [c] f32), the
    batch sums in sample order (deterministic). dy is taken in x.dtype."""
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
    dx = torch.empty_like(x)
    # dgamma, dbeta, then each sample's partials [b, c, 2]: one allocation.
    out = torch.empty(2 * c + 2 * b * c, dtype=torch.float32, device=x.device)
    dgamma, dbeta, part = out[:c], out[c:2 * c], out[2 * c:]
    p = _plan(x, 2, dy)
    stream = _stream(x)
    code = library().skyhdr_in_bwd_k9(
        *_ptrs(x, dy, g32, b32, mean, rstd, part, _counter(x.device, stream), dgamma,
               dbeta, dx), b, hw, c, p.cluster, p.groups, p.threads, p.vec, int(p.holds),
        float(alpha), int(x.dtype == torch.bfloat16), x.device.index, stream)
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
