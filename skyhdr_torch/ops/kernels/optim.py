"""The optimizer update as one CUDA pass on Hopper: the kernel wrapper and
its plain PyTorch version (csrc/optim.cu).

  K13 `optim_step_k13` — one launch a leaf: reads the parameter (or its
      float32 master), the gradient and the moments once, writes them once.
      It replaces no Pallas kernel: `skyhdr` leaves optax's update to XLA,
      which fuses it under `jit`; this is the port's counterpart of that
      fusion. Plain version: `optim_step_ref`, the kernel's per-element
      formula in torch, and the eager chain of `train/optim.py`
      (`_Optimizer.step_plain`), which the kernel is held to bit for bit.

The update (`train/optim.py` has the optimizers): RMSprop (`adam` False)
or Adam, over float32 or bfloat16 gradients and moments, with float32
parameters or bfloat16 parameters under a float32 master. `Consts` carries
the constants as the eager chain rounds them; `k13_args` turns them into
the kernel's arguments (the reciprocals of Adam's bias corrections, as ATen
divides by a host scalar on the card).

Dispatch is by device in `train/optim.py`: a CPU leaf takes the eager
chain, a CUDA leaf launches K13 or raises. `K13_LAUNCHES` counts wrapper
calls that launch.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

K13_LAUNCHES = 0


class Consts(NamedTuple):
    """An update's constants, each a float32 value as the eager chain rounds
    it: the decays (`decay_mu` 0 for RMSprop), the terms' 1 - decay in the
    term's type (`_weak`), eps, -lr, and Adam's bias corrections c1, c2
    (1 for RMSprop)."""
    decay_mu: float
    decay_nu: float
    term_mu: float
    term_nu: float
    eps: float
    neg_lr: float
    c1: float
    c2: float


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _recip(c: float) -> float:
    """1/c as ATen's CUDA division by a host scalar takes it: the float32
    reciprocal of the float32 scalar, computed on the host."""
    return float(np.float32(1.0) / np.float32(c))


def _bf16(t: Optional[torch.Tensor]) -> int:
    return int(t is not None and t.dtype == torch.bfloat16)


def k13_args(adam: bool, p, g, mu, nu, w, c: Consts) -> list:
    """The kernel's arguments after its pointers and length: the dtype
    flags (g, mu, nu bfloat16; a master), whether every pointer is 16-byte
    aligned, and the constants."""
    tensors = [t for t in (p, g, mu, nu, w) if t is not None]
    vec = int(all(t.data_ptr() % 16 == 0 for t in tensors))
    return [_bf16(g), _bf16(mu), _bf16(nu), int(w is not None), vec, c.decay_mu, c.decay_nu,
            c.term_mu, c.term_nu, c.eps, c.neg_lr, _recip(c.c1), _recip(c.c2)]


def _check(adam, p, g, mu, nu, w):
    tensors = [t for t in (p, g, mu, nu, w) if t is not None]
    _require(all(t.is_cuda and t.device == p.device for t in tensors),
             "K13 takes CUDA tensors on one device")
    _require(all(t.is_contiguous() for t in tensors), "K13 operands must be contiguous")
    _require(all(t.numel() == p.numel() for t in tensors),
             "K13: the parameter, gradient, moments and master must have one size")
    _require((mu is not None) == adam, "K13: Adam takes mu, RMSprop none")
    f32_or_bf16 = (torch.float32, torch.bfloat16)
    _require(g.dtype in f32_or_bf16 and nu.dtype in f32_or_bf16
             and (mu is None or mu.dtype in f32_or_bf16),
             "K13 takes float32 or bfloat16 gradients and moments")
    _require(p.dtype == torch.float32 if w is None
             else (p.dtype == torch.bfloat16 and w.dtype == torch.float32),
             "K13 takes float32 parameters, or bfloat16 ones with a float32 master")


def optim_step_k13(adam: bool, p, g, mu, nu, w, c: Consts) -> None:
    """K13 on the card: one leaf's update in place (p, the moments, the
    master `w` where given)."""
    global K13_LAUNCHES
    from skyhdr_torch.ops.kernels.build import check, library

    _check(adam, p, g, mu, nu, w)
    if p.numel() == 0:
        return
    stream = torch.cuda.current_stream(p.device).cuda_stream
    code = library().skyhdr_optim_k13(
        int(adam), p.data_ptr(), None if w is None else w.data_ptr(), g.data_ptr(),
        None if mu is None else mu.data_ptr(), nu.data_ptr(), p.numel(),
        *k13_args(adam, p, g, mu, nu, w, c), p.device.index, stream)
    check(code, "K13 (optimizer update)")
    K13_LAUNCHES += 1


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as ATen computes it on x's device: on the card a product with
    the float32 reciprocal, on the CPU a true division."""
    return x * _recip(c) if x.is_cuda else x / c


def optim_step_ref(adam: bool, p, g, mu, nu, w, c: Consts) -> None:
    """Plain version of K13, in place: the kernel's per-element formula in
    torch on flat tensors, one rounding an operation (bfloat16 terms
    rounded where the kernel rounds them), bit-equal to the eager chain
    on the same device."""
    tb = g.dtype == torch.bfloat16 and w is None

    def term(x):
        return x.bfloat16().float() if tb else x

    gf = g.float()
    nu_new = nu.float() * c.decay_nu + term(term(gf * gf) * c.term_nu)
    if adam:
        mu_new = mu.float() * c.decay_mu + term(gf * c.term_mu)
        u = _div(mu_new, c.c1) / (_div(nu_new, c.c2).sqrt() + c.eps)
        mu.copy_(mu_new)
    else:
        u = (nu_new + c.eps).rsqrt() * gf
    nu.copy_(nu_new)
    target = p if w is None else w
    target.add_(u * c.neg_lr)
    if w is not None:
        p.copy_(w)
