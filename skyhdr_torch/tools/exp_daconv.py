"""DA-conv forward probes on the card: the k=3 DA forward in design
variants (K10), timed against the production kernel (K1) and the plain
gather path, each checked against the plain DA conv.

    python -m skyhdr_torch.tools.exp_daconv [--b 32] [--h 64] [--w 256]
        [--c 64] [--f 64] [--iters 12] [--variants prod,a2,a4,a8,b4]
        [--device cuda]

Variant names (r: output rows per block, 1, 2, 4, 8 or 16; p: samples
packed along the channels, 2 or 4 with p*c <= 128):
  a{r} / a{r}h      direct reads from device memory, f32 / bf16 storage
  c{r} / c{r}h      the sample tile in shared memory, one product per tap
  cs{r} / cs{r}h    nine taps staged, one product of depth 9c
  b{r}              cs{r}h (the staged variant with bf16 storage)
  prodbf16          bf16 samples and K on the tensor cores, bf16 storage
  pairc             two taps per product, bf16 storage
  noroll, nomm, mmonly, mmbf16, fullbf16, loadonly, load1only, mmhoist
                    diag modes (a stage isolated; only fullbf16 is checked)
  pack{p}           prodbf16 on p samples packed along the channels
  pack{p}r          c2h on the packed samples
  pack{p}:{mode}[f] a diag mode on pre-packed samples (f: f32 storage)
  pack{p}k          pack{p} on pre-packed samples (kernel only)
  dd{p} / dd{p}m{m} / dd{p}k   the row-dedup variant (m rows stacked)
  xla               the plain gather path; prod: the production K1
Aliases, which run their base's kernel and say so: a{r}p and c{r}p (a
grid's dimension semantics has no counterpart on the card), pairs (scratch
against value concatenation, the same on the card).
"""

from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

from skyhdr_torch.ops.distortion import deformable_conv2d
from skyhdr_torch.ops.kernels import deform_conv as dc
from skyhdr_torch.ops.kernels.probes import (blockdiag_kernel, da_probe, find_probe,
                                             pack_samples, unpack_samples)
from skyhdr_torch.tools import describe, device_of, time_inputs

BF16, F32 = torch.bfloat16, torch.float32
DIAG_VARIANTS = ("noroll", "nomm", "mmonly", "mmbf16", "fullbf16", "loadonly",
                 "load1only", "mmhoist")
PACK_DIAG_MODES = ("mmonly", "mmhoist", "loadonly", "load1only", "nomm", "noroll",
                   "fullbf16")


def forward_a(x, kernel, *, rblk=2, store=F32):
    """Direct per-tap reads of the source rows from device memory."""
    return da_probe(x, kernel, find_probe(store, gather="direct"), rblk=rblk)


def forward_b(x, kernel, *, rblk=2, store=F32):
    """The samples of the nine taps staged as [TW, 9c], one product."""
    return da_probe(x, kernel, find_probe(store, taps=9), rblk=rblk)


def forward_c(x, kernel, *, rblk=2, store=F32, staged=False):
    """The sample tile in shared memory, one product per tap; staged=True
    is forward_b."""
    return da_probe(x, kernel, find_probe(store, taps=9 if staged else 1), rblk=rblk)


def forward_prodbf16(x, kernel, *, rblk=2, store=BF16):
    """bf16 samples and K into the tensor cores, f32 accumulation."""
    return da_probe(x, kernel, find_probe(store, mma=True), rblk=rblk)


def forward_diag(x, kernel, mode, *, rblk=2, store=BF16):
    """One stage of the forward isolated (`mode` in DIAG_VARIANTS): mmbf16
    is mmonly on the tensor cores, fullbf16 the whole forward there."""
    if mode == "mmbf16":
        name = find_probe(store, mma=True, diag="mmonly")
    elif mode == "fullbf16":
        name = find_probe(store, mma=True)
    else:
        name = find_probe(store, diag=mode)
    return da_probe(x, kernel, name, rblk=rblk)


def forward_pair(x, kernel, *, rblk=2, store=BF16, use_scratch=False):
    """Two taps per product, [TW, 2c] @ [2c, f] (the ninth alone).
    use_scratch selects nothing on the card: both forms are one kernel."""
    del use_scratch
    return da_probe(x, kernel, find_probe(store, taps=2), rblk=rblk)


def _packed_dims(x, p, prepacked):
    b, h, w, c = x.shape
    if prepacked:
        b, c = b * p, c // p
    if b % p != 0 or p * c > 128:
        raise ValueError(f"packing p={p} needs b % p == 0 and p*c <= 128, got b={b}, c={c}")


def forward_pack(x, kernel, *, p=2, rblk=2, store=BF16, prepacked=False, roll=False,
                 packer=pack_samples):
    """The forward on p samples packed along the channels with a
    block-diagonal K: the prodbf16 body (roll=False), the c body
    (roll=True) or a diag mode (roll=<mode>). Returns [b,h,w,f] unless
    prepacked (then x and the result stay packed)."""
    _packed_dims(x, p, prepacked)
    xk = x if prepacked else packer(x, p)
    kb = blockdiag_kernel(kernel.float(), p)
    if roll is True:
        out = forward_c(xk, kb, rblk=rblk, store=store)
    elif isinstance(roll, str):
        out = forward_diag(xk, kb, roll, rblk=rblk, store=store)
    else:
        out = forward_prodbf16(xk, kb, rblk=rblk, store=store)
    return out if prepacked else unpack_samples(out, p)


def forward_dedup(x, kernel, *, p=1, rblk=2, mblk=1, store=BF16, prepacked=False):
    """One y-interpolation per (row, kernel row), mblk rows stacked in the
    tile's M, optionally on p packed samples."""
    _packed_dims(x, p, prepacked)
    packed = prepacked or p == 1
    xk = x if packed else pack_samples(x, p)
    kb = kernel.float() if p == 1 else blockdiag_kernel(kernel.float(), p)
    out = da_probe(xk, kb, find_probe(store, dedup=True), rblk=rblk, mblk=mblk)
    return out if packed else unpack_samples(out, p)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--b", type=int, default=32)
    ap.add_argument("--h", type=int, default=64)
    ap.add_argument("--w", type=int, default=256)
    ap.add_argument("--c", type=int, default=64)
    ap.add_argument("--f", type=int, default=64)
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--variants", type=str, default="prod,a2,a4,a8,b4")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_of(args.device)

    rng = np.random.default_rng(0)
    shape = (args.b, args.h, args.w, args.c)
    k = torch.from_numpy((rng.normal(size=(9 * args.c, args.f)) * 0.05).astype(np.float32)).to(dev)
    inputs = [torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dev)
              for _ in range(args.iters)]
    bias = torch.zeros((args.f,), dtype=torch.float32, device=dev)
    flops = 2 * args.b * args.h * args.w * 9 * args.c * args.f
    ref = deformable_conv2d(inputs[0], k, bias)
    scale = float(ref.abs().max())
    print(describe(dev), flush=True)

    def report(name, fn, check=True, note=""):
        try:
            out = fn(inputs[0])
        except (ValueError, RuntimeError) as e:
            print(f"{name:>14}: FAILED {type(e).__name__}: {e}", flush=True)
            return
        err = float((out - ref).abs().max()) if check else 0.0
        t = time_inputs(fn, inputs)
        print(f"{name:>14}: {t*1e3:7.3f} ms  {flops/t/1e12:6.2f} TF/s  "
              f"maxerr {err:.2e} (rel {err/(scale if check else 1.0):.2e}){note}",
              flush=True)

    def kernel_only(name, fn, packed, note):
        t = time_inputs(fn, packed)
        print(f"{name:>14}: {t*1e3:7.3f} ms  {flops/t/1e12:6.2f} TF/s  ({note})", flush=True)

    def prepack(p):
        return [pack_samples(x, p) for x in inputs]

    variants = args.variants.split(",")
    for p in (1, 2, 4):
        if f"dd{p}" in variants:
            report(f"dd{p}", lambda xx, pp=p: forward_dedup(xx, k, p=pp) + bias)
        for mb in (2, 4, 8):
            if f"dd{p}m{mb}" in variants:
                report(f"dd{p}m{mb}", lambda xx, pp=p, mm=mb: forward_dedup(
                    xx, k, p=pp, rblk=mm, mblk=mm) + bias)
        if f"dd{p}k" in variants and p > 1:
            kernel_only(f"dd{p}k", functools.partial(forward_dedup, kernel=k, p=p,
                                                     prepacked=True),
                        prepack(p), "kernel only, no repack")
    for p in (2, 4):
        if f"pack{p}" in variants:
            report(f"pack{p}", lambda xx, pp=p: forward_pack(xx, k, p=pp) + bias)
        if f"pack{p}r" in variants:
            report(f"pack{p}r", lambda xx, pp=p: forward_pack(xx, k, p=pp, roll=True) + bias)
        for mode in PACK_DIAG_MODES:
            for sfx, sdt in (("", BF16), ("f", F32)):
                if f"pack{p}:{mode}{sfx}" in variants:
                    kernel_only(f"pack{p}:{mode}{sfx}", functools.partial(
                        forward_pack, kernel=k, p=p, prepacked=True, roll=mode, store=sdt),
                        prepack(p), "diag, kernel only")
        if f"pack{p}k" in variants:
            kernel_only(f"pack{p}k", functools.partial(forward_pack, kernel=k, p=p,
                                                       prepacked=True),
                        prepack(p), "kernel only, no repack")
    if "pairc" in variants:
        report("pairc", lambda xx: forward_pair(xx, k) + bias)
    if "pairs" in variants:
        report("pairs", lambda xx: forward_pair(xx, k, use_scratch=True) + bias,
               note="  (alias of pairc: scratch or value concat is one kernel here)")
    if "prodbf16" in variants:
        report("prodbf16", lambda xx: forward_prodbf16(xx, k) + bias)
    for mode in DIAG_VARIANTS:
        if mode in variants:
            report(mode, lambda xx, m=mode: forward_diag(xx, k, m) + bias,
                   check=(mode == "fullbf16"))
    if "xla" in variants:
        report("xla", lambda xx: deformable_conv2d(xx, k, bias))
    if "prod" in variants:
        prod = dc.da_conv_forward_k1 if dev.type == "cuda" else dc.da_conv_forward_ref
        report("prod", lambda xx: prod(xx, k, bias))
    alias = "  (alias of {}: grid dimension semantics have no counterpart on the card)"
    for rblk in (1, 2, 4, 8, 16):
        if f"a{rblk}" in variants:
            report(f"a{rblk}", lambda xx, rb=rblk: forward_a(xx, k, rblk=rb) + bias)
        if f"a{rblk}p" in variants:
            report(f"a{rblk}p", lambda xx, rb=rblk: forward_a(xx, k, rblk=rb) + bias,
                   note=alias.format(f"a{rblk}"))
        if f"a{rblk}h" in variants:
            report(f"a{rblk}h", lambda xx, rb=rblk: forward_a(xx, k, rblk=rb,
                                                              store=BF16) + bias)
        if f"c{rblk}" in variants:
            report(f"c{rblk}", lambda xx, rb=rblk: forward_c(xx, k, rblk=rb) + bias)
        if f"c{rblk}p" in variants:
            report(f"c{rblk}p", lambda xx, rb=rblk: forward_c(xx, k, rblk=rb) + bias,
                   note=alias.format(f"c{rblk}"))
        if f"c{rblk}h" in variants:
            report(f"c{rblk}h", lambda xx, rb=rblk: forward_c(xx, k, rblk=rb,
                                                              store=BF16) + bias)
        if f"cs{rblk}h" in variants:
            report(f"cs{rblk}h", lambda xx, rb=rblk: forward_c(xx, k, rblk=rb, staged=True,
                                                                store=BF16) + bias)
        if f"cs{rblk}" in variants:
            report(f"cs{rblk}", lambda xx, rb=rblk: forward_c(xx, k, rblk=rb,
                                                               staged=True) + bias)
        if f"b{rblk}" in variants:
            report(f"b{rblk}", lambda xx, rb=rblk: forward_b(xx, k, rblk=rb,
                                                             store=BF16) + bias)


if __name__ == "__main__":
    main()
