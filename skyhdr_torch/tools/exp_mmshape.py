"""Dot-shape microbench on the card: what a small dot costs inside a
kernel (K12). Total contraction work is held at the DA conv's budget
(2048 row-blocks, 9 taps of [256,64]@[64,64] each):
  a18 : 18 dots of [256, 64]@[ 64, 64] per block, 1024 blocks
  b9  :  9 dots of [256,128]@[128, 64]            (tap-paired)
  c3  :  3 dots of [256,384]@[384, 64]            (6 taps fused)
  d2  :  2 dots of [256,576]@[576, 64]            (9 taps fused, padded)
  t18 : 18 dots of [ 64, 64]@[ 64,256]            (transposed form)
  tb9 :  9 dots of [ 64,128]@[128,256]
Each also with bf16 inputs on the tensor cores with the 'h' suffix.

    python -m skyhdr_torch.tools.exp_mmshape [--variants a18,b9,...]
        [--steps N] [--iters 12] [--device cuda]

--steps replaces the blocks of every configuration (1024), for a small run.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from skyhdr_torch.ops.kernels.probes import mm_shape
from skyhdr_torch.tools import describe, device_of, time_inputs

# name: (m, k, f, ndots, steps); 2*m*k*f*ndots*steps = 38.65 GFLOP each
CFGS = {
    "a18": (256, 64, 64, 18, 1024),
    "b9": (256, 128, 64, 9, 1024),
    "c3": (256, 384, 64, 3, 1024),
    "d2": (256, 576, 64, 2, 1024),
    "t18": (64, 64, 256, 18, 1024),
    "tb9": (64, 128, 256, 9, 1024),
}


def make_bench(m, k, f, ndots, steps, dtype):
    """fn(x) = ndots * (x[:m,:k] @ x[:k,:f]) computed by `steps` blocks,
    the operands cast to dtype."""
    def run(x):
        return mm_shape(x[:m, :k].to(dtype).contiguous(), x[:k, :f].to(dtype).contiguous(),
                        ndots=ndots, steps=steps)
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", type=str, default="a18,b9,c3,d2,t18,a18h,b9h,d2h")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--iters", type=int, default=12)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_of(args.device)
    rng = np.random.default_rng(0)
    inputs = [torch.from_numpy(rng.normal(size=(600, 600)).astype(np.float32)).to(dev)
              for _ in range(args.iters)]
    print(describe(dev), flush=True)
    for name in args.variants.split(","):
        base = name[:-1] if name.endswith("h") else name
        dtype = torch.bfloat16 if name.endswith("h") else torch.float32
        if base not in CFGS:
            continue
        m, k, f, ndots, steps = CFGS[base]
        steps = args.steps or steps
        t = time_inputs(make_bench(m, k, f, ndots, steps, dtype), inputs)
        flops = 2 * m * k * f * ndots * steps
        print(f"{name:>6}: {t*1e3:7.3f} ms  {flops/t/1e12:6.2f} TF/s "
              f"({m}x{k}@{k}x{f} x{ndots} x{steps})", flush=True)


if __name__ == "__main__":
    main()
