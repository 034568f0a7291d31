"""Sample packing on the card: three ways to get [B,H,W,C] ->
[B/P,H,W,P*C], each timed feeding the packed DA forward (K10's prodbf16
body on the packed samples), so the consumer reads what the packer wrote.

    python -m skyhdr_torch.tools.exp_pack [--b 32] [--h 64] [--w 256]
        [--c 64] [--f 64] [--iters 12] [--device cuda]

Two samples are packed (P = 2). Packers: transpose (a permute made
contiguous, one PyTorch call), concat (the strided slices side by side,
K11's plain version) and kernel (K11).
Prints ms and the largest difference from the first packer's output.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from skyhdr_torch.ops.kernels.probes import (pack_samples, pack_samples_library,
                                             pack_samples_ref)
from skyhdr_torch.tools import describe, device_of, time_inputs
from skyhdr_torch.tools.exp_daconv import forward_pack

P = 2  # samples packed along the channels
PACKERS = (("transpose", pack_samples_library), ("concat", pack_samples_ref),
           ("kernel", pack_samples))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    for name, default in (("b", 32), ("h", 64), ("w", 256), ("c", 64), ("f", 64),
                          ("iters", 12)):
        ap.add_argument(f"--{name}", type=int, default=default)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = device_of(args.device)

    b, h, w, c, f = args.b, args.h, args.w, args.c, args.f
    rng = np.random.default_rng(0)
    inputs = [torch.from_numpy(rng.normal(size=(b, h, w, c)).astype(np.float32)).to(dev)
              for _ in range(args.iters)]
    k = torch.from_numpy((rng.normal(size=(9 * c, f)) * 0.05).astype(np.float32)).to(dev)
    bias = torch.zeros((f,), dtype=torch.float32, device=dev)
    print(describe(dev), flush=True)

    ref = None
    for name, packer in PACKERS:
        def fn(xx, packer=packer):
            return forward_pack(xx, k, p=P, packer=packer) + bias

        out = fn(inputs[0])
        if ref is None:
            ref = out
        err = float((out - ref).abs().max())
        t = time_inputs(fn, inputs)
        print(f"pack={name:>10}: {t*1e3:7.3f} ms  maxerr {err:.2e}", flush=True)


if __name__ == "__main__":
    main()
