"""Where the port's serving forward spends its device time, on a CUDA card.

    python tools/profile_torch_infer.py --imheight 64 --imwidth 256 --batch 32 --da-conv true
    python tools/profile_torch_infer.py --batch 32 --da-kernel-size 5

Builds the models with seeded weights, warms up, then runs `--iters`
forwards under `torch.profiler` (CPU + CUDA activity) and prints the
kernels by device time, grouped into the DA kernels (K1, K2; K5 at
`--da-kernel-size 5`), cuDNN
convolutions, GEMMs and the rest, with the device busy share of the window
(summed kernel time over the window's CUDA-event time; one stream, so
kernels do not overlap). The table also goes to
chiprun_out/profile_<h>x<w>_b<b>_<da|plain>.json.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def group_of(name: str, ksize: int = 3) -> str:
    from profile_torch_train import da_group

    da = da_group(name, ksize)
    if da:
        return da
    n = name.lower()
    if "conv" in n or "cudnn" in n or "implicit" in n or "winograd" in n:
        return "cuDNN conv"
    if "gemm" in n or "gemv" in n or "cutlass" in n or "sm90_xmma" in n:
        return "GEMM"
    if "reduce" in n:
        return "reductions"
    return "elementwise/other"


def main(argv=None):
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, ROOT)
    from skyhdr_torch.cli.common import str2bool
    from skyhdr_torch.config import Config, ModelConfig
    from skyhdr_torch.train.engine import build_models, make_inference_fn
    from skyhdr_torch.utils.transplant import init_model_vars, load_model_vars

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--imheight", type=int, default=64)
    p.add_argument("--imwidth", type=int, default=256)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--da-conv", type=str2bool, default=True)
    p.add_argument("--da-kernel-size", type=int, default=3)
    p.add_argument("--iters", type=int, default=5)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_infer: needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    cfg = Config(model=ModelConfig(im_height=args.imheight, im_width=args.imwidth,
                                   use_da_conv=args.da_conv,
                                   da_kernel_size=args.da_kernel_size))
    gen, sun = build_models(cfg, "cuda")
    gv, sv = init_model_vars(cfg, 0)
    load_model_vars(gen, gv)
    load_model_vars(sun, sv)
    del gv, sv
    infer = make_inference_fn(cfg)
    x = torch.rand(args.batch, args.imheight, args.imwidth, 3, device="cuda")
    for _ in range(3):
        infer(gen, sun, x)
    torch.cuda.synchronize()

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(args.iters):
            infer(gen, sun, x)
        end.record()
        torch.cuda.synchronize()
    window_ms = start.elapsed_time(end)

    rows = []
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = getattr(evt, "self_cuda_time_total", 0.0)
        if t > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append({"kernel": evt.key, "group": group_of(evt.key, args.da_kernel_size),
                         "ms_per_forward": t / 1000.0 / args.iters,
                         "calls_per_forward": evt.count / args.iters})
    rows.sort(key=lambda r: -r["ms_per_forward"])
    busy = sum(r["ms_per_forward"] for r in rows)
    fwd_ms = window_ms / args.iters
    groups = {}
    for r in rows:
        groups[r["group"]] = groups.get(r["group"], 0.0) + r["ms_per_forward"]

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    tag = (f"{args.imheight}x{args.imwidth}_b{args.batch}_"
           f"{'da' if args.da_conv else 'plain'}"
           f"{args.da_kernel_size if args.da_conv and args.da_kernel_size != 3 else ''}")
    print(f"[profile] {tag} on {smi}: forward {fwd_ms:.4f} ms (CUDA events, "
          f"{args.iters} forwards under the profiler), kernel time "
          f"{busy:.4f} ms, device busy {100 * busy / fwd_ms:.1f}%, idle "
          f"{100 * (1 - busy / fwd_ms):.1f}%")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {tag} group {g}: {ms:.4f} ms/forward "
              f"({100 * ms / fwd_ms:.1f}% of the forward)")
    for r in rows[:12]:
        print(f"[profile] {tag} {r['ms_per_forward']:.4f} ms x{r['calls_per_forward']:.0f} "
              f"[{r['group']}] {r['kernel'][:110]}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"profile_{tag}.json"), "w") as f:
        json.dump({"device": smi, "forward_ms": fwd_ms, "kernel_ms": busy,
                   "groups": groups, "kernels": rows}, f, indent=1)


if __name__ == "__main__":
    main()
