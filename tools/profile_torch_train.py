"""Where the port's train steps spend their device time, on a CUDA card.

    python tools/profile_torch_train.py --imheight 64 --imwidth 256 --batch 64 --step gan
    python tools/profile_torch_train.py --batch 32 --step sun
    python tools/profile_torch_train.py --step gan --fused-in   # fused_instance_norm
    python tools/profile_torch_train.py --step gan --da-kernel-size 5

Builds the state from the seeded weights (`create_gan_state` /
`create_sun_state`), warms up with two steps, then runs `--iters` steps
under `torch.profiler` (CPU + CUDA activity) and prints the kernels by
device time, grouped into the DA kernels (K1, K2, K3; K5, K6, K7 at
`--da-kernel-size` other than 3), the fused
InstanceNorm kernels (K8, K9, with `--fused-in`), cuDNN convolutions
(forward, data gradient, weight gradient, and cuDNN's FFT kernels, whose
names do not say the direction), GEMMs, reductions and the rest,
with the device busy share of the window (summed kernel time over the
window's CUDA-event time; one stream, so kernels do not overlap). Then it
times the optimizer updates alone (CUDA events, median of 5, on gradients
of zeros of the parameters' shapes), which the kernel groups cannot tell
apart from other elementwise work. TF32 is off. The table also goes to
chiprun_out/profile_train_<step>_<h>x<w>_b<b>.json.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# The DA kernels by name (csrc/deform_conv.cu): K1/K5, K2/K7 and K3/K6 are
# one template each, told apart by its kernel-size argument (3, or 0 for a
# size given at run time).
DA_GROUPS = ((r"da_fwd_kernel<[^,>]*, 3, \d+>", "K1 DA forward"),
             (r"da_fwd_kernel<[^,>]*, 0, \d+>", "K5 DA forward"),
             (r"da_dx_kernel<3>", "K2 DA input grad"), (r"da_dx_kernel<0>", "K7 DA input grad"),
             (r"da_dk_kernel<[^,>]*, 3, \d+>", "K3 DA weight grad"),
             (r"da_dk_kernel<[^,>]*, 0, \d+>", "K6 DA weight grad"))


def da_group(name: str, ksize: int):
    """The DA kernel group of a device kernel's name, or None. The
    weight gradient's reduction pass is K3's at k=3 and K6's otherwise."""
    for pattern, group in DA_GROUPS:
        if re.search(pattern, name):
            return group
    if "da_dk_reduce" in name:
        return "K3 DA weight grad" if ksize == 3 else "K6 DA weight grad"
    return None


def group_of(name: str, ksize: int = 3) -> str:
    da = da_group(name, ksize)
    if da:
        return da
    n = name.lower()
    for key, group in (("in_fwd_kernel", "K8 IN forward"), ("in_bwd_kernel", "K9 IN backward")):
        if key in n:
            return group
    if "fft" in n or "pointwise_mult_and_sum_complex" in n:
        return "cuDNN conv FFT (any direction)"
    if "dgrad" in n:
        return "cuDNN conv data grad"
    if "wgrad" in n:
        return "cuDNN conv weight grad"
    if "conv" in n or "cudnn" in n or "implicit" in n or "winograd" in n or "fprop" in n:
        return "cuDNN conv forward"
    if "gemm" in n or "gemv" in n or "cutlass" in n or "sm90_xmma" in n:
        return "GEMM"
    if "reduce" in n:
        return "reductions"
    return "elementwise/other"


def main(argv=None):
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, ROOT)
    from skyhdr_torch.config import Config, DataConfig, ModelConfig
    from skyhdr_torch.data.degradation import make_banks
    from skyhdr_torch.models.vgg16 import random_vgg16_weights
    from skyhdr_torch.train.engine import (create_gan_state, create_sun_state,
                                           make_gan_train_step, make_sun_train_step)
    from skyhdr_torch.utils import jax_random
    from skyhdr_torch.utils.io import get_exposure_lists, make_synthetic_dorf

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--imheight", type=int, default=64)
    p.add_argument("--imwidth", type=int, default=256)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--step", choices=("gan", "sun"), default="gan")
    p.add_argument("--iters", type=int, default=3)
    p.add_argument("--fused-in", action="store_true",
                   help="ModelConfig.fused_instance_norm (K8/K9 on every InstanceNorm)")
    p.add_argument("--da-kernel-size", type=int, default=3,
                   help="ModelConfig.da_kernel_size (5: the trunk's 12 convs are 5x5 DA "
                        "convs, on K5/K6/K7)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    h, w, b = args.imheight, args.imwidth, args.batch
    cfg = Config(model=ModelConfig(im_height=h, im_width=w, use_da_conv=True,
                                   da_kernel_size=args.da_kernel_size,
                                   fused_instance_norm=args.fused_in),
                 data=DataConfig(batch_size=b))
    banks = make_banks(make_synthetic_dorf(175, 1024), get_exposure_lists()[0], device="cuda")
    if args.step == "gan":
        state = create_gan_state(cfg, 0, "cuda")
        step = make_gan_train_step(cfg, banks, random_vgg16_weights())
        optimizers = {"RMSprop gen+sun": state.opt_gen, "RMSprop disc": state.opt_disc}
    else:
        state = create_sun_state(cfg, 0, "cuda")
        step = make_sun_train_step(cfg, banks)
        optimizers = {"Adam sun": state.opt}
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"hdr": torch.rand(b, h, w, 3, device="cuda", generator=gen) * 2.0,
             "elevation": torch.linspace(4, 28, b, device="cuda")}
    key = jax_random.key(0)
    for _ in range(2):
        state, _ = step(state, batch, key)
    torch.cuda.synchronize()

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(args.iters):
            state, _ = step(state, batch, key)
        end.record()
        torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / args.iters

    rows = []
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = getattr(evt, "self_cuda_time_total", 0.0)
        if t > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append({"kernel": evt.key, "group": group_of(evt.key, args.da_kernel_size),
                         "ms_per_step": t / 1000.0 / args.iters,
                         "calls_per_step": evt.count / args.iters})
    rows.sort(key=lambda r: -r["ms_per_step"])
    busy = sum(r["ms_per_step"] for r in rows)
    groups = {}
    for r in rows:
        groups[r["group"]] = groups.get(r["group"], 0.0) + r["ms_per_step"]

    opt_ms = {}
    for name, opt in optimizers.items():
        zeros = [torch.zeros_like(q) for q in opt.params]
        times = []
        for _ in range(6):
            a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            opt.step(zeros)
            z.record()
            torch.cuda.synchronize()
            times.append(a.elapsed_time(z))
        opt_ms[name] = statistics.median(times[1:])
        del zeros

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    tag = (f"{args.step}_{h}x{w}_b{b}" + ("_fused_in" if args.fused_in else "")
           + (f"_da{args.da_kernel_size}" if args.da_kernel_size != 3 else ""))
    print(f"[profile] train {tag} on {smi}: step {step_ms:.4f} ms (CUDA events, "
          f"{args.iters} steps under the profiler), kernel time {busy:.4f} ms, device "
          f"busy {100 * busy / step_ms:.1f}%, idle {100 * (1 - busy / step_ms):.1f}%")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile] train {tag} group {g}: {ms:.4f} ms/step "
              f"({100 * ms / step_ms:.1f}% of the step)")
    for name, ms in opt_ms.items():
        print(f"[profile] train {tag} optimizer {name} alone: {ms:.4f} ms/step "
              f"(median of 5, CUDA events; inside the elementwise group above)")
    for r in rows[:15]:
        print(f"[profile] train {tag} {r['ms_per_step']:.4f} ms x{r['calls_per_step']:.0f} "
              f"[{r['group']}] {r['kernel'][:110]}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"profile_train_{tag}.json"), "w") as f:
        json.dump({"device": smi, "step_ms": step_ms, "kernel_ms": busy, "groups": groups,
                   "optimizer_ms": opt_ms, "kernels": rows}, f, indent=1)


if __name__ == "__main__":
    main()
