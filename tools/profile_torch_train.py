"""Where the port's train steps spend their device time, on a CUDA card.

    python tools/profile_torch_train.py --imheight 64 --imwidth 256 --batch 64 --step gan
    python tools/profile_torch_train.py --batch 32 --step sun
    python tools/profile_torch_train.py --step gan --fused-in   # fused_instance_norm
    python tools/profile_torch_train.py --step gan --da-kernel-size 5
    python tools/profile_torch_train.py --batch 8 --step sun --optim plain --eval 4

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
of zeros of the parameters' shapes): under `--optim plain` the kernel
groups cannot tell them apart from other elementwise work. TF32 is off. The table also goes to
chiprun_out/profile_train_<step>_<h>x<w>_b<b>.json.

The step is also split four ways: the optimizer update and the
degradation draw (`data/degradation.py:draw_degradation`), each timed as a
`torch.profiler.record_function` range (its host milliseconds, and the
device time of the kernels launched inside it), the model's kernels (the
rest of the kernel time: K1-K3, cuDNN, GEMM, the losses) and the device's
idle time (the step's CUDA-event time less all kernel time). `--optim
plain` runs the optimizers' eager chain (`step_plain`) instead of K13, the
update before K13 existed; `--eval N` then profiles N batches of the eval
step (the epoch's pass over the test set) the same way.
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
    for key, group in (("in_fwd_kernel", "K8 IN forward"), ("in_bwd_kernel", "K9 IN backward"),
                       ("optim_kernel", "K13 optimizer update")):
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


OPT_RANGE, DRAW_RANGE = "optimizer update", "degradation draw"


def _ranged(name, fn):
    """`fn` inside a `torch.profiler.record_function` range named `name`."""
    import torch

    def run(*a, **kw):
        with torch.profiler.record_function(name):
            return fn(*a, **kw)

    return run


def _device_us(evt, own: bool) -> float:
    """An event's device microseconds: its own kernels' (`own`) or, for a
    host range, those of every kernel launched inside it."""
    for attr in (("self_device_time_total", "self_cuda_time_total") if own
                 else ("device_time_total", "cuda_time_total")):
        t = getattr(evt, attr, None)
        if t is not None:
            return t
    return 0.0


def profiled(run, state, iters, ksize):
    """`iters` calls `state = run(state)` under torch.profiler: (ms a call by
    CUDA events, the device kernels by name, {range: (host ms, device ms)
    a call} of the two named ranges)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start.record()
        for _ in range(iters):
            state = run(state)
        end.record()
        torch.cuda.synchronize()
    rows, ranges = [], {OPT_RANGE: (0.0, 0.0), DRAW_RANGE: (0.0, 0.0)}
    for evt in prof.key_averages():
        if evt.key in ranges:
            if evt.device_type == torch.autograd.DeviceType.CPU:
                ranges[evt.key] = (evt.cpu_time_total / 1000.0 / iters,
                                   _device_us(evt, own=False) / 1000.0 / iters)
            continue  # its GPU-side annotation is no kernel
        t = _device_us(evt, own=True)
        if t > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            rows.append({"kernel": evt.key, "group": group_of(evt.key, ksize),
                         "ms_per_step": t / 1000.0 / iters, "calls_per_step": evt.count / iters})
    rows.sort(key=lambda r: -r["ms_per_step"])
    return start.elapsed_time(end) / iters, rows, ranges


def split(step_ms, rows, ranges) -> dict:
    """A call's milliseconds four ways: the optimizer's and the draw's
    device time (with their host time beside them), the model's kernels
    (the rest of the kernel time) and the device's idle time. K13 is
    launched through ctypes, so the profiler ties none of its kernels to
    the optimizer's range: they are added to it by name."""
    busy = sum(r["ms_per_step"] for r in rows)
    (opt_host, opt_dev), (draw_host, draw_dev) = ranges[OPT_RANGE], ranges[DRAW_RANGE]
    opt_dev += sum(r["ms_per_step"] for r in rows if r["group"] == "K13 optimizer update")
    return {"step": step_ms, "optimizer (device)": opt_dev, "optimizer (host)": opt_host,
            "degradation draw (device)": draw_dev, "degradation draw (host)": draw_host,
            "model kernels": busy - opt_dev - draw_dev, "device idle": step_ms - busy}


def main(argv=None):
    import torch

    sys.path.insert(0, ROOT)
    from skyhdr_torch.config import Config, DataConfig, ModelConfig
    from skyhdr_torch.data import degradation
    from skyhdr_torch.data.degradation import make_banks
    from skyhdr_torch.models.vgg16 import random_vgg16_weights
    from skyhdr_torch.train.engine import (create_gan_state, create_sun_state,
                                           make_gan_eval_step, make_gan_train_step,
                                           make_sun_eval_step, make_sun_train_step)
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
    p.add_argument("--optim", choices=("kernel", "plain"), default="kernel",
                   help="the optimizer update: K13 (the port's route on the card) or the "
                        "eager chain it is held to")
    p.add_argument("--eval", type=int, default=0,
                   help="eval-step batches to profile after the train steps")
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
        vgg = random_vgg16_weights()
        step = make_gan_train_step(cfg, banks, vgg)
        eval_step = make_gan_eval_step(cfg, banks, vgg)
        optimizers = {"RMSprop gen+sun": state.opt_gen, "RMSprop disc": state.opt_disc}
    else:
        state = create_sun_state(cfg, 0, "cuda")
        step = make_sun_train_step(cfg, banks)
        eval_step = make_sun_eval_step(cfg, banks)
        optimizers = {"Adam sun": state.opt}
    for name, opt in optimizers.items():
        opt.step = _ranged(OPT_RANGE, opt.step_plain if args.optim == "plain" else opt.step)
    degradation.draw_degradation = _ranged(DRAW_RANGE, degradation.draw_degradation)
    gen = torch.Generator(device="cuda").manual_seed(0)
    batch = {"hdr": torch.rand(b, h, w, 3, device="cuda", generator=gen) * 2.0,
             "elevation": torch.linspace(4, 28, b, device="cuda")}
    key = jax_random.key(0)
    for _ in range(2):
        state, _ = step(state, batch, key)
    torch.cuda.synchronize()

    def train(st):
        return step(st, batch, key)[0]

    step_ms, rows, ranges = profiled(train, state, args.iters, args.da_kernel_size)
    busy = sum(r["ms_per_step"] for r in rows)
    groups = {}
    for r in rows:
        groups[r["group"]] = groups.get(r["group"], 0.0) + r["ms_per_step"]
    evals = None
    if args.eval:
        eval_step(state, batch, key)
        eval_ms, eval_rows, eval_ranges = profiled(
            lambda st: (eval_step(st, batch, key), st)[1], state, args.eval,
            args.da_kernel_size)
        evals = split(eval_ms, eval_rows, eval_ranges)

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
    tag += "_plain_optim" if args.optim == "plain" else ""
    parts = split(step_ms, rows, ranges)
    print(f"[profile] train {tag} on {smi}: step {step_ms:.4f} ms (CUDA events, "
          f"{args.iters} steps under the profiler), kernel time {busy:.4f} ms, device "
          f"busy {100 * busy / step_ms:.1f}%, idle {100 * (1 - busy / step_ms):.1f}%")
    for what, part in (("train step", parts), ("eval batch", evals)):
        if part is not None:
            print(f"[profile] train {tag} split of a {what} ({args.optim} optimizer): "
                  + ", ".join(f"{k} {v:.4f} ms" for k, v in part.items()))
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile] train {tag} group {g}: {ms:.4f} ms/step "
              f"({100 * ms / step_ms:.1f}% of the step)")
    for name, ms in opt_ms.items():
        print(f"[profile] train {tag} optimizer {name} alone: {ms:.4f} ms/step "
              f"(median of 5, CUDA events; inside the "
              f"{'elementwise' if args.optim == 'plain' else 'K13'} group above)")
    for r in rows[:15]:
        print(f"[profile] train {tag} {r['ms_per_step']:.4f} ms x{r['calls_per_step']:.0f} "
              f"[{r['group']}] {r['kernel'][:110]}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"profile_train_{tag}.json"), "w") as f:
        json.dump({"device": smi, "step_ms": step_ms, "kernel_ms": busy, "groups": groups,
                   "optimizer_ms": opt_ms, "optim": args.optim, "split": parts,
                   "eval_split": evals, "kernels": rows}, f, indent=1)


if __name__ == "__main__":
    main()
