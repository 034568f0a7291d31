"""K8/K9 (the port's fused InstanceNorm kernels) on the card under other
launch plans: the knobs of `skyhdr_torch.ops.kernels.instnorm.in_tiling`
(IN_SHARE, IN_PER_THREAD, IN_CLUSTERS, IN_FILL) set one at a time away
from their values, at the model's InstanceNorm shapes at 64x256 (b32, b64;
f32 and bf16; slope 0.1), device ms with work queued ahead:

    python tools/sweep_torch_instnorm.py

Prints one line per (setting, shape) with each kernel's plan and share of
its bound, then each setting's K8/K9 total per GAN step and per serving
dispatch; writes chiprun_out/sweep_instnorm.json. Needs a CUDA card.
"""

import importlib.util
import json
import os
import statistics
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Settings: the plan's own knobs, then each changed alone.
SETTINGS = [{}, {"IN_SHARE": 32 * 1024}, {"IN_SHARE": 128 * 1024},
            {"IN_PER_THREAD": 8}, {"IN_PER_THREAD": 32},
            {"IN_CLUSTERS": (1, 2, 4, 8)}, {"IN_FILL": 8}]


def main():
    if not torch.cuda.is_available():
        raise SystemExit("sweep_torch_instnorm: needs a CUDA card")
    sys.path.insert(0, ROOT)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from skyhdr_torch.ops.kernels import instnorm as tin

    smi = cs.nvidia_smi_line()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    own = {k: getattr(tin, k) for k in ("IN_SHARE", "IN_PER_THREAD", "IN_CLUSTERS", "IN_FILL")}
    gen = torch.Generator(device="cuda").manual_seed(1)
    rows, totals = [], {}
    for dtype in (torch.float32, torch.bfloat16):
        dt = str(dtype)[6:]
        for path, b in (("serving", 32), ("gan", 64)):
            for shape, _ in cs.in_shapes():
                hwc = cs.scaled(shape, 2)
                x, gamma, beta, dy = cs.in_operands(hwc, b, dtype, gen)
                _, mean, rstd = tin.instance_norm_act_k8(x, gamma, beta, alpha=0.1)
                n8 = sum(cs.in_calls(shape, a, path)[0] for a in dict(cs.in_shapes())[shape])
                n9 = sum(cs.in_calls(shape, a, path)[1] for a in dict(cs.in_shapes())[shape])
                for setting in SETTINGS:
                    for k, v in own.items():
                        setattr(tin, k, setting.get(k, v))
                    tin.in_tiling.cache_clear()
                    name = json.dumps(setting)
                    line = f"{dt} {path} b{b} x{[b, *hwc]} {name}:"
                    for kern, calls, tensors, fn in (
                            ("K8", n8, 1, lambda: tin.instance_norm_act_k8(x, gamma, beta,
                                                                           alpha=0.1)),
                            ("K9", n9, 2, lambda: tin.instance_norm_act_bwd_k9(
                                x, dy, gamma, beta, mean, rstd, alpha=0.1))):
                        ms = statistics.median(cs.time_ms(fn, queued=True))
                        bms, _ = cs.in_bound(kern, b, hwc, x.element_size())
                        plan = tin.in_tiling(b, hwc[0] * hwc[1], hwc[2], x.element_size(), sms,
                                             tensors)
                        line += (f" {kern} {ms:.4f} ms ({100 * bms / ms:.1f}% of bound, cluster "
                                 f"{plan.cluster} x {plan.groups} groups, {plan.threads} "
                                 f"threads, {plan.per_thread} a thread)")
                        rows.append({"dtype": dt, "path": path, "shape": [b, *hwc],
                                     "setting": setting, "kernel": kern, "ms": ms,
                                     "bound_ms": bms, "plan": plan._asdict()})
                        key = (dt, path, kern, name)
                        totals[key] = totals.get(key, 0.0) + calls * ms
                    print(line, flush=True)
                del x, gamma, beta, dy, mean, rstd
    for k, v in own.items():
        setattr(tin, k, v)
    tin.in_tiling.cache_clear()
    for (dt, path, kern, name), t in sorted(totals.items()):
        print(f"{dt} {kern} per {'GAN step' if path == 'gan' else 'dispatch'} {name}: "
              f"{t:.4f} ms; on {smi}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "sweep_instnorm.json"), "w") as f:
        json.dump({"device": smi, "rows": rows,
                   "totals": {"/".join(k): v for k, v in totals.items()}}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
