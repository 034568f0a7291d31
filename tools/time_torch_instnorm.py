"""K8/K9 (the port's fused InstanceNorm kernels) timed on the card, for one
checkout of the port, so that two trees can be compared in one run:

    python tools/time_torch_instnorm.py                    # this checkout
    python tools/time_torch_instnorm.py --root .parent --tag parent

It imports `skyhdr_torch` from `--root` (built there at first use) and
times it with `chip_smoke.in_timing` of the checkout this script lies in:
at every InstanceNorm shape and slope at 64x256, per serving dispatch (b32)
and per GAN step (b64), f32 and bf16, device ms with work queued ahead,
the plain version and the library yardstick, the wrapper's host
microseconds per call and the bound. Prints one line per call shape and
the totals, and writes them to chiprun_out/time_instnorm_<tag>.json.
Needs a CUDA card; imports no JAX.
"""

import argparse
import importlib.util
import json
import os
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", default=HERE, help="checkout whose skyhdr_torch is timed")
    p.add_argument("--tag", default="this", help="name of the output file's run")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_torch_instnorm: needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.root))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import skyhdr_torch

    check = os.path.dirname(os.path.dirname(os.path.abspath(skyhdr_torch.__file__)))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    cs.say("time_instnorm", f"{args.tag}: skyhdr_torch from {check}; {smi}")
    rows, totals = cs.in_timing(smi, torch.Generator(device="cuda").manual_seed(1))
    out = {"tag": args.tag, "device": smi, "rows": rows,
           "totals": {f"{p}/{k}/{dt}": t for (p, k, dt), t in totals.items()}}
    for key, t in out["totals"].items():
        cs.say("time_instnorm", f"{args.tag} {key}: kernel {t[0]:.4f} ms, plain {t[1]:.4f} "
               f"ms, bound {t[2]:.4f} ms, library {t[5]:.4f} ms")
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", f"time_instnorm_{args.tag}.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
