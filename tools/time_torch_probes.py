"""K10 (the DA-forward probe kernels) timed on the card, for one checkout
of the port, so that two trees can be compared in one run:

    python tools/time_torch_probes.py                    # this checkout
    python tools/time_torch_probes.py --root .parent --tag parent

It imports `skyhdr_torch` from `--root` (built there at first use) and
times it with `chip_smoke.k10_timing` of the checkout this script lies in:
every K10 instantiation at both probe shapes (x 32x64x256x64 -> F 64 and
32x16x64x128 -> 128) at rblk 2, the default run's other calls (a4, a8 and
b4, the bf16 nine-tap tile at rblk 4) and K1, each in device ms with work
queued ahead (median of 20), beside its bound. Prints one line per call
and the default run's total, and writes them to
chiprun_out/time_probes_<tag>.json. Needs a CUDA card; imports no JAX.
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
        raise SystemExit("time_torch_probes: needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.root))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import skyhdr_torch
    from skyhdr_torch.ops.kernels import deform_conv as dc
    from skyhdr_torch.ops.kernels import probes as tp

    check = os.path.dirname(os.path.dirname(os.path.abspath(skyhdr_torch.__file__)))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    cs.say("time_probes", f"{args.tag}: skyhdr_torch from {check}; {smi}")
    rows, k1 = cs.k10_timing(dc, tp, smi, plain=False)
    tag = cs.PROBE_SHAPES[0][0]
    run = {f"{name}{rblk}": rows[tag, name, rblk]["ms"] for name, rblk in cs.K10_DEFAULT_RUN}
    total = sum(run.values())
    bound = sum(rows[tag, name, rblk]["bound_ms"] for name, rblk in cs.K10_DEFAULT_RUN)
    cs.say("time_probes", f"{args.tag} default run (a2 + a4 + a8 + b4): {total:.4f} ms {run}, "
           f"bound {bound:.4f} ms; on {smi}")
    out = {"tag": args.tag, "device": smi, "k1_ms": k1, "default_run_ms": total,
           "default_run": run, "default_run_bound_ms": bound,
           "rows": [dict(r, key=f"{t}/{n}/{rb}") for (t, n, rb), r in rows.items()]}
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", f"time_probes_{args.tag}.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
