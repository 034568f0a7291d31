"""K10's launch plans swept on the card: every plan the kernel takes
(`probes.staged_candidates`; the direct variants' warps per row) for each
K10 instantiation at both probe shapes (rblk 2; the default run's b4, the
bf16 nine-tap tile, also at rblk 4), in device ms with work queued ahead
(median of 10), beside the plan `probe_tiling` picks. It is how the plan's
rules were chosen, and re-measures them:

    python tools/sweep_torch_probes.py [--probes c,cs_bf16] [--shapes default]

Prints the fastest plans and the picked one per call, and writes every
timing to chiprun_out/sweep_probes.json. Needs a CUDA card; imports no JAX.
"""

import argparse
import importlib.util
import json
import os
import statistics
import sys

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = ("tw", "fb", "cc", "ks", "ch", "wpr", "threads", "smem")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--probes", default="", help="comma-separated K10 names (default: all)")
    p.add_argument("--shapes", default="", help="'default', 'trunk' or both (default)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("sweep_torch_probes: needs a CUDA card")
    sys.path.insert(0, HERE)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from skyhdr_torch.ops.kernels import probes as tp

    smi = cs.nvidia_smi_line()
    names = [n for n in args.probes.split(",") if n] or list(tp.PROBES)
    out = []
    for tag, shape, f in cs.PROBE_SHAPES:
        if args.shapes and not tag.startswith(tuple(args.shapes.split(","))):
            continue
        b, h, w, c = shape
        x, k = cs.probe_operands(shape, f)
        for name in names:
            pr = tp.PROBES[name]
            xs = x.to(pr.store)
            for rblk in (2, 4) if (name, tag) == ("cs_bf16", cs.PROBE_SHAPES[0][0]) else (2,):
                mblk = rblk if pr.dedup else 1
                span = tp.dedup_span(h, w) if pr.dedup else 0
                picked = tp.k10_launch_tiling(name, b, h, w, c, f, rblk, mblk, 0)[0].plan
                if pr.gather == "direct":
                    plans = [pl for pl, _ in tp._direct_plans(pr, h, w, c, f, rblk)]
                else:
                    plans = list(tp.staged_candidates(pr, w, c, f, rblk, mblk, span))
                rows = []
                for plan in plans:
                    ms = statistics.median(cs.time_ms(
                        lambda: tp.da_probe_k10(xs, k, name, rblk=rblk, mblk=mblk, plan=plan),
                        iters=10, queued=True))
                    rows.append({"probe": name, "shape": tag, "rblk": rblk, "ms": ms,
                                 "picked": plan == picked,
                                 **{key: plan[key] for key in KEYS if key in plan}})
                out += rows
                rows.sort(key=lambda r: r["ms"])
                pick = next(r for r in rows if r["picked"])
                best = " | ".join(f"{r['ms']:.4f} " + ",".join(f"{kk}={r[kk]}" for kk in KEYS
                                                               if kk in r) for r in rows[:3])
                cs.say("sweep", f"{name} rblk={rblk} {tag}: {len(rows)} plans; picked "
                       f"{pick['ms']:.4f} ms (rank {rows.index(pick) + 1}); best {best}")
            del xs
        del x, k
        cs.free_cuda()
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "sweep_probes.json"), "w") as fh:
        json.dump({"device": smi, "rows": out}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
