#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (`skyhdr_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:
  1. device   — the card's name and power limit (nvidia-smi); TF32 off for
                every parity phase (cuDNN and matmul).
  2. build    — nvcc builds skyhdr_torch/csrc/*.cu; build seconds.
  3. kernels  — K1 (DA forward) and K2 (DA input gradient) against their
                plain PyTorch versions at every DA layer shape of the
                serving path, b1 and b32, 32x128 and 64x256, f32 and bf16.
  4. golden   — the serving forward on the card against the JAX package's
                outputs stored in tests/fixtures/torch_golden_da_16x64.npz.
  5. serving  — the inference CLI at 64x256 b32 (40 PNGs, 2 dispatches, the
                second padded) and at 32x128 b1 (4 PNGs); every .hdr read
                back finite; launch counts 20 K1 + 4 K2 per DA dispatch; the
                plain-conv config launches none.
  6. timing   — CUDA events, warm-up, median of 20: forward ms/dispatch and
                each kernel against its plain version at the path's shapes.
The line before the last is the nvidia-smi line, the one before it the
kernels' JSON summary; the last line is the run's JSON result. Details go to
chiprun_out/chip_smoke.json.
"""

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
ITERS, WARMUP = 20, 3
# (name, x shape at 32x128 [h, w, c], F, K1 calls per forward, K2 on path)
DA_LAYERS = [
    ("sunlayer2.conv1", (16, 64, 32), 64, 1, True),
    ("sunlayer2.conv2", (16, 64, 64), 64, 1, True),
    ("sunlayer3.conv1", (8, 32, 64), 128, 1, True),
    ("sunlayer3.conv2", (8, 32, 128), 128, 1, True),
    ("res0-5.conv1/conv2", (8, 32, 128), 128, 12, False),
    ("conv3_f/conv3_u", (16, 64, 128), 64, 2, False),
    ("conv2_f/conv2_u", (32, 128, 64), 32, 2, False),
]
K1_PER_DISPATCH = sum(n for _, _, _, n, _ in DA_LAYERS)
K2_PER_DISPATCH = sum(1 for *_, k2 in DA_LAYERS if k2)
TOL = {("K1", torch.float32): 1e-4, ("K2", torch.float32): 5e-4,
       ("K1", torch.bfloat16): 2e-2, ("K2", torch.bfloat16): 2e-2}


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke FAILED: {msg}")


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def scaled(shape, s):
    h, w, c = shape
    return (h * s, w * s, c)


def time_ms(fn, iters=ITERS, warmup=WARMUP):
    """Device times (ms) of `iters` calls, each bracketed by CUDA events."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in pairs]


def paired_ms(kernel_fn, plain_fn):
    """Median ms of a kernel and its plain version, timed in turns
    plain, kernel, kernel, plain."""
    p = time_ms(plain_fn, ITERS // 2)
    k = time_ms(kernel_fn, ITERS // 2) + time_ms(kernel_fn, ITERS // 2)
    p += time_ms(plain_fn, ITERS // 2)
    return statistics.median(k), statistics.median(p)


def rel_err(got, want):
    d = (got.float() - want.float()).abs().max().item()
    return d / max(want.float().abs().max().item(), 1e-30), d


def operands(shape_hwc, b, f, dtype, gen):
    h, w, c = shape_hwc
    dev = "cuda"
    x = torch.randn(b, h, w, c, device=dev, generator=gen).to(dtype)
    lim = (6.0 / (9 * c + f)) ** 0.5
    k = (torch.rand(9 * c, f, device=dev, generator=gen) * 2 - 1) * lim
    bias = torch.randn(f, device=dev, generator=gen) * 0.1
    g = torch.randn(b, h, w, f, device=dev, generator=gen).to(dtype)
    return x, k, bias, g


def phase_kernels(dc, report):
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {}
    for s, res in ((1, "32x128"), (2, "64x256")):
        for b in (1, 32):
            for dtype in (torch.float32, torch.bfloat16):
                for name, shape, f, _, has_k2 in DA_LAYERS:
                    hwc = scaled(shape, s)
                    x, k, bias, g = operands(hwc, b, f, dtype, gen)
                    got = dc.da_conv_forward_k1(x, k, bias)
                    torch.cuda.synchronize()
                    rel, ab = rel_err(got, dc.da_conv_forward_ref(x, k, bias))
                    tol = TOL["K1", dtype]
                    say("kernels", f"K1 {res} b{b} {str(dtype)[6:]} {name} x{[b, *hwc]} "
                        f"F={f}: max rel err {rel:.3e} (max abs {ab:.3e}, tol {tol})")
                    check(got.dtype == dtype and rel <= tol, f"K1 {name} {res} b{b} {dtype}")
                    key = ("K1", res, b, str(dtype))
                    worst[key] = max(worst.get(key, 0.0), ab)
                    if not has_k2:
                        continue
                    # As autograd hands it: g in the output dtype; dx cast to x.dtype.
                    dx = dc.da_conv_dx_k2(g, k, x_shape=x.shape).to(dtype)
                    torch.cuda.synchronize()
                    want = dc.da_conv_dx_ref(g, k, x_shape=x.shape).to(dtype)
                    rel, ab = rel_err(dx, want)
                    tol = TOL["K2", dtype]
                    say("kernels", f"K2 {res} b{b} {str(dtype)[6:]} {name} g{[b, *hwc[:2], f]} "
                        f"-> dx{[b, *hwc]}: max rel err {rel:.3e} (max abs {ab:.3e}, tol {tol})")
                    check(rel <= tol, f"K2 {name} {res} b{b} {dtype}")
                    key = ("K2", res, b, str(dtype))
                    worst[key] = max(worst.get(key, 0.0), ab)
    # The weight gradient (K3) is not ported: asking for it on the card raises.
    x, k, bias, g = operands((8, 32, 16), 1, 8, torch.float32, gen)
    try:
        dc.da_conv(x, k.requires_grad_(), bias).backward(g)
        check(False, "dK on CUDA did not raise")
    except NotImplementedError as e:
        say("kernels", f"dK on CUDA raises NotImplementedError: {e}")
    report["max_abs_err"] = {"/".join(map(str, k)): v for k, v in worst.items()}
    return worst


def build_port(cfg, seed, device="cuda"):
    from skyhdr_torch.train.engine import build_models
    from skyhdr_torch.utils.transplant import init_model_vars, load_model_vars

    gen, sun = build_models(cfg, device)
    gv, sv = init_model_vars(cfg, seed)
    load_model_vars(gen, gv)
    load_model_vars(sun, sv)
    return gen, sun, (gv, sv)


def phase_golden(report):
    from skyhdr_torch.config import Config, DataConfig, ModelConfig
    from skyhdr_torch.train.engine import make_inference_fn
    from skyhdr_torch.utils.transplant import tree_digest

    stored = np.load(os.path.join(ROOT, "tests", "fixtures",
                                  "torch_golden_da_16x64.npz"))
    x = stored["input"]
    cfg = Config(model=ModelConfig(im_height=x.shape[1], im_width=x.shape[2],
                                   use_da_conv=True),
                 data=DataConfig(batch_size=x.shape[0]))
    gen, sun, (gv, sv) = build_port(cfg, int(stored["seed"]))
    digest = tree_digest({"gen": gv, "sun": sv})
    # Summation order may differ across numpy builds: compare to 1e-9.
    check(abs(digest - float(stored["weights_digest"])) <= 1e-9 * digest,
          f"seeded weights differ from the fixture's ({digest} vs "
          f"{float(stored['weights_digest'])}): the numpy stream changed")
    out = make_inference_fn(cfg)(gen, sun, torch.from_numpy(x).cuda())
    got = out["y_final_lin"].cpu().numpy()
    want = stored["y_final_lin"]
    ok = np.allclose(got, want, rtol=1e-3, atol=1e-3)
    bins_got = out["sunpose_pred"].cpu().numpy().reshape(len(x), -1).argmax(-1)
    bins_want = stored["sunpose_pred"].reshape(len(x), -1).argmax(-1)
    err = float(np.abs(got - want).max())
    say("golden", f"16x64 DA b{len(x)} vs JAX: y_final_lin max abs err {err:.3e} "
        f"(rtol 1e-3, atol 1e-3: {'ok' if ok else 'FAIL'}); argmax bins "
        f"{bins_got.tolist()} vs {bins_want.tolist()}")
    check(ok, "golden y_final_lin")
    check(np.array_equal(bins_got, bins_want), "golden argmax bins")
    report["golden_max_abs_err"] = err


def write_pngs(folder, n, h, w, seed):
    from skyhdr_torch.utils.png import write_png

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    os.makedirs(folder, exist_ok=True)
    for i in range(n):
        sky = 0.25 + 0.5 * (1 - yy / h)[..., None] * rng.uniform(0.6, 1.0, 3)
        sy, sx = rng.uniform(0, h / 2), rng.uniform(0, w)
        sun = np.exp(-((yy - sy) ** 2 + (xx - sx) ** 2) / (0.02 * h * h))[..., None]
        img = np.clip(sky + sun + rng.normal(0, 0.02, (h, w, 3)), 0, 1)
        write_png(os.path.join(folder, f"pano{i:03d}.png"),
                  (img * 255).round().astype(np.uint8))


def serve(dc, work, tag, h, w, n, batch):
    from skyhdr_torch.cli import inference
    from skyhdr_torch.utils.io import read_hdr

    indir, outdir = os.path.join(work, tag, "ldr"), os.path.join(work, tag, "hdr")
    write_pngs(indir, n, h, w, seed=n)
    dispatches = -(-n // batch)
    dc.K1_LAUNCHES = dc.K2_LAUNCHES = 0
    t0 = time.perf_counter()
    inference.main(["--indir", indir, "--outdir", outdir, "--da-conv", "true",
                    "--imheight", str(h), "--imwidth", str(w),
                    "--batch", str(batch), "--device", "cuda"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    k1, k2 = dc.K1_LAUNCHES, dc.K2_LAUNCHES
    say("serving", f"CLI {h}x{w} DA b{batch}: {n} images, {dispatches} dispatches, "
        f"{secs:.3f} s wall (weights drawn and loaded included); launches "
        f"K1 {k1}, K2 {k2} (want {K1_PER_DISPATCH * dispatches}, "
        f"{K2_PER_DISPATCH * dispatches})")
    check(k1 == K1_PER_DISPATCH * dispatches and k2 == K2_PER_DISPATCH * dispatches,
          f"launch counts at {tag}")
    for i in range(n):
        hdr = read_hdr(os.path.join(outdir, f"pano{i:03d}.hdr"))
        check(hdr.shape == (h, w, 3) and np.isfinite(hdr).all() and hdr.max() > 0,
              f"{tag} output {i}: shape {hdr.shape}")
    say("serving", f"{n} .hdr files read back: finite, shape ({h}, {w}, 3)")
    return k1, k2


def phase_serving(dc, report):
    from skyhdr_torch.config import Config, ModelConfig
    from skyhdr_torch.train.engine import make_inference_fn

    work = tempfile.mkdtemp(prefix="skyhdr_smoke_")
    # The main path: the CLI at the DA model's full width, 64x256, b32.
    k1, k2 = serve(dc, work, "64x256_b32", 64, 256, 40, 32)
    report["main_path_launches"] = {"K1": k1, "K2": k2}
    serve(dc, work, "32x128_b1", 32, 128, 4, 1)
    # The default plain-conv config has no DA layer: it launches no kernel.
    cfg = Config(model=ModelConfig())
    gen, sun, _ = build_port(cfg, 0)
    before = (dc.K1_LAUNCHES, dc.K2_LAUNCHES)
    x = torch.rand(1, 32, 128, 3, device="cuda")
    y = make_inference_fn(cfg)(gen, sun, x)["y_final_lin"]
    check(bool(torch.isfinite(y).all()), "plain config output not finite")
    check((dc.K1_LAUNCHES, dc.K2_LAUNCHES) == before, "plain config launched a DA kernel")
    say("serving", "plain-conv 32x128 b1 forward: finite, 0 DA kernel launches")
    return k1, k2


def phase_timing(dc, smi, report):
    from skyhdr_torch.config import Config, ModelConfig
    from skyhdr_torch.train.engine import make_inference_fn

    fwd = {}
    for (h, w), batches in (((32, 128), (1, 32)), ((64, 256), (32,))):
        cfg = Config(model=ModelConfig(im_height=h, im_width=w, use_da_conv=True))
        gen, sun, _ = build_port(cfg, 0)
        infer = make_inference_fn(cfg)
        for b in batches:
            x = torch.rand(b, h, w, 3, device="cuda")
            ms = statistics.median(time_ms(lambda: infer(gen, sun, x)))
            fwd[f"{h}x{w}_b{b}"] = ms
            say("timing", f"forward {h}x{w} DA b{b}: {ms:.4f} ms/dispatch "
                f"(median of {ITERS}, CUDA events) on {smi}")
        del gen, sun
        torch.cuda.empty_cache()
    report["forward_ms"] = fwd

    gen_ = torch.Generator(device="cuda").manual_seed(1)
    per_dispatch = {"K1": [0.0, 0.0], "K2": [0.0, 0.0]}
    rows = []
    for s, res in ((1, "32x128"), (2, "64x256")):
        for name, shape, f, calls, has_k2 in DA_LAYERS:
            hwc = scaled(shape, s)
            x, k, bias, g = operands(hwc, 32, f, torch.float32, gen_)
            k1_ms, ref_ms = paired_ms(lambda: dc.da_conv_forward_k1(x, k, bias),
                                      lambda: dc.da_conv_forward_ref(x, k, bias))
            say("timing", f"K1 {res} b32 {name} x{[32, *hwc]} F={f}: kernel "
                f"{k1_ms:.4f} ms, plain {ref_ms:.4f} ms on {smi}")
            rows.append({"kernel": "K1", "res": res, "layer": name, "ms": k1_ms,
                         "plain_ms": ref_ms, "calls": calls})
            if res == "64x256":
                per_dispatch["K1"][0] += calls * k1_ms
                per_dispatch["K1"][1] += calls * ref_ms
            if not has_k2:
                continue
            k2_ms, ref2_ms = paired_ms(lambda: dc.da_conv_dx_k2(g, k, x_shape=x.shape),
                                       lambda: dc.da_conv_dx_ref(g, k, x_shape=x.shape))
            say("timing", f"K2 {res} b32 {name} g{[32, *hwc[:2], f]}: kernel "
                f"{k2_ms:.4f} ms, plain {ref2_ms:.4f} ms on {smi}")
            rows.append({"kernel": "K2", "res": res, "layer": name, "ms": k2_ms,
                         "plain_ms": ref2_ms, "calls": 1})
            if res == "64x256":
                per_dispatch["K2"][0] += k2_ms
                per_dispatch["K2"][1] += ref2_ms
    report["kernel_ms"] = rows
    return per_dispatch


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from skyhdr_torch.ops.kernels import build as kbuild
    from skyhdr_torch.ops.kernels import deform_conv as dc

    report = {}
    smi = nvidia_smi_line()
    say("device", f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} card(s)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    say("device", "TF32 off for cuDNN convolutions and matmuls in every phase")

    t0 = time.perf_counter()
    lib = kbuild.build()
    kbuild.library()
    build_s = time.perf_counter() - t0
    say("build", f"nvcc {' '.join(kbuild.NVCC_FLAGS)}: {build_s:.3f} s -> "
        f"{os.path.relpath(lib, ROOT)}")
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            say("build", line.strip())
    report["build_s"] = build_s

    worst = phase_kernels(dc, report)
    phase_golden(report)
    k1, k2 = phase_serving(dc, report)
    per_dispatch = phase_timing(dc, smi, report)

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    report["device"] = smi
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    src = "skyhdr_torch/csrc/deform_conv.cu"
    kernels = [
        {"name": "K1 da_fwd_k3 (DA conv forward, k=3)", "route": "cuda",
         "source": src, "replaces": "skyhdr/ops/pallas/deform_conv.py:179",
         "launches": k1,
         "max_abs_err": max(worst["K1", "64x256", 32, "torch.float32"],
                            worst["K1", "64x256", 1, "torch.float32"]),
         "ms": per_dispatch["K1"][0], "plain_ms": per_dispatch["K1"][1]},
        {"name": "K2 da_dx_k3 (DA conv input gradient, k=3)", "route": "cuda",
         "source": src, "replaces": "skyhdr/ops/pallas/deform_conv.py:469",
         "launches": k2,
         "max_abs_err": max(worst["K2", "64x256", 32, "torch.float32"],
                            worst["K2", "64x256", 1, "torch.float32"]),
         "ms": per_dispatch["K2"][0], "plain_ms": per_dispatch["K2"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
