#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (`skyhdr_torch`) on one CUDA card.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --only kernels,training   # a subset, for iterating

Phases, each printing its own lines; any failure raises and exits non-zero:
  1. device       — the card's name and power limit (nvidia-smi); TF32 off
                    for every phase (cuDNN and matmul).
  2. build        — nvcc builds skyhdr_torch/csrc/*.cu; build seconds.
  3. kernels      — K1 (DA forward), K2 (DA input gradient) and K3 (DA
                    weight gradient) against their plain PyTorch versions at
                    every DA layer shape: K1/K2 at the serving batches (b1,
                    b32; 32x128 and 64x256; f32 and bf16), K1/K2/K3 at the
                    training batches (64x256 b64 f32 and bf16, 32x128 b32
                    f32); K3 twice on the same inputs gives the same bits.
  4. golden       — the serving forward on the card against the JAX
                    package's outputs in tests/fixtures/torch_golden_da_16x64.npz.
  5. train_golden — one GAN step and one sun step at 16x64 DA b2 on the
                    card from the seeded weights, fed the JAX-degraded inputs
                    of tests/fixtures/torch_golden_train_16x64.npz, against
                    JAX's metrics and per-leaf update / BatchNorm digests.
  6. serving      — the inference CLI at 64x256 b32 (40 PNGs, 2 dispatches,
                    the second padded) and at 32x128 b1 (4 PNGs); every .hdr
                    read back finite; 20 K1 + 4 K2 launches per DA dispatch;
                    the plain-conv config launches none.
  7. training     — the main path: `create_gan_state` + `make_gan_train_step`
                    at DA 64x256 b64 f32 for 3 steps, then the sun-pretrain
                    step at 64x256 b32 for 2; every metric finite, gen_total
                    moving, launch counts per step asserted (GAN: 20 K1,
                    24 K2, 20 K3; sun: 4 each). Then step times (CUDA events,
                    1 warm-up, median of 5 further steps of the same state)
                    and peak device memory.
  8. timing       — CUDA events, warm-up, median of 20: serving forward
                    ms/dispatch, and each kernel against its plain version at
                    the 64x256 shapes (b32 serving, b64 training), with the
                    per-dispatch and per-GAN-step totals and their bounds.
The line before the last is the nvidia-smi line, the one before it the
kernels' JSON summary; the last line is the run's JSON result. Details go to
chiprun_out/chip_smoke.json. The train golden's comparison lives in
tools/make_torch_golden.py (loaded by path; it imports JAX only inside the
functions that compute the JAX side, which this script does not call).
"""

import argparse
import importlib.util
import json
import math
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
STEP_ITERS = 5
PHASES = ("kernels", "golden", "train_golden", "serving", "training", "timing")
# (name, x shape at 32x128 [h, w, c], F, layers of that shape, in the
# sun-pose net: Grad-CAM's pull differentiates through it)
DA_LAYERS = [
    ("sunlayer2.conv1", (16, 64, 32), 64, 1, True),
    ("sunlayer2.conv2", (16, 64, 64), 64, 1, True),
    ("sunlayer3.conv1", (8, 32, 64), 128, 1, True),
    ("sunlayer3.conv2", (8, 32, 128), 128, 1, True),
    ("res0-5.conv1/conv2", (8, 32, 128), 128, 12, False),
    ("conv3_f/conv3_u", (16, 64, 128), 64, 2, False),
    ("conv2_f/conv2_u", (32, 128, 64), 32, 2, False),
]
N_DA = sum(n for *_, n, _ in DA_LAYERS)                # 20
N_SUN = sum(n for *_, n, sun in DA_LAYERS if sun)      # 4
# Launches per serving dispatch and per train step. Serving: K1 on every DA
# layer, K2 in Grad-CAM's pull through the sun-pose DA layers. GAN step: K1
# once per layer, K2 and K3 once per layer in the outer backward, and K2
# again in the pull (which asks only for activations' gradients, so it runs
# no K3). Sun step: the sun-pose layers once each; its CAMs feed nothing.
SERVING_LAUNCHES = {"K1": N_DA, "K2": N_SUN}
GAN_LAUNCHES = {"K1": N_DA, "K2": N_DA + N_SUN, "K3": N_DA}
SUN_LAUNCHES = {"K1": N_SUN, "K2": N_SUN, "K3": N_SUN}
TOL = {("K1", torch.float32): 1e-4, ("K2", torch.float32): 5e-4,
       ("K3", torch.float32): 1e-4,
       ("K1", torch.bfloat16): 2e-2, ("K2", torch.bfloat16): 2e-2,
       ("K3", torch.bfloat16): 1e-4}  # K3 reads bf16 x as f32, as its plain version
# (res scale, batch, dtype, kernels checked)
KERNEL_CASES = [(1, 1, torch.float32, "K1 K2"), (1, 1, torch.bfloat16, "K1 K2"),
                (1, 32, torch.float32, "K1 K2 K3"), (1, 32, torch.bfloat16, "K1 K2"),
                (2, 1, torch.float32, "K1 K2"), (2, 32, torch.float32, "K1 K2"),
                (2, 32, torch.bfloat16, "K1 K2"),
                (2, 64, torch.float32, "K1 K2 K3"), (2, 64, torch.bfloat16, "K1 K2 K3")]
# Published H100 SXM peaks (NVIDIA data sheet): f32 outside the tensor
# cores, and HBM3 bandwidth. A bound is the larger of the two times.
PEAK_F32_FLOPS, PEAK_BYTES_S = 67e12, 3.35e12
# Train golden: the card's f32 cuDNN and GEMM algorithms sum in other orders
# than XLA on the CPU. Metrics to 1e-3 relative; per-leaf update digests to
# 2e-2 of the leaf's sum |update|, because RMSprop's first step maps a
# gradient g to lr*g/sqrt(0.1 g^2 + 1e-7), which multiplies an error in a
# small g (|g| <~ 1e-3) by up to 3162*lr.
GOLDEN_METRIC_RTOL, GOLDEN_UPDATE_RTOL = 1e-3, 2e-2


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


def bound(kernel, b, hwc, f, x_bytes=4):
    """(ms, "bytes" or "operations"): the least time of one call on the
    published peaks. Operations 2*b*h*w*9*c*f (the nine taps' products);
    bytes each input read once and each output written once: K1 x, K, bias
    and out (in x's type); K2 g (f32), K and dx (f32); K3 x, g (f32) and
    dK (f32)."""
    h, w, c = hwc
    n = b * h * w
    flops = 2.0 * n * 9 * c * f
    nbytes = {"K1": n * c * x_bytes + 9 * c * f * x_bytes + 4 * f + n * f * x_bytes,
              "K2": n * f * 4 + 9 * c * f * 4 + n * c * 4,
              "K3": n * c * x_bytes + n * f * 4 + 9 * c * f * 4}[kernel]
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def counts(dc):
    return {"K1": dc.K1_LAUNCHES, "K2": dc.K2_LAUNCHES, "K3": dc.K3_LAUNCHES}


def reset_counts(dc):
    dc.K1_LAUNCHES = dc.K2_LAUNCHES = dc.K3_LAUNCHES = 0


def free_cuda():
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_kernels(dc, report):
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {}
    for s, b, dtype, which in KERNEL_CASES:
        res = "32x128" if s == 1 else "64x256"
        tag = f"{res} b{b} {str(dtype)[6:]}"
        for name, shape, f, _, _ in DA_LAYERS:
            hwc = scaled(shape, s)
            x, k, bias, g = operands(hwc, b, f, dtype, gen)
            results = []
            got = dc.da_conv_forward_k1(x, k, bias)
            torch.cuda.synchronize()
            results.append(("K1", f"x{[b, *hwc]} F={f}", got.dtype == dtype,
                            *rel_err(got, dc.da_conv_forward_ref(x, k, bias))))
            # As autograd hands it: g in the output dtype; dx cast to x.dtype.
            dx = dc.da_conv_dx_k2(g, k, x_shape=x.shape).to(dtype)
            torch.cuda.synchronize()
            results.append(("K2", f"g{[b, *hwc[:2], f]} -> dx{[b, *hwc]}", True,
                            *rel_err(dx, dc.da_conv_dx_ref(g, k, x_shape=x.shape).to(dtype))))
            if "K3" in which:
                dk = dc.da_conv_dk_k3(x, g)
                again = dc.da_conv_dk_k3(x, g)
                torch.cuda.synchronize()
                same = bool(torch.equal(dk, again))
                results.append(("K3", f"x{[b, *hwc]} g[..,{f}] -> dK[{9 * hwc[2]},{f}] "
                                f"(bitwise repeatable: {same})", same,
                                *rel_err(dk, dc.da_conv_dk_ref(x, g))))
                del dk, again
            for kern, what, ok, rel, ab in results:
                tol = TOL[kern, dtype]
                say("kernels", f"{kern} {tag} {name} {what}: max rel err {rel:.3e} "
                    f"(max abs {ab:.3e}, tol {tol})")
                check(ok and rel <= tol, f"{kern} {name} {tag}")
                key = (kern, res, b, str(dtype))
                worst[key] = max(worst.get(key, 0.0), ab)
            del x, k, bias, g, got, dx
        free_cuda()
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


def golden_tool():
    spec = importlib.util.spec_from_file_location(
        "make_torch_golden", os.path.join(ROOT, "tools", "make_torch_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_train_golden(dc, report):
    from skyhdr_torch.utils.transplant import init_gan_vars, tree_digest

    mod = golden_tool()
    stored = np.load(mod.TRAIN_FIXTURE)
    gv, sv, dv = init_gan_vars(mod.golden_config(), int(stored["seed"]))
    digest = tree_digest({"gen": gv, "sun": sv, "disc": dv})
    check(abs(digest - float(stored["weights_digest"])) <= 1e-9 * digest,
          f"seeded GAN weights differ from the fixture's ({digest} vs "
          f"{float(stored['weights_digest'])})")
    before = counts(dc)
    port = mod.port_train_golden(stored, "cuda")
    launched = {k: v - before[k] for k, v in counts(dc).items()}
    fails, worst = mod.compare_train_golden(stored, port, GOLDEN_METRIC_RTOL,
                                            GOLDEN_UPDATE_RTOL)
    for kind in ("gan", "sun"):
        for name, a, b in zip(stored[f"{kind}_metric_names"], port[f"{kind}_metrics"],
                              stored[f"{kind}_metrics"]):
            say("train_golden", f"{kind} {name}: card {a:.7g}, JAX {b:.7g}")
    say("train_golden", f"16x64 DA b2 GAN step + sun step vs JAX: worst relative "
        f"{json.dumps(worst)} (metrics rtol {GOLDEN_METRIC_RTOL}, updates "
        f"{GOLDEN_UPDATE_RTOL} of sum |update|, BN sums 1e-4); launches {launched}")
    for line in fails:
        say("train_golden", f"FAIL {line}")
    check(not fails, f"train golden: {len(fails)} mismatches")
    check(all(launched[k] == GAN_LAUNCHES[k] + SUN_LAUNCHES[k] for k in launched),
          f"train golden launches {launched}")
    report["train_golden_worst"] = worst


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
    reset_counts(dc)
    t0 = time.perf_counter()
    inference.main(["--indir", indir, "--outdir", outdir, "--da-conv", "true",
                    "--imheight", str(h), "--imwidth", str(w),
                    "--batch", str(batch), "--device", "cuda"])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = counts(dc)
    want = {k: v * dispatches for k, v in SERVING_LAUNCHES.items()}
    want["K3"] = 0
    say("serving", f"CLI {h}x{w} DA b{batch}: {n} images, {dispatches} dispatches, "
        f"{secs:.3f} s wall (weights drawn and loaded included); launches {got} "
        f"(want {want})")
    check(got == want, f"launch counts at {tag}")
    for i in range(n):
        hdr = read_hdr(os.path.join(outdir, f"pano{i:03d}.hdr"))
        check(hdr.shape == (h, w, 3) and np.isfinite(hdr).all() and hdr.max() > 0,
              f"{tag} output {i}: shape {hdr.shape}")
    say("serving", f"{n} .hdr files read back: finite, shape ({h}, {w}, 3)")
    return got


def phase_serving(dc, report):
    from skyhdr_torch.config import Config, ModelConfig
    from skyhdr_torch.train.engine import make_inference_fn

    work = tempfile.mkdtemp(prefix="skyhdr_smoke_")
    # The serving path: the CLI at the DA model's full width, 64x256, b32.
    report["serving_launches"] = serve(dc, work, "64x256_b32", 64, 256, 40, 32)
    serve(dc, work, "32x128_b1", 32, 128, 4, 1)
    # The default plain-conv config has no DA layer: it launches no kernel.
    cfg = Config(model=ModelConfig())
    gen, sun, _ = build_port(cfg, 0)
    before = counts(dc)
    x = torch.rand(1, 32, 128, 3, device="cuda")
    y = make_inference_fn(cfg)(gen, sun, x)["y_final_lin"]
    check(bool(torch.isfinite(y).all()), "plain config output not finite")
    check(counts(dc) == before, "plain config launched a DA kernel")
    say("serving", "plain-conv 32x128 b1 forward: finite, 0 DA kernel launches")
    free_cuda()


def train_batches(n, b, h, w, seed):
    """`bench_train_step`'s batches: hdr uniform [0, 2), elevations
    linspace(4, 28, b) (+0.01 per step), made on the card."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    elev = torch.linspace(4, 28, b, device="cuda")
    return [{"hdr": torch.rand(b, h, w, 3, device="cuda", generator=gen) * 2.0,
             "elevation": elev + 0.01 * i} for i in range(n)]


def run_steps(dc, step, state, batches, want, tag, moving=None):
    """Threads `state` through one step per batch; asserts each step's
    launches and finite metrics. Returns (state, per-step metrics, total
    launches); counts are set to 0 just before the first step."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    history = []
    reset_counts(dc)
    for i, batch in enumerate(batches):
        before = counts(dc)
        t0 = time.perf_counter()
        state, metrics = step(state, batch, gen)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = {k: v - before[k] for k, v in counts(dc).items()}
        m = {k: float(v) for k, v in metrics.items()}
        say("training", f"{tag} step {i}: {secs:.3f} s wall; launches {launched}; "
            + ", ".join(f"{k} {v:.6g}" for k, v in sorted(m.items())))
        check(launched == want, f"{tag} step {i} launches {launched}, want {want}")
        check(all(math.isfinite(v) for v in m.values()), f"{tag} step {i} metric not finite")
        history.append(m)
    if moving:
        vals = [m[moving] for m in history]
        check(all(a != b for a, b in zip(vals, vals[1:])), f"{tag} {moving} did not move: {vals}")
    return state, history, counts(dc)


def phase_training(dc, smi, report):
    from skyhdr_torch.config import Config, DataConfig, ModelConfig
    from skyhdr_torch.data.degradation import make_banks
    from skyhdr_torch.models.vgg16 import random_vgg16_weights
    from skyhdr_torch.train.engine import (create_gan_state, create_sun_state,
                                           make_gan_train_step, make_sun_train_step)
    from skyhdr_torch.utils.io import get_exposure_lists, make_synthetic_dorf

    h, w = 64, 256
    banks = make_banks(make_synthetic_dorf(175, 1024), get_exposure_lists()[0], device="cuda")
    out = {}
    for kind, b, nsteps in (("gan", 64, 3), ("sun", 32, 2)):
        cfg = Config(model=ModelConfig(im_height=h, im_width=w, use_da_conv=True),
                     data=DataConfig(batch_size=b))
        tag = f"{kind} DA {h}x{w} b{b}"
        t0 = time.perf_counter()
        if kind == "gan":
            state = create_gan_state(cfg, 0, "cuda")
            step = make_gan_train_step(cfg, banks, random_vgg16_weights())
            want, moving = GAN_LAUNCHES, "gen_total"
        else:
            state = create_sun_state(cfg, 0, "cuda")
            step = make_sun_train_step(cfg, banks)
            want, moving = SUN_LAUNCHES, "sun_total"
        torch.cuda.synchronize()
        say("training", f"{tag}: state created in {time.perf_counter() - t0:.3f} s "
            "(seeded weights drawn on the host and copied)")
        batches = train_batches(nsteps, b, h, w, seed=2000)
        state, history, launched = run_steps(dc, step, state, batches, want, tag, moving)
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device="cuda").manual_seed(2)
        times = time_ms(lambda: step(state, batches[0], gen), iters=STEP_ITERS, warmup=1)
        peak = torch.cuda.max_memory_allocated()
        ms = statistics.median(times)
        say("training", f"{tag}: step {ms:.4f} ms (median of {STEP_ITERS}, CUDA events, "
            f"spread {min(times):.4f}-{max(times):.4f}); peak device memory "
            f"{peak / 2**30:.3f} GiB; on {smi}")
        out[kind] = {"batch": b, "launches": launched, "history": history,
                     "step_ms": ms, "step_ms_all": times, "peak_bytes": peak}
        del state, step, batches
        free_cuda()
    report["training"] = out
    return out["gan"]["launches"]


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
        free_cuda()
    report["forward_ms"] = fwd

    gen_ = torch.Generator(device="cuda").manual_seed(1)
    # Per serving dispatch (64x256 b32) and per GAN step (64x256 b64):
    # [kernel ms, plain ms, bound ms, flop-bound ms, byte-bound ms].
    totals = {(p, k): [0.0] * 5 for p in ("serving", "gan") for k in ("K1", "K2", "K3")}
    rows = []
    for path, b in (("serving", 32), ("gan", 64)):
        for name, shape, f, n, in_sun in DA_LAYERS:
            hwc = scaled(shape, 2)
            x, k, bias, g = operands(hwc, b, f, torch.float32, gen_)
            runs = [("K1", n, lambda: dc.da_conv_forward_k1(x, k, bias),
                     lambda: dc.da_conv_forward_ref(x, k, bias))]
            k2_calls = (n if path == "gan" else 0) + (n if in_sun else 0)
            if k2_calls:
                runs.append(("K2", k2_calls, lambda: dc.da_conv_dx_k2(g, k, x_shape=x.shape),
                             lambda: dc.da_conv_dx_ref(g, k, x_shape=x.shape)))
            if path == "gan":
                runs.append(("K3", n, lambda: dc.da_conv_dk_k3(x, g),
                             lambda: dc.da_conv_dk_ref(x, g)))
            for kern, calls, kfn, pfn in runs:
                ms, plain = paired_ms(kfn, pfn)
                bms, by = bound(kern, b, hwc, f)
                say("timing", f"{kern} 64x256 b{b} {name} x{[b, *hwc]} F={f}: kernel "
                    f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bms:.4f} ms ({by}; "
                    f"{100 * bms / ms:.1f}% of it), x{calls} per "
                    f"{'dispatch' if path == 'serving' else 'GAN step'}; on {smi}")
                rows.append({"kernel": kern, "path": path, "batch": b, "layer": name,
                             "ms": ms, "plain_ms": plain, "bound_ms": bms,
                             "bound_by": by, "calls": calls})
                t = totals[path, kern]
                t[0] += calls * ms
                t[1] += calls * plain
                t[2] += calls * bms
                t[3 if by == "operations" else 4] += calls * bms
            del x, k, bias, g
            free_cuda()
    report["kernel_ms"] = rows
    for (path, kern), t in totals.items():
        if t[0]:
            say("timing", f"{kern} per {'64x256 b32 dispatch' if path == 'serving' else '64x256 b64 GAN step'}: "
                f"kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms, bound {t[2]:.4f} ms")
    report["kernel_totals"] = {f"{p}/{k}": t[:3] for (p, k), t in totals.items() if t[0]}
    return totals


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--only", default=",".join(PHASES),
                   help="comma-separated phases to run (device and build always run)")
    args = p.parse_args(argv)
    phases = set(args.only.split(","))
    check(phases <= set(PHASES), f"unknown phases {sorted(phases - set(PHASES))}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from skyhdr_torch.ops.kernels import build as kbuild
    from skyhdr_torch.ops.kernels import deform_conv as dc

    t_start = time.perf_counter()
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
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say("build", line.strip())
    report["build_s"] = build_s

    def timed(name, fn, *a):
        if name not in phases:
            return None
        t = time.perf_counter()
        r = fn(*a)
        say(name, f"phase done in {time.perf_counter() - t:.1f} s")
        return r

    worst = timed("kernels", phase_kernels, dc, report)
    timed("golden", phase_golden, report)
    timed("train_golden", phase_train_golden, dc, report)
    timed("serving", phase_serving, dc, report)
    launches = timed("training", phase_training, dc, smi, report)
    totals = timed("timing", phase_timing, dc, smi, report)

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    report["device"] = smi
    report["wall_s"] = time.perf_counter() - t_start
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    say("done", f"{report['wall_s']:.1f} s wall")
    if phases != set(PHASES):
        return 0  # a subset proves nothing of the whole: no result line

    src = "skyhdr_torch/csrc/deform_conv.cu"
    replaces = {"K1": "skyhdr/ops/pallas/deform_conv.py:179",
                "K2": "skyhdr/ops/pallas/deform_conv.py:469",
                "K3": "skyhdr/ops/pallas/deform_conv.py:429"}
    names = {"K1": "K1 da_fwd_k3 (DA conv forward, k=3)",
             "K2": "K2 da_dx_k3 (DA conv input gradient, k=3)",
             "K3": "K3 da_dk_k3 (DA conv weight gradient, k=3)"}
    kernels = []
    for kern in ("K1", "K2", "K3"):
        ms, plain, bms, t_ops, t_bytes = totals["gan", kern]
        kernels.append({
            "name": names[kern], "route": "cuda", "source": src, "replaces": replaces[kern],
            "launches": launches[kern],
            "max_abs_err": max(v for (k, res, _, dt), v in worst.items()
                               if k == kern and res == "64x256" and dt == "torch.float32"),
            "ms": ms, "plain_ms": plain, "bound_ms": bms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None,
            "per": "one GAN train step at DA 64x256 b64 f32 (launches: the 3 steps "
                   "of the training phase)",
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
