#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (`skyhdr_torch`) on one CUDA card.

    python3 chip_smoke.py                  # every phase
    python3 chip_smoke.py --only kernels,training   # a subset, for iterating

Phases, each printing its own lines; any failure raises and exits non-zero:
  1. device       — the card's name and power limit (nvidia-smi); TF32 off
                    for every phase (cuDNN and matmul).
  2. build        — nvcc builds skyhdr_torch/csrc/*.cu, one process per
                    source, all started together; build seconds, and each
                    source's own compile seconds.
  3. kernels      — K1 (DA forward), K2 (DA input gradient) and K3 (DA
                    weight gradient) against their plain PyTorch versions at
                    every DA layer shape: K1/K2 at the serving batches (b1,
                    b32; 32x128 and 64x256; f32 and bf16), K1/K2/K3 at the
                    training batches (64x256 b64 f32 and bf16, 32x128 b32
                    f32); K1, K2 and K3 twice on the same inputs give the
                    same bits. K1/K2/K3 also at an odd height (32x9x32x128). K5
                    (odd-k DA forward), K7 (its input gradient) and K6 (its
                    weight gradient) at the k=5 trunk (K5/K7 at 64x256 b32
                    f32 and bf16 and 32x128 b1, all three at 64x256 b64 f32
                    and bf16), K5/K7 at the odd height, and all three at
                    every k=7 layer shape (trunk, sunlayer1 conv1 with C=3
                    and conv2) at 64x256 b32 f32; K5, K6 and K7 twice give
                    the same bits.
                    K8 (InstanceNorm + activation forward) and K9 (its
                    backward) at every InstanceNorm shape with each slope
                    its layers use, at 64x256 b64 f32, 64x256 b32 f32 and
                    bf16, and 32x128 b1; K8 and K9 twice give the same
                    bits; under torch.profiler each K8 and each K9 call
                    runs one device kernel (every shape at 64x256 b64, f32
                    and bf16).
  4. golden       — the serving forward on the card against the JAX
                    package's outputs in tests/fixtures/torch_golden_da_16x64.npz,
                    unfused and with fused_instance_norm (the same function),
                    and at da_kernel_size=5 against torch_golden_da5_16x64.npz.
  5. train_golden — one GAN step and one sun step at 16x64 DA b2 on the
                    card from the seeded weights, fed the JAX-degraded inputs
                    of tests/fixtures/torch_golden_train_16x64.npz, against
                    JAX's metrics and per-leaf update / BatchNorm digests;
                    unfused, then fused; then at da_kernel_size=5 against
                    torch_golden_train_da5_16x64.npz.
  6. serving      — the inference CLI at 64x256 b32 (40 PNGs, 2 dispatches,
                    the second padded) and at 32x128 b1 (4 PNGs); every .hdr
                    read back finite; 20 K1 + 4 K2 launches per DA dispatch;
                    the plain-conv config launches none; `make_inference_fn`
                    at da_kernel_size=5, 64x256 b32, two dispatches, 12 K5
                    launches each and no other DA kernel, outputs finite.
  7. training     — the main paths: `make_gan_train_step` at DA 64x256 b64
                    f32 for 3 steps, unfused and then with fused InstanceNorm
                    (both states filled from one draw of the seeded weights),
                    then at da_kernel_size=5 (its weights drawn once for
                    serving, training and timing), then the sun-pretrain step
                    at 64x256 b32 for 2, unfused and then with fused
                    InstanceNorm (the same weights); every metric finite,
                    gen_total moving, launch counts per step asserted (GAN:
                    20 K1, 24 K2, 20 K3, and fused 25 K8, 29 K9; k=5: 12 K5,
                    12 K6, 12 K7 and no K1-K3; sun: 4 each, and fused 6 K8,
                    6 K9). Then step times (CUDA
                    events, 1 warm-up, median of 5 further steps of the same
                    state) and peak device memory.
  8. timing       — CUDA events, warm-up, median of 20: serving forward
                    ms/dispatch (unfused and fused IN, in turns, the same
                    weights; and at da_kernel_size=5), and each kernel
                    against its plain version at the 64x256 shapes (b32
                    serving, b64 training; K5-K7 at the k=5 trunk, and per
                    call at the k=7 shapes at b32), with the per-dispatch
                    and per-GAN-step totals and their bounds; K2/K7 also at
                    each strip height they can pick (R = 8, 4, 2), beside
                    the one picked and its products over the forward's;
                    K1/K5 with the output rows and register tile picked;
                    K3/K6 with their splits, blocks and threads (per layer
                    and per step, and the k=7 shapes with C=3);
                    K8/K9 in f32 and bf16, with device work queued ahead
                    (the events bracket device time, not the wrappers'),
                    also against the library's `F.instance_norm` (forward,
                    and its autograd backward), with each wrapper's host
                    microseconds per call and the plan `in_tiling` picked.
  9. train_cli    — the training CLI (`skyhdr_torch.cli.train`) at DA
                    32x128 b32 on a TFRecord dataset this phase writes (128
                    train, 32 test synthetic skies): 2 epochs with a
                    checkpoint each and TensorBoard scalars read back, a
                    rerun to 3 epochs that resumes at epoch 2 and runs one,
                    and in a fresh work directory a SUN checkpoint from
                    `TrainLoop("SUN", ...)` handed to a fresh SKY run.
  10. cli        — the port's other CLIs on the card, through their
                    `main(argv)`: dataset_generator on a synthetic Laval
                    tree of .hdr envmaps (64 train + 32 test records at
                    32x128, each finite); train_sun --train true at DA
                    32x128 b32 (2 epochs, a checkpoint each, sun_total
                    moving; 4 K1, K2, K3 per step, 4 K1 + 4 K2 per eval
                    batch) and --train false on four .hdr files from that
                    checkpoint (CAM-gated predictions finite); evaluate on
                    the synthetic split at DA 64x256 b32 (2 batches, 20 K1 +
                    4 K2 per dispatch, the same JSON twice for one seed) and
                    plain 32x128 b32 (no DA kernel); convert_real_eval of
                    five pairs, then evaluate --real-dir at b2 (padded) and
                    b1, the padding held against the same grouping unpadded.
                    matplotlib's figures are drawn where it imports, their
                    inputs recorded and checked either way. Then one eval
                    step's degradation, forward and metrics timed (CUDA
                    events, median of 20) at DA 64x256 b32 and plain 32x128
                    b32, and each CLI's wall seconds.
  11. convert    — checkpoints of the JAX package on the card. (a) The
                    resume golden at 16x64 DA b2: the export of
                    `make_torch_golden.resume_export` (seeded weights,
                    BatchNorm statistics and moments drawn nonzero, a
                    nonzero step, epoch and Adam count; its digest against
                    tests/fixtures/torch_golden_resume_16x64.npz) imported
                    by `skyhdr_torch.cli.import_checkpoint`, then one GAN
                    step and one sun step on the fixture's JAX-degraded
                    inputs against JAX's metrics and update digests. (b) DA
                    64x256: a GanState (6.5 GB) and a SunState (9.7 GB)
                    with every tensor drawn on the card, written by
                    `export_from_state` + `write_export` and imported by the
                    CLI, one at a time; every tensor and counter read back
                    bit-equal; the inference CLI (40 PNGs, b32) from the
                    imports bit-equal to serving the source modules, 20 K1 +
                    4 K2 per dispatch; one resumed GAN step at b64 from the
                    import and from the source bit-equal under torch's
                    deterministic algorithms (and, for the record, how far
                    apart in the default mode); a SKY checkpoint with
                    bfloat16 parameters served bit-equal to its source
                    modules and refused a resume (NotImplementedError).
                    Export, import and read-back seconds and GB/s.
  12. probes     — the DA-conv probe tools (skyhdr_torch/tools/) and their
                    kernels, at the tools' default shape x (32,64,256,64) ->
                    F 64 and at the serving trunk layer (32,16,64,128) ->
                    128: every K10 instantiation against its plain version
                    (f32 FMA and bf16 storage 1e-4, tensor cores 2e-3 of
                    the max) and, the whole forward, against the f32 DA
                    conv (1e-4 f32, 2e-2 with bf16); K11 bitwise; K12 at
                    every exp_mmshape configuration in f32 and bf16 and at
                    three shapes it pads, with one dot (1e-5);
                    each K10 instantiation one device kernel a call under
                    torch.profiler; then the main path: exp_daconv (every
                    instantiation through its variant names), exp_pack and
                    exp_mmshape through their entry points, launches read
                    after; then times (CUDA events, median of 20, in turns
                    with the plain version; K10 beside K1, K11 and K12
                    beside their library yardsticks; K10, K1 and K12, their
                    plain versions and the library with device work queued
                    ahead, so that the events bracket device time, not the
                    wrapper's host time; K10's default run also without).
The line before the last is the nvidia-smi line, the one before it the
kernels' JSON summary; the last line is the run's JSON result. Details go to
chiprun_out/chip_smoke.json, the phases' lines to chiprun_out/chip_smoke.log. The train golden's comparison lives in
tools/make_torch_golden.py (loaded by path; it imports JAX only inside the
functions that compute the JAX side, which this script does not call).
"""

import argparse
import functools
import importlib.util
import json
import math
import os
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
ITERS, WARMUP = 20, 3
STEP_ITERS = 5
PHASES = ("kernels", "golden", "train_golden", "serving", "training", "timing",
          "train_cli", "cli", "convert", "probes")
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
# With da_kernel_size=5 only the residual trunk's 12 convs are DA convs
# (5x5); the resize-deconvs (k=3) and the sun-pose net (7/3/3) stay plain.
DA5_LAYERS = [("res0-5.conv1/conv2 k=5", (8, 32, 128), 128, 12, False)]
N_DA5 = 12
# The DA layer shapes of da_kernel_size=7 (checked against the plain
# versions, not driven): the trunk and the sun-pose net's first stage, whose
# first conv takes the 3-channel input. (name, x shape at 32x128, F)
DA7_LAYERS = [("res0-5.conv1/conv2 k=7", (8, 32, 128), 128),
              ("sunlayer1.conv1 k=7", (32, 128, 3), 32),
              ("sunlayer1.conv2 k=7", (32, 128, 32), 32)]
KERNELS = ("K1", "K2", "K3", "K5", "K6", "K7", "K8", "K9")


def launches(**n):
    return {k: n.get(k, 0) for k in KERNELS}


# Launches per serving dispatch and per train step. Serving: K1 on every DA
# layer, K2 in Grad-CAM's pull through the sun-pose DA layers. GAN step: K1
# once per layer, K2 and K3 once per layer in the outer backward, and K2
# again in the pull (which asks only for activations' gradients, so it runs
# no K3). Sun step: the sun-pose layers once each; its CAMs feed nothing.
# At da_kernel_size=5: K5 per trunk conv, and K7 and K6 once each in the
# outer backward; the pull crosses no DA layer, and the sun step has none.
SERVING_LAUNCHES = launches(K1=N_DA, K2=N_SUN)
GAN_LAUNCHES = launches(K1=N_DA, K2=N_DA + N_SUN, K3=N_DA)
SUN_LAUNCHES = launches(K1=N_SUN, K2=N_SUN, K3=N_SUN)
# A sun-pose forward with its Grad-CAM maps (the sun eval step, one image of
# train_sun --train false): the forward, and the pull.
SUN_EVAL_LAUNCHES = launches(K1=N_SUN, K2=N_SUN)
DA5_SERVING_LAUNCHES = launches(K5=N_DA5)
DA5_GAN_LAUNCHES = launches(K5=N_DA5, K6=N_DA5, K7=N_DA5)
# InstanceNorm layers: (name, x shape at 32x128 [h, w, c], slope, layers,
# where in the sun-pose net: "sun" or "pull" when Grad-CAM's pull
# differentiates through them, None in the generator).
IN_LAYERS = [
    ("norm1_d/norm2_f/norm2_u", (32, 128, 32), 0.1, 3, None),
    ("sunlayer1.norm1/norm2", (32, 128, 32), 0.0, 2, "sun"),
    ("norm2_d/norm3_f/norm3_u", (16, 64, 64), 0.1, 3, None),
    ("sunlayer2.norm1/norm2", (16, 64, 64), 0.0, 2, "pull"),
    ("norm3_d/res0-5.norm1", (8, 32, 128), 0.1, 7, None),
    ("res0-5.norm2", (8, 32, 128), 1.0, 6, None),
    ("sunlayer3.norm1/norm2", (8, 32, 128), 0.0, 2, "pull"),
]
N_IN = sum(n for *_, n, _ in IN_LAYERS)                       # 25
N_IN_SUN = sum(n for *_, n, where in IN_LAYERS if where)      # 6
N_IN_PULL = sum(n for *_, n, where in IN_LAYERS if where == "pull")  # 4
# With fused_instance_norm: K8 once per layer; K9 once per layer in the
# outer backward and again in the pull (sunlayer2/3, 4 layers).
FUSED_IN = {"serving": {"K8": N_IN, "K9": N_IN_PULL},
            "gan": {"K8": N_IN, "K9": N_IN + N_IN_PULL},
            "sun": {"K8": N_IN_SUN, "K9": N_IN_SUN}}


def fused(launches, path):
    return dict(launches, **FUSED_IN[path])

TOL = {("K1", torch.float32): 1e-4, ("K2", torch.float32): 5e-4,
       ("K3", torch.float32): 1e-4,
       ("K1", torch.bfloat16): 2e-2, ("K2", torch.bfloat16): 2e-2,
       ("K3", torch.bfloat16): 1e-4,  # K3 reads bf16 x as f32, as its plain version
       ("K5", torch.float32): 1e-4, ("K7", torch.float32): 5e-4,
       ("K6", torch.float32): 1e-4,
       ("K5", torch.bfloat16): 2e-2, ("K7", torch.bfloat16): 2e-2,
       ("K6", torch.bfloat16): 1e-4,  # as K3
       # K8/K9: the same formula summed in another order (f32); bf16 output
       # rounding (one bf16 ulp is 2^-8 of the value).
       ("K8", torch.float32): 1e-5, ("K9", torch.float32): 1e-5,
       ("K8", torch.bfloat16): 2e-2, ("K9", torch.bfloat16): 2e-2}
# (res scale, batch, dtype) of the K8/K9 checks
IN_KERNEL_CASES = [(2, 64, torch.float32), (2, 32, torch.float32),
                   (2, 32, torch.bfloat16), (1, 1, torch.float32)]
# (kernel size, layers [(name, x shape at 32x128, F)], res scale, batch,
# dtype, kernels checked). K1/K2 at every k=3 layer at the serving batches,
# K3 at the training batches; K5/K7 at the k=5 trunk at the serving batches,
# K6 at the training batch; K5/K6/K7 at every k=7 layer shape; and K1-K3 and
# K5/K7 at an odd height (9 rows), which they serve with the same tables.
# The forward (K1/K5) and the input gradient (K2/K7) run in every case,
# twice (bitwise repeatable).
K3_SHAPES = [(name, shape, f) for name, shape, f, _, _ in DA_LAYERS]
K5_SHAPES = [(name, shape, f) for name, shape, f, _, _ in DA5_LAYERS]
KERNEL_CASES = [(3, K3_SHAPES, 1, 1, torch.float32, "K1 K2"),
                (3, K3_SHAPES, 1, 1, torch.bfloat16, "K1 K2"),
                (3, K3_SHAPES, 1, 32, torch.float32, "K1 K2 K3"),
                (3, K3_SHAPES, 1, 32, torch.bfloat16, "K1 K2"),
                (3, K3_SHAPES, 2, 1, torch.float32, "K1 K2"),
                (3, K3_SHAPES, 2, 32, torch.float32, "K1 K2"),
                (3, K3_SHAPES, 2, 32, torch.bfloat16, "K1 K2"),
                (3, K3_SHAPES, 2, 64, torch.float32, "K1 K2 K3"),
                (3, K3_SHAPES, 2, 64, torch.bfloat16, "K1 K2 K3"),
                (3, [("odd height", (9, 32, 128), 128)], 1, 32, torch.float32, "K1 K2 K3"),
                (5, [("odd height", (9, 32, 128), 128)], 1, 32, torch.float32, "K5 K7"),
                (5, K5_SHAPES, 1, 1, torch.float32, "K5 K7"),
                (5, K5_SHAPES, 2, 32, torch.float32, "K5 K7"),
                (5, K5_SHAPES, 2, 32, torch.bfloat16, "K5 K7"),
                (5, K5_SHAPES, 2, 64, torch.float32, "K5 K6 K7"),
                (5, K5_SHAPES, 2, 64, torch.bfloat16, "K5 K6 K7"),
                (7, DA7_LAYERS, 2, 32, torch.float32, "K5 K6 K7")]
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


LOG = []  # every line `say` prints, written to chiprun_out/chip_smoke.log


def say(phase, msg):
    line = f"[{phase}] {msg}"
    LOG.append(line)
    print(line, flush=True)


def nvidia_smi_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def scaled(shape, s):
    h, w, c = shape
    return (h * s, w * s, c)


def time_ms(fn, iters=ITERS, warmup=WARMUP, queued=False):
    """Device times (ms) of `iters` calls, each bracketed by CUDA events.
    `queued`: a ~10 ms device sleep is enqueued first, so the host enqueues
    every call while the card is busy and each pair of events brackets the
    call's device work alone, not the host's time between calls (for
    kernels shorter than their wrapper's host time)."""
    for _ in range(warmup):
        fn()
    if queued:
        torch.cuda._sleep(20_000_000)
    pairs = []
    for _ in range(iters):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in pairs]


def paired_ms(kernel_fn, plain_fn, queued=False):
    """Median ms of a kernel and its plain version, timed in turns
    plain, kernel, kernel, plain."""
    p = time_ms(plain_fn, ITERS // 2, queued=queued)
    k = (time_ms(kernel_fn, ITERS // 2, queued=queued)
         + time_ms(kernel_fn, ITERS // 2, queued=queued))
    p += time_ms(plain_fn, ITERS // 2, queued=queued)
    return statistics.median(k), statistics.median(p)


def rel_err(got, want):
    d = (got.float() - want.float()).abs().max().item()
    return d / max(want.float().abs().max().item(), 1e-30), d


def operands(shape_hwc, b, f, dtype, gen, ksize=3):
    h, w, c = shape_hwc
    dev = "cuda"
    x = torch.randn(b, h, w, c, device=dev, generator=gen).to(dtype)
    lim = (6.0 / (ksize * ksize * c + f)) ** 0.5
    k = (torch.rand(ksize * ksize * c, f, device=dev, generator=gen) * 2 - 1) * lim
    bias = torch.randn(f, device=dev, generator=gen) * 0.1
    g = torch.randn(b, h, w, f, device=dev, generator=gen).to(dtype)
    return x, k, bias, g


def bound(kernel, b, hwc, f, x_bytes=4, ksize=3):
    """(ms, "bytes" or "operations"): the least time of one call on the
    published peaks. Operations 2*b*h*w*k*k*c*f (the k*k taps' products;
    the input gradients K2/K7 counted at the forward's); bytes each input
    read once and each output written once: K1/K5 x, K, bias and out (in
    x's type); K2/K7 g (f32), K and dx (f32); K3/K6 x, g (f32) and dK
    (f32)."""
    h, w, c = hwc
    n = b * h * w
    taps = ksize * ksize
    flops = 2.0 * n * taps * c * f
    nbytes = {"fwd": n * c * x_bytes + taps * c * f * x_bytes + 4 * f + n * f * x_bytes,
              "dx": n * f * 4 + taps * c * f * 4 + n * c * 4,
              "dk": n * c * x_bytes + n * f * 4 + taps * c * f * 4}[ROLE[kernel]]
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def in_bound(kernel, b, hwc, x_bytes=4):
    """(ms, "bytes" or "operations") of one K8 / K9 call on the published
    peaks. Bytes: K8 reads x and writes y (x's type), plus gamma, beta
    (f32 [c]) and writes mean, rstd (f32 [b, c]); K9 reads x, dy, gamma,
    beta, mean, rstd and writes dx, dgamma, dbeta. Operations: 10 per
    element for K8 (moments 5, normalise 4, slope 1), 16 for K9."""
    h, w, c = hwc
    n = b * h * w * c
    if kernel == "K8":
        nbytes, ops = 2 * n * x_bytes + 2 * c * 4 + 2 * b * c * 4, 10.0 * n
    else:
        nbytes, ops = 3 * n * x_bytes + 4 * c * 4 + 2 * b * c * 4, 16.0 * n
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def in_shapes():
    """[(x shape at 32x128, [slopes its layers use])], in IN_LAYERS order."""
    out = {}
    for _, shape, alpha, _, _ in IN_LAYERS:
        if alpha not in out.setdefault(shape, []):
            out[shape].append(alpha)
    return list(out.items())


def in_calls(shape, alpha, path):
    """K8 and K9 calls at one (shape, slope) per serving dispatch or per
    GAN step."""
    n = sum(k for _, sh, a, k, _ in IN_LAYERS if (sh, a) == (shape, alpha))
    pull = sum(k for _, sh, a, k, where in IN_LAYERS
               if (sh, a) == (shape, alpha) and where == "pull")
    return n, pull + (n if path == "gan" else 0)


def in_operands(hwc, b, dtype, gen):
    h, w, c = hwc
    x = (torch.randn(b, h, w, c, device="cuda", generator=gen) * 2 + 0.3).to(dtype)
    gamma = torch.rand(c, device="cuda", generator=gen) + 0.5
    beta = torch.randn(c, device="cuda", generator=gen) * 0.1
    dy = torch.randn(b, h, w, c, device="cuda", generator=gen).to(dtype)
    return x, gamma, beta, dy


def counts(dc):
    from skyhdr_torch.ops.kernels import instnorm as tin

    return {k: getattr(tin if k in ("K8", "K9") else dc, f"{k}_LAUNCHES") for k in KERNELS}


def reset_counts(dc):
    from skyhdr_torch.ops.kernels import instnorm as tin

    for k in KERNELS:
        setattr(tin if k in ("K8", "K9") else dc, f"{k}_LAUNCHES", 0)


# What each DA kernel computes: the forward, the input gradient or the
# weight gradient.
ROLE = {"K1": "fwd", "K2": "dx", "K3": "dk", "K5": "fwd", "K7": "dx", "K6": "dk"}


def da_calls(dc, ksize, x, kern, bias, g):
    """{role: (kernel name, kernel call, plain call)} of the DA kernels at
    kernel size k on these operands: K1/K2/K3 at k=3, K5/K7/K6 otherwise.
    The input gradient returns float32, as its kernel does."""
    shape = tuple(x.shape)
    if ksize == 3:
        return {"fwd": ("K1", lambda: dc.da_conv_forward_k1(x, kern, bias),
                        lambda: dc.da_conv_forward_ref(x, kern, bias)),
                "dx": ("K2", lambda: dc.da_conv_dx_k2(g, kern, x_shape=shape),
                       lambda: dc.da_conv_dx_ref(g, kern, x_shape=shape)),
                "dk": ("K3", lambda: dc.da_conv_dk_k3(x, g),
                       lambda: dc.da_conv_dk_ref(x, g))}
    kw = dict(kernel_size=ksize)
    return {"fwd": ("K5", lambda: dc.da_conv_forward_k5(x, kern, bias, **kw),
                    lambda: dc.da_conv_forward_ref(x, kern, bias, **kw)),
            "dx": ("K7", lambda: dc.da_conv_dx_k7(g, kern, x_shape=shape, **kw),
                   lambda: dc.da_conv_dx_ref_generic(g, kern, x_shape=shape, **kw)),
            "dk": ("K6", lambda: dc.da_conv_dk_k6(x, g, **kw),
                   lambda: dc.da_conv_dk_ref(x, g, **kw))}


def dx_rows(dc, b, hwc, f):
    """The strip height K2/K7 pick for x [b, *hwc] and F = f."""
    from skyhdr_torch.ops.kernels.build import library

    h, w, c = hwc
    tiles = library().skyhdr_da_dx_tiles(w, -(-c // 4) * 4, -(-f // 4) * 4)
    return dc.dx_strip_rows(b, h, tiles, torch.cuda.get_device_properties(0).multi_processor_count)


def free_cuda():
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def phase_kernels(dc, report):
    from skyhdr_torch.ops.kernels import instnorm as tin

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = {}
    for ksize, layers, s, b, dtype, which in KERNEL_CASES:
        res = "32x128" if s == 1 else "64x256"
        tag = f"{res} b{b} {str(dtype)[6:]} k={ksize}"
        for name, shape, f in layers:
            hwc = scaled(shape, s)
            x, k, bias, g = operands(hwc, b, f, dtype, gen, ksize)
            calls = da_calls(dc, ksize, x, k, bias, g)
            results = []
            kern, run, plain = calls["fwd"]
            got, again = run(), run()
            torch.cuda.synchronize()
            same = bool(torch.equal(got, again))
            results.append((kern, f"x{[b, *hwc]} F={f} (bitwise repeatable: {same})",
                            got.dtype == dtype and same, *rel_err(got, plain())))
            del got, again
            # As autograd hands it: g in the output dtype; dx cast to x.dtype.
            kern, run, plain = calls["dx"]
            dx, again = run(), run()
            torch.cuda.synchronize()
            same = bool(torch.equal(dx, again))
            results.append((kern, f"g{[b, *hwc[:2], f]} -> dx{[b, *hwc]} (bitwise "
                            f"repeatable: {same})", same,
                            *rel_err(dx.to(dtype), plain().to(dtype))))
            del dx, again
            kern, run, plain = calls["dk"]
            if kern in which:
                dk, again = run(), run()
                torch.cuda.synchronize()
                same = bool(torch.equal(dk, again))
                results.append((kern, f"x{[b, *hwc]} g[..,{f}] -> dK[{ksize * ksize * hwc[2]},"
                                f"{f}] (bitwise repeatable: {same})", same,
                                *rel_err(dk, plain())))
                del dk, again
            for kern, what, ok, rel, ab in results:
                tol = TOL[kern, dtype]
                say("kernels", f"{kern} {tag} {name} {what}: max rel err {rel:.3e} "
                    f"(max abs {ab:.3e}, tol {tol})")
                check(ok and rel <= tol, f"{kern} {name} {tag}")
                key = (kern, res, b, str(dtype))
                worst[key] = max(worst.get(key, 0.0), ab)
            del x, k, bias, g, calls
        free_cuda()
    for s, b, dtype in IN_KERNEL_CASES:
        res = "32x128" if s == 1 else "64x256"
        tag = f"{res} b{b} {str(dtype)[6:]}"
        for shape, alphas in in_shapes():
            hwc = scaled(shape, s)
            x, gamma, beta, dy = in_operands(hwc, b, dtype, gen)
            for alpha in alphas:
                y, mean, rstd = tin.instance_norm_act_k8(x, gamma, beta, alpha=alpha)
                fwd_again = tin.instance_norm_act_k8(x, gamma, beta, alpha=alpha)
                grads = tin.instance_norm_act_bwd_k9(x, dy, gamma, beta, mean, rstd,
                                                     alpha=alpha)
                again = tin.instance_norm_act_bwd_k9(x, dy, gamma, beta, mean, rstd,
                                                     alpha=alpha)
                torch.cuda.synchronize()
                same8 = all(torch.equal(a, b_) for a, b_ in zip((y, mean, rstd), fwd_again))
                same = all(torch.equal(a, b_) for a, b_ in zip(grads, again))
                y_ref, mean_ref, rstd_ref = tin.instance_norm_act_ref(x, gamma, beta,
                                                                      alpha=alpha)
                want = tin.instance_norm_act_bwd_ref(x, dy, gamma, beta, mean, rstd,
                                                     alpha=alpha)
                e8 = [rel_err(a, b_) for a, b_ in ((y, y_ref), (mean, mean_ref),
                                                   (rstd, rstd_ref))]
                e9 = [rel_err(a, b_) for a, b_ in zip(grads, want)]
                for kern, what, ok, errs in (
                        ("K8", f"y, mean, rstd (bitwise repeatable: {same8})",
                         y.dtype == dtype and same8, e8),
                        ("K9", f"dx, dgamma, dbeta (bitwise repeatable: {same})", same, e9)):
                    rel, ab = max(e[0] for e in errs), errs[0][1]
                    tol = TOL[kern, dtype]
                    say("kernels", f"{kern} {tag} x{[b, *hwc]} alpha={alpha} {what}: max rel "
                        f"err {rel:.3e} (max abs {ab:.3e}, tol {tol})")
                    check(ok and rel <= tol, f"{kern} {hwc} alpha={alpha} {tag}")
                    key = (kern, res, b, str(dtype))
                    worst[key] = max(worst.get(key, 0.0), ab)
                del y, mean, rstd, fwd_again, grads, again, y_ref, mean_ref, rstd_ref, want
            del x, gamma, beta, dy
            free_cuda()
    report["in_device_kernels"] = in_launch_check(gen)
    report["max_abs_err"] = {"/".join(map(str, k)): v for k, v in worst.items()}
    return worst


def in_launch_check(gen, calls=5):
    """K8 and K9 each run as one device kernel per call: `calls` calls of
    each at every InstanceNorm shape (64x256 b64 f32 and bf16) under
    torch.profiler, whose device kernels are counted by name. Returns
    {"K8"/"K9": {shape: {kernel name: count}}}."""
    from torch.profiler import ProfilerActivity, profile

    from skyhdr_torch.ops.kernels import instnorm as tin

    out = {"K8": {}, "K9": {}}
    for dtype in (torch.float32, torch.bfloat16):
        for shape, alphas in in_shapes():
            hwc = scaled(shape, 2)
            x, gamma, beta, dy = in_operands(hwc, 64, dtype, gen)
            alpha = alphas[-1]
            _, mean, rstd = tin.instance_norm_act_k8(x, gamma, beta, alpha=alpha)
            tin.instance_norm_act_bwd_k9(x, dy, gamma, beta, mean, rstd, alpha=alpha)
            torch.cuda.synchronize()  # warm: the library loaded, K9's counter made
            for kern, fn, name in (
                    ("K8", lambda: tin.instance_norm_act_k8(x, gamma, beta, alpha=alpha),
                     "in_fwd_kernel"),
                    ("K9", lambda: tin.instance_norm_act_bwd_k9(x, dy, gamma, beta, mean, rstd,
                                                                alpha=alpha), "in_bwd_kernel")):
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(calls):
                        fn()
                    torch.cuda.synchronize()
                seen = {}
                for evt in prof.key_averages():
                    t = getattr(evt, "self_device_time_total", None)
                    if t is None:
                        t = getattr(evt, "self_cuda_time_total", 0.0)
                    if t > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
                        seen[evt.key] = seen.get(evt.key, 0) + evt.count
                tag = f"{str(dtype)[6:]} x{[64, *hwc]}"
                say("kernels", f"{kern} {tag}: {calls} calls under torch.profiler ran device "
                    f"kernels {seen}")
                check(sum(seen.values()) == calls and all(name in k for k in seen),
                      f"{kern} {tag}: {calls} calls ran device kernels {seen}, want "
                      f"{calls} x {name}")
                out[kern][tag] = seen
            del x, gamma, beta, dy, mean, rstd
            free_cuda()
    return out


def build_port(cfg, seed, device="cuda"):
    from skyhdr_torch.train.engine import build_models
    from skyhdr_torch.utils.transplant import init_model_vars, load_model_vars

    gen, sun = build_models(cfg, device)
    gv, sv = init_model_vars(cfg, seed)
    load_model_vars(gen, gv)
    load_model_vars(sun, sv)
    return gen, sun, (gv, sv)


def phase_golden(dc, report):
    from skyhdr_torch.config import Config, DataConfig, ModelConfig
    from skyhdr_torch.train.engine import make_inference_fn
    from skyhdr_torch.utils.transplant import tree_digest

    mod = golden_tool()
    # (fixture, fused IN, DA kernel size, launches, report key)
    for path, fuse, ksize, want_launches, key in (
            (mod.FIXTURE, False, 3, SERVING_LAUNCHES, "golden_max_abs_err"),
            (mod.FIXTURE, True, 3, fused(SERVING_LAUNCHES, "serving"),
             "golden_fused_max_abs_err"),
            (mod.DA5_FIXTURE, False, 5, DA5_SERVING_LAUNCHES, "golden_da5_max_abs_err")):
        stored = np.load(path)
        x = stored["input"]
        cfg = Config(model=ModelConfig(im_height=x.shape[1], im_width=x.shape[2],
                                       use_da_conv=True, da_kernel_size=ksize,
                                       fused_instance_norm=fuse),
                     data=DataConfig(batch_size=x.shape[0]))
        gen, sun, (gv, sv) = build_port(cfg, int(stored["seed"]))
        digest = tree_digest({"gen": gv, "sun": sv})
        # Summation order may differ across numpy builds: compare to 1e-9.
        check(abs(digest - float(stored["weights_digest"])) <= 1e-9 * digest,
              f"seeded weights differ from the fixture's ({digest} vs "
              f"{float(stored['weights_digest'])}): the numpy stream changed")
        reset_counts(dc)
        out = make_inference_fn(cfg)(gen, sun, torch.from_numpy(x).cuda())
        launched = counts(dc)
        got = out["y_final_lin"].cpu().numpy()
        want = stored["y_final_lin"]
        ok = np.allclose(got, want, rtol=1e-3, atol=1e-3)
        bins_got = out["sunpose_pred"].cpu().numpy().reshape(len(x), -1).argmax(-1)
        bins_want = stored["sunpose_pred"].reshape(len(x), -1).argmax(-1)
        err = float(np.abs(got - want).max())
        name = f"k={ksize} " + ("fused IN" if fuse else "unfused IN")
        say("golden", f"16x64 DA b{len(x)} {name} vs JAX: y_final_lin max abs err {err:.3e} "
            f"(rtol 1e-3, atol 1e-3: {'ok' if ok else 'FAIL'}); argmax bins "
            f"{bins_got.tolist()} vs {bins_want.tolist()}; launches {launched}")
        check(ok, f"golden y_final_lin ({name})")
        check(np.array_equal(bins_got, bins_want), f"golden argmax bins ({name})")
        check(launched == want_launches, f"golden launches {launched}, want {want_launches}")
        report[key] = err


def golden_tool():
    spec = importlib.util.spec_from_file_location(
        "make_torch_golden", os.path.join(ROOT, "tools", "make_torch_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_train_golden(dc, report):
    from skyhdr_torch.utils.transplant import init_gan_vars, tree_digest

    mod = golden_tool()
    # (fixture, fused IN, DA kernel size, launches of the GAN step plus the
    # sun step, report key)
    for path, fuse, ksize, want, key in (
            (mod.TRAIN_FIXTURE, False, 3,
             {k: GAN_LAUNCHES[k] + SUN_LAUNCHES[k] for k in KERNELS}, "train_golden_worst"),
            (mod.TRAIN_FIXTURE, True, 3,
             {k: fused(GAN_LAUNCHES, "gan")[k] + fused(SUN_LAUNCHES, "sun")[k]
              for k in KERNELS}, "train_golden_fused_worst"),
            (mod.DA5_TRAIN_FIXTURE, False, 5, DA5_GAN_LAUNCHES, "train_golden_da5_worst")):
        stored = np.load(path)
        gv, sv, dv = init_gan_vars(mod.golden_config(ksize), int(stored["seed"]))
        digest = tree_digest({"gen": gv, "sun": sv, "disc": dv})
        check(abs(digest - float(stored["weights_digest"])) <= 1e-9 * digest,
              f"seeded GAN weights differ from the fixture's ({digest} vs "
              f"{float(stored['weights_digest'])})")
        name = f"k={ksize} " + ("fused IN" if fuse else "unfused IN")
        reset_counts(dc)
        port = mod.port_train_golden(stored, "cuda", fused_instance_norm=fuse,
                                     da_kernel_size=ksize)
        launched = counts(dc)
        fails, worst = mod.compare_train_golden(stored, port, GOLDEN_METRIC_RTOL,
                                                GOLDEN_UPDATE_RTOL)
        for kind in ("gan", "sun"):
            for metric, a, b in zip(stored[f"{kind}_metric_names"], port[f"{kind}_metrics"],
                                    stored[f"{kind}_metrics"]):
                say("train_golden", f"{name} {kind} {metric}: card {a:.7g}, JAX {b:.7g}")
        say("train_golden", f"16x64 DA b2 GAN step + sun step, {name}, vs JAX: worst "
            f"relative {json.dumps(worst)} (metrics rtol {GOLDEN_METRIC_RTOL}, updates "
            f"{GOLDEN_UPDATE_RTOL} of sum |update|, BN sums 1e-4); launches {launched}")
        for line in fails:
            say("train_golden", f"FAIL {line}")
        check(not fails, f"train golden ({name}): {len(fails)} mismatches")
        check(launched == want, f"train golden ({name}) launches {launched}, want {want}")
        report[key] = worst


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


def da5_config(batch):
    from skyhdr_torch.config import Config, DataConfig, ModelConfig

    return Config(model=ModelConfig(im_height=64, im_width=256, use_da_conv=True,
                                    da_kernel_size=5),
                  data=DataConfig(batch_size=batch))


@functools.lru_cache(maxsize=1)
def da5_trees():
    """The seeded (gen, sun, disc) trees of the da_kernel_size=5 model at
    64x256, drawn once on the host for the serving, training and timing
    phases (released after the timing phase)."""
    from skyhdr_torch.utils.transplant import init_gan_vars

    t0 = time.perf_counter()
    trees = init_gan_vars(da5_config(64), 0)
    say("da5", f"k=5 DA 64x256: seeded weights drawn on the host in "
        f"{time.perf_counter() - t0:.3f} s (one draw for serving, training and timing)")
    return trees


def da5_models():
    from skyhdr_torch.train.engine import build_models
    from skyhdr_torch.utils.transplant import load_model_vars

    gen, sun = build_models(da5_config(32), "cuda")
    gv, sv, _ = da5_trees()
    load_model_vars(gen, gv)
    load_model_vars(sun, sv)
    return gen, sun


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
    del gen, sun
    # da_kernel_size=5: `make_inference_fn` at 64x256 b32, two dispatches.
    gen, sun = da5_models()
    infer = make_inference_fn(da5_config(32))
    rng = torch.Generator(device="cuda").manual_seed(3)
    for i in range(2):
        x = torch.rand(32, 64, 256, 3, device="cuda", generator=rng)
        reset_counts(dc)
        out = infer(gen, sun, x)
        torch.cuda.synchronize()
        launched = counts(dc)
        say("serving", f"k=5 DA 64x256 b32 dispatch {i}: launches {launched} (want "
            f"{DA5_SERVING_LAUNCHES}); " + ", ".join(
                f"{k} {tuple(v.shape)}" for k, v in sorted(out.items())))
        check(launched == DA5_SERVING_LAUNCHES, f"k=5 serving launches {launched}")
        check(out["y_final_lin"].shape == (32, 64, 256, 3)
              and all(bool(torch.isfinite(v).all()) for v in out.values()),
              f"k=5 serving dispatch {i}: outputs not finite or misshapen")
    report["serving_da5_launches"] = launched
    del gen, sun, out
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
    from skyhdr_torch.train.engine import (create_sun_state, empty_gan_state, empty_sun_state,
                                           make_gan_train_step, make_sun_train_step)
    from skyhdr_torch.utils.io import get_exposure_lists, make_synthetic_dorf
    from skyhdr_torch.utils.transplant import init_gan_vars, load_model_vars

    h, w = 64, 256
    banks = make_banks(make_synthetic_dorf(175, 1024), get_exposure_lists()[0], device="cuda")

    def cfg_of(b, fuse=False):
        return Config(model=ModelConfig(im_height=h, im_width=w, use_da_conv=True,
                                        fused_instance_norm=fuse),
                      data=DataConfig(batch_size=b))

    t0 = time.perf_counter()
    trees = init_gan_vars(cfg_of(64), 0)
    say("training", f"GAN DA {h}x{w}: seeded weights drawn on the host in "
        f"{time.perf_counter() - t0:.3f} s (one draw for the unfused and the fused state)")
    out = {}
    for kind, b, nsteps in (("gan", 64, 3), ("gan_fused", 64, 3), ("gan_da5", 64, 3),
                            ("sun", 32, 2), ("sun_fused", 32, 2)):
        tag = {"gan": f"GAN DA {h}x{w} b{b}", "gan_fused": f"GAN DA {h}x{w} b{b} fused IN",
               "gan_da5": f"GAN DA k=5 {h}x{w} b{b}", "sun": f"sun DA {h}x{w} b{b}",
               "sun_fused": f"sun DA {h}x{w} b{b} fused IN"}[kind]
        t0 = time.perf_counter()
        if kind.startswith("gan"):
            cfg = da5_config(b) if kind == "gan_da5" else cfg_of(b, fuse=kind == "gan_fused")
            state = empty_gan_state(cfg, "cuda")
            for module, tree in zip((state.gen, state.sun, state.disc),
                                    da5_trees() if kind == "gan_da5" else trees):
                load_model_vars(module, tree)
            step = make_gan_train_step(cfg, banks, random_vgg16_weights())
            want = {"gan": GAN_LAUNCHES, "gan_fused": fused(GAN_LAUNCHES, "gan"),
                    "gan_da5": DA5_GAN_LAUNCHES}[kind]
            moving = "gen_total"
        elif kind == "sun":
            del trees
            cfg = cfg_of(b)
            state = create_sun_state(cfg, 0, "cuda")
            # The fused-IN state takes the same weights (no second draw).
            fused_sun = empty_sun_state(cfg_of(b, fuse=True), "cuda")
            fused_sun.sun.load_state_dict(state.sun.state_dict())
            step = make_sun_train_step(cfg, banks)
            want, moving = SUN_LAUNCHES, "sun_total"
        else:
            cfg, state = cfg_of(b, fuse=True), fused_sun
            del fused_sun
            step = make_sun_train_step(cfg, banks)
            want, moving = fused(SUN_LAUNCHES, "sun"), "sun_total"
        torch.cuda.synchronize()
        say("training", f"{tag}: state built in {time.perf_counter() - t0:.3f} s")
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
    for name, u, f in (("GAN DA 64x256 b64", out["gan"], out["gan_fused"]),
                       ("sun DA 64x256 b32", out["sun"], out["sun_fused"])):
        say("training", f"{name} fused vs unfused IN: step {f['step_ms']:.4f} vs "
            f"{u['step_ms']:.4f} ms ({f['step_ms'] - u['step_ms']:+.4f} ms), peak "
            f"{f['peak_bytes'] / 2**30:.3f} vs {u['peak_bytes'] / 2**30:.3f} GiB; on {smi}")
    report["training"] = out
    return {kind: o["launches"] for kind, o in out.items()}


def phase_timing(dc, smi, report):
    import dataclasses

    from skyhdr_torch.config import Config, ModelConfig
    from skyhdr_torch.train.engine import build_models, make_inference_fn

    fwd = {}
    for (h, w), batches in (((32, 128), (1, 32)), ((64, 256), (32,))):
        cfg = Config(model=ModelConfig(im_height=h, im_width=w, use_da_conv=True))
        gen, sun, _ = build_port(cfg, 0)
        # The fused-IN models take the same weights (no second draw).
        fcfg = cfg.replace(model=dataclasses.replace(cfg.model, fused_instance_norm=True))
        fgen, fsun = build_models(fcfg, "cuda")
        fgen.load_state_dict(gen.state_dict())
        fsun.load_state_dict(sun.state_dict())
        infer, finfer = make_inference_fn(cfg), make_inference_fn(fcfg)
        for b in batches:
            x = torch.rand(b, h, w, 3, device="cuda")
            # In turns: unfused, fused, fused, unfused.
            u = time_ms(lambda: infer(gen, sun, x), ITERS // 2)
            f = time_ms(lambda: finfer(fgen, fsun, x), ITERS // 2)
            f += time_ms(lambda: finfer(fgen, fsun, x), ITERS // 2)
            u += time_ms(lambda: infer(gen, sun, x), ITERS // 2)
            ms, fms = statistics.median(u), statistics.median(f)
            fwd[f"{h}x{w}_b{b}"] = ms
            fwd[f"{h}x{w}_b{b}_fused_in"] = fms
            say("timing", f"forward {h}x{w} DA b{b}: {ms:.4f} ms/dispatch, fused IN "
                f"{fms:.4f} ms/dispatch (median of {ITERS} each, CUDA events, in turns) "
                f"on {smi}")
        del gen, sun, fgen, fsun
        free_cuda()
    gen, sun = da5_models()
    infer = make_inference_fn(da5_config(32))
    x = torch.rand(32, 64, 256, 3, device="cuda")
    fwd["64x256_b32_da5"] = ms = statistics.median(time_ms(lambda: infer(gen, sun, x)))
    say("timing", f"forward 64x256 DA k=5 b32: {ms:.4f} ms/dispatch (median of {ITERS}, "
        f"CUDA events) on {smi}")
    del gen, sun, x
    free_cuda()
    report["forward_ms"] = fwd

    gen_ = torch.Generator(device="cuda").manual_seed(1)
    # Per serving dispatch (64x256 b32) and per GAN step (64x256 b64), at
    # k=3 (K1-K3) and at da_kernel_size=5 (K5-K7):
    # [kernel ms, plain ms, bound ms, flop-bound ms, byte-bound ms].
    totals = {}
    rows = []

    def timed_row(kern, path, b, name, hwc, f, ksize, calls, kfn, pfn):
        from skyhdr_torch.ops.distortion import strip_tables

        ms, plain = paired_ms(kfn, pfn)
        bms, by = bound(kern, b, hwc, f, ksize=ksize)
        per = {"serving": "per dispatch", "gan": "per GAN step"}.get(path, "not on a driven path")
        row = {"kernel": kern, "path": path, "batch": b, "layer": name, "k": ksize,
               "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by, "calls": calls}
        note = ""
        if ROLE[kern] == "fwd":
            row["rows"], row["chans"] = dc.fwd_launch_tiling(b, hwc[0], hwc[1], f, 0)
            note = f"; {row['rows']} rows x 8x{row['chans']} tiles a block"
        if ROLE[kern] == "dk":
            # The plan the library gave: splits x blocks per split of this
            # many threads, and the blocks resident on an SM.
            from skyhdr_torch.ops.distortion import window_tables_on

            _, _, taps, span = window_tables_on(torch.device("cuda", 0), hwc[0], hwc[1], ksize)
            (row["splits"], row["tiles"], row["threads"],
             row["resident"]) = dc.dk_launch_tiling(b, hwc[0], hwc[1], -(-hwc[2] // 4) * 4, f,
                                                    ksize, taps, span, False, 0)
            note = (f"; {row['splits']} splits x {row['tiles']} blocks of {row['threads']} "
                    f"threads, {row['resident']} resident an SM")
        if ROLE[kern] == "dx":
            # The strip height picked, the products done / the forward's (the
            # bound's count), and the kernel's time at each strip height.
            rows_ = dx_rows(dc, b, hwc, f)
            pairs = len(strip_tables(hwc[0], hwc[1], ksize, rows_).pint)
            row["rows"] = rows_
            row["products_vs_forward"] = pairs / (hwc[0] * ksize * ksize)
            pick, row["ms_by_rows"] = dc.dx_strip_rows, {}
            try:
                for r in dc.DX_STRIP_ROWS:
                    dc.dx_strip_rows = lambda *_, r=r: r
                    row["ms_by_rows"][r] = statistics.median(time_ms(kfn))
            finally:
                dc.dx_strip_rows = pick
            note = (f"; R={rows_} picked, {row['products_vs_forward']:.4f}x the forward's "
                    f"products; at R=" + "/".join(map(str, row["ms_by_rows"])) + ": "
                    + "/".join(f"{v:.4f}" for v in row["ms_by_rows"].values()) + " ms")
        say("timing", f"{kern} 64x256 b{b} {name} x{[b, *hwc]} F={f}: kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bms:.4f} ms ({by}; "
            f"{100 * bms / ms:.1f}% of it), x{calls} {per}{note}; on {smi}")
        rows.append(row)
        if calls:
            t = totals.setdefault((path, kern), [0.0] * 5)
            t[0] += calls * ms
            t[1] += calls * plain
            t[2] += calls * bms
            t[3 if by == "operations" else 4] += calls * bms

    for path, b in (("serving", 32), ("gan", 64)):
        for ksize, layers in ((3, DA_LAYERS), (5, DA5_LAYERS)):
            for name, shape, f, n, in_sun in layers:
                hwc = scaled(shape, 2)
                x, k, bias, g = operands(hwc, b, f, torch.float32, gen_, ksize)
                per_role = {"fwd": n, "dx": (n if path == "gan" else 0) + (n if in_sun else 0),
                            "dk": n if path == "gan" else 0}
                for role, (kern, kfn, pfn) in da_calls(dc, ksize, x, k, bias, g).items():
                    if per_role[role]:
                        timed_row(kern, path, b, name, hwc, f, ksize, per_role[role], kfn, pfn)
                del x, k, bias, g
                free_cuda()
    # The k=7 layer shapes, per call at 64x256 b32.
    for name, shape, f in DA7_LAYERS:
        hwc = scaled(shape, 2)
        x, k, bias, g = operands(hwc, 32, f, torch.float32, gen_, 7)
        for kern, kfn, pfn in da_calls(dc, 7, x, k, bias, g).values():
            timed_row(kern, "k7", 32, name, hwc, f, 7, 0, kfn, pfn)
        del x, k, bias, g
        free_cuda()
    report["kernel_ms"] = rows
    for (path, kern), t in totals.items():
        at = "64x256 b32 dispatch" if path == "serving" else "64x256 b64 GAN step"
        say("timing", f"{kern} per {at}{' (k=5)' if kern in ('K5', 'K6', 'K7') else ''}: "
            f"kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms, bound {t[2]:.4f} ms")
    report["kernel_totals"] = {f"{p}/{k}": t[:3] for (p, k), t in totals.items()}

    in_rows, in_totals = in_timing(smi, gen_)
    report["in_kernel_ms"] = in_rows
    for (path, kern, dt), t in in_totals.items():
        say("timing", f"{kern} {dt} per {'64x256 b32 dispatch' if path == 'serving' else '64x256 b64 GAN step'}: "
            f"kernel {t[0]:.4f} ms, plain {t[1]:.4f} ms, bound {t[2]:.4f} ms ({100 * t[2] / t[0]:.1f}% "
            f"of it), library {t[5]:.4f} ms; device time with work queued ahead; on {smi}")
        report["kernel_totals"][f"{path}/{kern}/{dt}"] = [t[0], t[1], t[2], t[5]]
        if dt == "float32":
            totals[path, kern] = t
    return totals


def host_us(fn, calls=200):
    """Host microseconds per call of a wrapper: `calls` calls with no
    synchronisation (the host's enqueue time), then one synchronise."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = 1e6 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return us


def in_timing(smi, gen, dtypes=(torch.float32, torch.bfloat16)):
    """K8/K9 per serving dispatch (64x256 b32) and per GAN step (64x256 b64)
    at every InstanceNorm shape and slope, in f32 and bf16: device ms (median
    of 20, CUDA events, with device work queued ahead so that they bracket
    the device's time, not the wrapper's; kernel and plain version in
    turns), the library yardstick (F.instance_norm on the NCHW view, the
    slope-1 case, it has no activation, and its autograd backward; queued
    too), the wrapper's host microseconds per call, and the bound. Returns
    (rows, {(path, kern, dtype): [kernel ms, plain ms, bound ms, flop-bound
    ms, byte-bound ms, library ms] summed over the calls})."""
    import torch.nn.functional as F

    from skyhdr_torch.ops.kernels import instnorm as tin

    totals, rows = {}, []
    for dtype in dtypes:
        dt = str(dtype)[6:]
        for path, b in (("serving", 32), ("gan", 64)):
            for shape, alphas in in_shapes():
                hwc = scaled(shape, 2)
                x, gamma, beta, dy = in_operands(hwc, b, dtype, gen)
                xv, dyv = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
                lib8 = statistics.median(time_ms(
                    lambda: F.instance_norm(xv, weight=gamma, bias=beta, eps=1e-3),
                    queued=True))
                xr = xv.detach().requires_grad_()
                gr, br = gamma.clone().requires_grad_(), beta.clone().requires_grad_()
                yl = F.instance_norm(xr, weight=gr, bias=br, eps=1e-3)
                lib9 = statistics.median(time_ms(
                    lambda: torch.autograd.grad(yl, (xr, gr, br), dyv, retain_graph=True),
                    queued=True))
                del xr, gr, br, yl
                for alpha in alphas:
                    _, mean, rstd = tin.instance_norm_act_k8(x, gamma, beta, alpha=alpha)
                    n8, n9 = in_calls(shape, alpha, path)
                    runs = [("K8", n8, lib8,
                             lambda: tin.instance_norm_act_k8(x, gamma, beta, alpha=alpha),
                             lambda: tin.instance_norm_act_ref(x, gamma, beta, alpha=alpha))]
                    if n9:
                        runs.append(("K9", n9, lib9,
                                     lambda: tin.instance_norm_act_bwd_k9(
                                         x, dy, gamma, beta, mean, rstd, alpha=alpha),
                                     lambda: tin.instance_norm_act_bwd_ref(
                                         x, dy, gamma, beta, mean, rstd, alpha=alpha)))
                    for kern, calls, lib, kfn, pfn in runs:
                        ms, plain = paired_ms(kfn, pfn, queued=True)
                        us = host_us(kfn)
                        bms, by = in_bound(kern, b, hwc, x.element_size())
                        # A tree from before the plan (tools/time_torch_instnorm.py
                        # --root times older ones too) has no `in_tiling`.
                        plan = tin.in_tiling(b, hwc[0] * hwc[1], hwc[2], x.element_size(),
                                             torch.cuda.get_device_properties(0).multi_processor_count,
                                             1 if kern == "K8" else 2) \
                            if hasattr(tin, "in_tiling") else None
                        say("timing", f"{kern} {dt} 64x256 b{b} x{[b, *hwc]} alpha={alpha}: "
                            f"kernel {ms:.4f} ms, plain {plain:.4f} ms, library {lib:.4f} ms, "
                            f"bound {bms:.4f} ms ({by}; {100 * bms / ms:.1f}% of it), host "
                            f"{us:.2f} us a call, x{calls} per "
                            f"{'dispatch' if path == 'serving' else 'GAN step'}; plan {plan}; "
                            f"on {smi}")
                        rows.append({"kernel": kern, "dtype": dt, "path": path, "batch": b,
                                     "shape": [b, *hwc], "alpha": alpha, "ms": ms,
                                     "plain_ms": plain, "library_ms": lib, "host_us": us,
                                     "bound_ms": bms, "bound_by": by, "calls": calls,
                                     "plan": plan._asdict() if plan else None})
                        t = totals.setdefault((path, kern, dt), [0.0] * 6)
                        t[0] += calls * ms
                        t[1] += calls * plain
                        t[2] += calls * bms
                        t[3 if by == "operations" else 4] += calls * bms
                        t[5] += calls * lib
                    del mean, rstd
                del x, gamma, beta, dy, xv, dyv
                free_cuda()
    return rows, totals


def synth_panorama(rng, h, w):
    """One HDR sky dome and its sun row, drawn as
    `tools/make_synth_dataset.synth_panorama` draws them (that tool imports
    the JAX package, so this script keeps its own copy)."""
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    zenith = rng.uniform(0.2, 0.7, size=3).astype(np.float32)
    horizon = zenith * rng.uniform(1.2, 2.5, size=3).astype(np.float32)
    g = (yy / (h - 1))[..., None]
    sky = (1 - g) * zenith + g * horizon
    cloud = np.zeros((h, w), np.float32)
    for _ in range(rng.integers(2, 5)):
        kx = rng.integers(1, 4)
        ky = rng.uniform(0.5, 2.0)
        phase = rng.uniform(0, 2 * np.pi)
        amp = rng.uniform(0.05, 0.25)
        cloud += amp * np.sin(2 * np.pi * kx * xx / w + phase) * np.cos(np.pi * ky * yy / h)
    sky = sky * (1.0 + cloud[..., None]).clip(0.3, 2.0)
    sun_y = float(rng.uniform(2.0, h - 3.0))
    sun_x = w * 0.5 - 1.0
    width = rng.uniform(1.0, 2.5)
    intensity = rng.uniform(80.0, 600.0)
    dx = np.minimum(np.abs(xx - sun_x), w - np.abs(xx - sun_x))
    d2 = (yy - sun_y) ** 2 + dx ** 2
    warm = np.array([1.0, 0.9, 0.75], np.float32)
    sun = intensity * np.exp(-d2 / (2 * width ** 2))[..., None] * warm
    glow = 0.15 * intensity * np.exp(-d2 / (2 * (4 * width) ** 2))[..., None]
    img = sky + sun + glow
    img += rng.normal(0, 0.01, size=img.shape).astype(np.float32)
    return np.maximum(img, 1e-4).astype(np.float32), sun_y


def write_dataset(root, h, w, counts, per_file=32, seed=0):
    """<root>/<split>/NNNN.tfrecord with the port's writer, records in the
    reference's format (BGR float32 image, azimuth, elevation)."""
    from skyhdr_torch.data.records import write_tfrecord

    rng = np.random.default_rng(seed)
    for split, n in counts.items():
        os.makedirs(os.path.join(root, split))
        examples = []
        for _ in range(n):
            img, sun_y = synth_panorama(rng, h, w)
            examples.append({"image": img[:, :, ::-1].tobytes(),
                             "azimuth": float(w * 0.5 - 1.0), "elevation": sun_y})
        for i in range(0, n, per_file):
            write_tfrecord(os.path.join(root, split, f"{i // per_file:04d}.tfrecord"),
                           examples[i:i + per_file])


def read_scalars(logdir):
    """{(tag, step): value} of the TensorBoard event file in `logdir`, read
    with the port's record reader (CRCs checked)."""
    from skyhdr_torch.data.records import _read_varint, iter_tfrecord

    (name,) = os.listdir(logdir)
    out = {}
    for rec in iter_tfrecord(os.path.join(logdir, name), compression="", verify_crc=True):
        pos, step, summary = 0, 0, None
        while pos < len(rec):
            key, pos = _read_varint(rec, pos)
            field, wire = key >> 3, key & 7
            if wire == 1:
                pos += 8
            elif wire == 0:
                val, pos = _read_varint(rec, pos)
                step = val if field == 2 else step
            else:
                ln, pos = _read_varint(rec, pos)
                summary = rec[pos:pos + ln] if field == 5 else summary
                pos += ln
        if summary is not None:
            p = _read_varint(summary, _read_varint(summary, 0)[1])[1]  # Summary.value
            n, p = _read_varint(summary, _read_varint(summary, p)[1])  # Value.tag
            tag = summary[p:p + n].decode()
            out[tag, step] = struct.unpack("<f", summary[p + n + 1:p + n + 5])[0]
    return out


def phase_train_cli(dc, smi, report):
    import contextlib
    import io
    import re

    from skyhdr_torch.cli import train
    from skyhdr_torch.config import Config, DataConfig, ModelConfig, TrainConfig
    from skyhdr_torch.data.degradation import make_banks
    from skyhdr_torch.data.pipeline import PanoramaDataset
    from skyhdr_torch.train.checkpoints import CheckpointManager
    from skyhdr_torch.train.engine import (create_sun_state, make_sun_eval_step,
                                           make_sun_train_step)
    from skyhdr_torch.train.loop import TrainLoop
    from skyhdr_torch.utils.io import get_exposure_lists, make_synthetic_dorf

    from skyhdr_torch.native import has_native

    check(has_native(), "the C CRC32C helper did not build: the records would take the "
          "pure-Python CRC")
    h, w, b = 32, 128, 32
    work = tempfile.mkdtemp(prefix="skyhdr_cli_")
    ds = os.path.join(work, "dataset")
    t0 = time.perf_counter()
    write_dataset(ds, h, w, {"train": 4 * b, "test": b})
    say("train_cli", f"wrote {4 * b} train + {b} test records at {h}x{w} in "
        f"{time.perf_counter() - t0:.3f} s")
    base = ["--dir", ds, "--imheight", str(h), "--imwidth", str(w), "--da-conv", "true",
            "--batchsize", str(b), "--ckpt-every", "1", "--device", "cuda",
            "--dorf", "", "--vgg", ""]
    epoch_s = {}

    def run(workdir, *extra):
        buf = io.StringIO()
        reset_counts(dc)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            train.main(base + ["--workdir", workdir, *extra])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        text = buf.getvalue()
        for line in text.splitlines():
            say("train_cli", f"| {line}")
        epochs = [int(e) for e, _ in re.findall(r"^Epoch (\d+): .* elapsed=([\d.]+)s$",
                                                 text, re.M)]
        for e, secs_e in re.findall(r"^Epoch (\d+): .* elapsed=([\d.]+)s$", text, re.M):
            epoch_s.setdefault(workdir, {})[int(e)] = float(secs_e)
        launched = counts(dc)
        say("train_cli", f"main({' '.join(extra)}): {secs:.3f} s wall (state, dataset "
            f"and banks set-up included); epochs run {epochs}; launches {launched}")
        check(launched["K1"] > 0 and launched["K3"] > 0, "the CLI ran no DA kernel")
        return text, epochs

    sky = os.path.join(work, "run")
    _, epochs = run(sky, "--epochs", "2")
    ckpt = CheckpointManager(os.path.join(sky, "checkpoints", "SKY"))
    check(epochs == [1, 2] and ckpt.steps() == [1, 2],
          f"2 epochs, 2 checkpoints: ran {epochs}, saved {ckpt.steps()}")
    (tb_root,) = os.listdir(os.path.join(sky, "tensorboard", "SKY"))
    for split in ("train", "val"):
        got = read_scalars(os.path.join(sky, "tensorboard", "SKY", tb_root, split))
        for tag in ("gen_total", "l1", "kl", "dog", "adv", "perceptual", "disc_total"):
            vals = [got.get((tag, e)) for e in (1, 2)]
            check(all(v is not None and math.isfinite(v) for v in vals),
                  f"TensorBoard {split}/{tag} at epochs 1, 2: {vals}")
        say("train_cli", f"TensorBoard {split}: {len(got)} scalars read back, gen_total "
            f"{got['gen_total', 1]:.6g} -> {got['gen_total', 2]:.6g}")
    text, epochs = run(sky, "--epochs", "3")
    check("Latest SKY checkpoint restored (epoch 2)" in text and epochs == [3]
          and ckpt.steps() == [1, 2, 3], f"resume: ran {epochs}, saved {ckpt.steps()}")

    # The SUN -> SKY hand-off: a SUN pretrain epoch from other weights, then
    # a fresh SKY run at lr 0, so that its checkpoint shows the weights it
    # started from.
    handoff = os.path.join(work, "handoff")
    cfg = Config(model=ModelConfig(im_height=h, im_width=w, use_da_conv=True),
                 data=DataConfig(batch_size=b), train=TrainConfig(ckpt_every_epochs=1))
    crf = make_synthetic_dorf(201, 1024)
    exposures = get_exposure_lists()
    kw = dict(imshape=(h, w, 3), batch_size=b)
    TrainLoop(cfg, "SUN", lambda: create_sun_state(cfg, 7, "cuda"),
              make_sun_train_step(cfg, make_banks(crf[:175], exposures[0], device="cuda")),
              make_sun_eval_step(cfg, make_banks(crf[175:], exposures[1], device="cuda")),
              PanoramaDataset(os.path.join(ds, "train"), **kw),
              PanoramaDataset(os.path.join(ds, "test"), shuffle=False, **kw),
              workdir=handoff, log=lambda line: say("train_cli", f"| {line}"),
              device="cuda").run(epochs=1)
    text, _ = run(handoff, "--epochs", "1", "--lr", "0")
    sun_ckpt = CheckpointManager(os.path.join(handoff, "checkpoints", "SUN")).read_latest()
    sky_ckpt = CheckpointManager(os.path.join(handoff, "checkpoints", "SKY")).read_latest()
    want, got = sun_ckpt["modules"]["sun"], sky_ckpt["modules"]["sun"]
    same = sorted(want) == sorted(got) and all(torch.equal(got[k], v) for k, v in want.items())
    say("train_cli", f"SUN hand-off: {len(want)} sun-pose tensors of the SKY checkpoint "
        f"equal to the SUN checkpoint's: {same}")
    check("Pretrained SUN checkpoint restored for fine-tuning" in text and same,
          "SUN hand-off")
    report["train_cli"] = {"epoch_s": epoch_s[sky], "device": smi}
    say("train_cli", f"epoch seconds at DA {h}x{w} b{b} (4 train steps + 1 eval batch, "
        f"checkpoint save included): {epoch_s[sky]}; on {smi}")


def run_cli(dc, phase, main, argv, tag):
    """Runs a CLI's `main(argv)` with the launch counts set to 0 just before
    it; echoes its standard output. Returns (text, wall seconds, launches)."""
    import contextlib
    import io

    buf = io.StringIO()
    reset_counts(dc)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched = counts(dc)
    text = buf.getvalue()
    lines = text.splitlines()
    for line in lines[:8] + (["..."] if len(lines) > 10 else []) + lines[max(8, len(lines) - 2):]:
        say(phase, f"| {line}")
    say(phase, f"{tag}: {secs:.3f} s wall; launches {launched}")
    return text, secs, launched


def write_laval(root, h, w, counts_by_date, seed=0):
    """A Laval-shaped tree of .hdr envmaps [2h, w]: envmap/<date>/<time>/
    envmap.hdr (a synthetic sky over a dim ground) and csv_day/<date> rows
    (Datetime, "Sun elevation" as the zenith in radians, "Sun azimuth" 0:
    the sun stays at the column the model pins). The zenith puts the
    record's elevation, h - zenith in pixels, at the sun's row."""
    import csv

    from skyhdr_torch.utils.io import write_hdr

    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "csv_day"))
    for date, n in counts_by_date.items():
        rows = []
        for i in range(n):
            t = f"{6 + i // 60:02d}{i % 60:02d}00"
            sky, sun_y = synth_panorama(rng, h, w)
            os.makedirs(os.path.join(root, "envmap", date, t))
            write_hdr(os.path.join(root, "envmap", date, t, "envmap.hdr"),
                      np.concatenate([sky, np.full_like(sky, 0.05)]))
            zenith = math.radians((h - round(sun_y)) * 90.0 / h)
            rows.append([f"{date[:4]}-{date[4:6]}-{date[6:]} {t[:2]}:{t[2:4]}:{t[4:]}",
                         repr(zenith), "0.0"])
        with open(os.path.join(root, "csv_day", date), "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["Datetime", "Sun elevation", "Sun azimuth"])
            writer.writerows(rows)


def write_real_pairs(root, n, h, w, seed=0):
    """n real-capture-shaped pairs: a GT .hdr [2h, w] (a synthetic sky over a
    dim ground) and a JPEG LDR of half its size (the tone-mapped GT, every
    other pixel)."""
    from PIL import Image

    from skyhdr_torch.utils.io import write_hdr

    rng = np.random.default_rng(seed)
    gt_dir, in_dir = os.path.join(root, "gt"), os.path.join(root, "in")
    os.makedirs(gt_dir)
    os.makedirs(in_dir)
    for i in range(n):
        sky, _ = synth_panorama(rng, h, w)
        gt = np.concatenate([sky, np.full_like(sky, 0.05)])
        write_hdr(os.path.join(gt_dir, f"scene{i}.hdr"), gt)
        ldr = (np.clip(gt[::2, ::2], 0, 1) ** (1 / 2.2) * 255).round().astype(np.uint8)
        Image.fromarray(ldr).save(os.path.join(in_dir, f"scene{i}.jpg"), quality=92)
    return gt_dir, in_dir


class VisRecorder:
    """Wraps `skyhdr_torch.utils.vis`'s two savers while the phase runs: each
    call is recorded, and drawn only where matplotlib imports."""

    NAMES = ("save_image_grid", "save_eval_panel")

    def __init__(self):
        from skyhdr_torch.utils import vis

        self.vis = vis
        self.real = {n: getattr(vis, n) for n in self.NAMES}
        self.calls = []
        try:
            import matplotlib  # noqa: F401
            self.draws = True
        except ImportError:
            self.draws = False

    def __enter__(self):
        def wrap(name):
            def saver(*args):
                self.calls.append((name, args))
                if self.draws:
                    self.real[name](*args)
            return saver

        for n in self.NAMES:
            setattr(self.vis, n, wrap(n))
        return self

    def __exit__(self, *exc):
        for n, f in self.real.items():
            setattr(self.vis, n, f)


def write_serving_checkpoint(workdir, cfg, seed):
    """<workdir>/checkpoints/SKY/1/state.pt holding the serving modules'
    weights, `init_model_vars(cfg, seed)` (drawn once on the host, for every
    evaluate run at this shape; the CLIs restore it as "Latest SKY
    checkpoint")."""
    gen, sun, _ = build_port(cfg, seed, "cpu")
    path = os.path.join(workdir, "checkpoints", "SKY", "1")
    os.makedirs(path)
    torch.save({"kind": "gan", "step": 0, "epoch": 1,
                "modules": {"gen": gen.state_dict(), "sun": sun.state_dict()},
                "optimizers": {}}, os.path.join(path, "state.pt"))


def last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def time_eval_step(cfg, workdir, batch, smi, tag):
    """CUDA-event times (median of 20 after warm-up) of one synthetic eval
    step of `cli.evaluate` on `batch` [b, h, w, 3]: the degradation, the
    forward and the metrics, and the three in a row."""
    from skyhdr_torch.cli.common import load_banks, restore_model_vars
    from skyhdr_torch.train.engine import degrade, make_inference_fn
    from skyhdr_torch.train.evaluation import evaluate_batch

    gen, sun = restore_model_vars(cfg, workdir, device="cuda", log=lambda *a: None)
    banks = load_banks(cfg, "", train=False, device="cuda", log=lambda *a: None)
    infer = make_inference_fn(cfg)
    g = torch.Generator("cuda").manual_seed(0)
    hdr_t, ldr = degrade(cfg, banks, g, batch)
    pred = infer(gen, sun, ldr)["y_final_lin"]

    def step():
        target, inputs = degrade(cfg, banks, g, batch)
        return evaluate_batch(infer(gen, sun, inputs)["y_final_lin"], target)

    parts = {"degradation": lambda: degrade(cfg, banks, g, batch),
             "forward": lambda: infer(gen, sun, ldr),
             "metrics": lambda: evaluate_batch(pred, hdr_t),
             "step": step}
    out = {k: statistics.median(time_ms(f)) for k, f in parts.items()}
    say("cli", f"eval step {tag}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in out.items())
        + f" (CUDA events, median of {ITERS}); on {smi}")
    del gen, sun
    free_cuda()
    return out


def phase_cli(dc, smi, report):
    from skyhdr_torch.cli import (convert_real_eval, dataset_generator, evaluate,
                                  train_sun)
    from skyhdr_torch.config import Config, DataConfig, ModelConfig
    from skyhdr_torch.data.records import read_tfrecord_examples
    from skyhdr_torch.train.checkpoints import CheckpointManager

    work = tempfile.mkdtemp(prefix="skyhdr_clis_")
    out = report["cli"] = {"device": smi, "wall_s": {}}
    rec = VisRecorder()
    found = {}
    for name in ("matplotlib", "pandas", "cv2", "PIL"):
        try:
            found[name] = getattr(importlib.import_module(name), "__version__", "installed")
        except ImportError:
            found[name] = "NOT installed"
    out["host_packages"] = found
    say("cli", "host packages: " + ", ".join(f"{k} {v}" for k, v in found.items()))
    say("cli", "matplotlib imports: the figures are drawn" if rec.draws else
        "matplotlib is NOT installed: the figures' inputs are recorded and checked, "
        "no PNG is drawn")

    # 1. dataset_generator: a Laval tree of .hdr envmaps -> 32x128 records.
    h, w, b, n_train, n_test = 32, 128, 32, 64, 32
    laval = os.path.join(work, "laval")
    write_laval(laval, h, w, {"20140101": 48, "20140102": 48})
    _, secs, _ = run_cli(dc, "cli", dataset_generator.main,
                         ["--dir", laval, "--out", work, "--imheight", str(h), "--imwidth",
                          str(w), "--img-bias", "1e-6", "--train-split", str(n_train),
                          "--envmap-ext", "hdr"], "dataset_generator")
    out["wall_s"]["dataset_generator"] = secs
    ds = os.path.join(work, f"dataset_{w}_{h}")
    for split, n in (("train", n_train), ("test", n_test)):
        with open(os.path.join(ds, split, f"{split}_refine.csv")) as f:
            rows = f.read().splitlines()[1:]
        images = [np.frombuffer(ex["image"], np.float32)
                  for ex in read_tfrecord_examples(os.path.join(ds, "tfrecord", split))]
        check(len(rows) == len(images) == n, f"{split}: {len(rows)} CSV rows, "
              f"{len(images)} records, want {n}")
        check(all(im.size == h * w * 3 and np.isfinite(im).all() for im in images),
              f"{split} records not finite at {h}x{w}x3")
    say("cli", f"dataset: {n_train} train + {n_test} test records, each finite at {h}x{w}x3")

    # 2. train_sun --train true: DA 32x128 b32, 2 epochs, a checkpoint each.
    sun_work = os.path.join(work, "sun")
    flags = ["--imheight", str(h), "--imwidth", str(w), "--da-conv", "true",
             "--device", "cuda", "--dorf", "", "--workdir", sun_work]
    with rec:
        text, secs, launched = run_cli(
            dc, "cli", train_sun.main,
            flags + ["--train", "true", "--dir", os.path.join(ds, "tfrecord"),
                     "--batchsize", str(b), "--epochs", "2", "--ckpt-every", "1",
                     "--outputimg-every", "1"], "train_sun --train true")
    out["wall_s"]["train_sun_train"] = secs
    steps, evals = 2 * n_train // b, 2 * n_test // b
    want = {k: steps * SUN_LAUNCHES[k] + evals * SUN_EVAL_LAUNCHES[k] for k in KERNELS}
    check(launched == want, f"train_sun launches {launched}, want {want} ({steps} steps "
          f"x {SUN_LAUNCHES}, {evals} eval batches x {SUN_EVAL_LAUNCHES})")
    check(CheckpointManager(os.path.join(sun_work, "checkpoints", "SUN")).steps() == [1, 2],
          "train_sun: a checkpoint each epoch")
    (tb_root,) = os.listdir(os.path.join(sun_work, "tensorboard", "SUN"))
    for split in ("train", "val"):
        got = read_scalars(os.path.join(sun_work, "tensorboard", "SUN", tb_root, split))
        vals = [got.get(("sun_total", e)) for e in (1, 2)]
        check(all(v is not None and math.isfinite(v) for v in vals) and vals[0] != vals[1],
              f"train_sun {split} sun_total at epochs 1, 2: {vals}")
        say("cli", f"train_sun {split} sun_total {vals[0]:.6g} -> {vals[1]:.6g}")
    grids = [a for name, a in rec.calls if name == "save_image_grid"]
    check(len(grids) == 10 and all(np.isfinite(a[0]).all() for a in grids),
          f"{len(grids)} epoch grids (want 5 a epoch)")
    gts = os.listdir(os.path.join(sun_work, "outputImg", "SUN", "groundTruth"))
    check(len(gts) == b, f"{len(gts)} groundTruth .hdr (want {b})")
    say("cli", f"epoch dumps: {len(grids)} grids "
        + ("drawn" if rec.draws else "recorded, not drawn (no matplotlib)")
        + f", {len(gts)} groundTruth .hdr")

    # 3. train_sun --train false on four .hdr files, from that SUN checkpoint.
    hdr_dir = os.path.join(work, "hdrs")
    os.makedirs(hdr_dir)
    test_hdrs = sorted(os.listdir(os.path.join(ds, "test", "hdr")))[:4]
    for name in test_hdrs:
        shutil.copy(os.path.join(ds, "test", "hdr", name), hdr_dir)
    rec.calls.clear()
    with rec:
        text, secs, launched = run_cli(dc, "cli", train_sun.main,
                                       flags + ["--train", "false", "--inference_img_dir",
                                                hdr_dir], "train_sun --train false")
    out["wall_s"]["train_sun_eval"] = secs
    check("Latest SUN checkpoint restored" in text, "train_sun --train false: no restore")
    want = {k: 4 * SUN_EVAL_LAUNCHES[k] for k in KERNELS}
    check(launched == want, f"train_sun --train false launches {launched}, want {want}")
    panels = [a for name, a in rec.calls if name == "save_eval_panel"]
    check(len(panels) == 4 and all(len(p[0]) == 6 and all(np.isfinite(x).all() for x in p[0])
                                   for p in panels), "train_sun --train false panels")
    gated = [float(np.max(p[0][4])) for p in panels]
    say("cli", f"CAM-gated predictions finite, maxima {gated}; six-panel figures "
        + ("drawn" if rec.draws else "recorded, not drawn (no matplotlib)"))

    # 4. evaluate, synthetic: DA 64x256 b32 (the serving cell), then plain 32x128 b32.
    eh, ew = 64, 256
    eval_work = os.path.join(work, "eval")
    test_dir = os.path.join(work, "eval_data")
    write_dataset(test_dir, eh, ew, {"test": 2 * b})
    da_cfg = Config(model=ModelConfig(im_height=eh, im_width=ew, use_da_conv=True),
                    data=DataConfig(batch_size=b))
    t0 = time.perf_counter()
    write_serving_checkpoint(eval_work, da_cfg, 0)
    say("cli", f"DA {eh}x{ew}: seeded serving weights drawn and saved as a SKY checkpoint in "
        f"{time.perf_counter() - t0:.3f} s (one draw for every evaluate run at this shape)")
    eflags = ["--imheight", str(eh), "--imwidth", str(ew), "--da-conv", "true",
              "--device", "cuda", "--dorf", "", "--workdir", eval_work]
    results = []
    for run in range(2):
        text, secs, launched = run_cli(
            dc, "cli", evaluate.main,
            eflags + ["--dir", os.path.join(test_dir, "test"), "--batchsize", str(b),
                      "--max-batches", "2", "--seed", "5"], f"evaluate DA {eh}x{ew} b{b} "
            f"run {run}")
        out["wall_s"][f"evaluate_da_{run}"] = secs
        check("Latest SKY checkpoint restored" in text, "evaluate restored no checkpoint")
        want = {k: 2 * v for k, v in SERVING_LAUNCHES.items()}
        check(launched == want, f"evaluate launches {launched}, want {want}")
        results.append(last_json(text))
    res = results[0]
    check(res["images"] == 2 * b and all(math.isfinite(res[k])
                                         for k in ("psnr", "si_rmse", "emd")),
          f"evaluate DA: {res}")
    check(results[0] == results[1], f"evaluate twice with one seed: {results}")
    say("cli", f"evaluate DA {eh}x{ew} b{b}: {res}; the second run printed the same JSON")
    out["evaluate_da"] = res
    plain_work = os.path.join(work, "plain")
    plain_data = os.path.join(work, "plain_data")
    write_dataset(plain_data, h, w, {"test": b})
    text, secs, launched = run_cli(
        dc, "cli", evaluate.main,
        ["--imheight", str(h), "--imwidth", str(w), "--device", "cuda", "--dorf", "",
         "--workdir", plain_work, "--dir", os.path.join(plain_data, "test"),
         "--batchsize", str(b)], f"evaluate plain {h}x{w} b{b}")
    out["wall_s"]["evaluate_plain"] = secs
    res = last_json(text)
    check(launched == launches() and res["images"] == b
          and all(math.isfinite(res[k]) for k in ("psnr", "si_rmse", "emd")),
          f"evaluate plain: {res}, launches {launched}")
    out["evaluate_plain"] = res

    # 5. convert_real_eval -> evaluate --real-dir at DA 64x256, b2 and b1. The
    # b2 run pads its last batch (image 4 repeated). Images 0-3 at b2 and
    # image 4 alone at b1 group the images as the padded run does, so their
    # weighted means hold the padding alone. The plain b1 run groups them
    # otherwise, and the model couples a batch: it scales the sun-pose PDF
    # by its maximum over the batch (`Generator.sun_rad_estimation`, as
    # `skyhdr`), which moves the metrics of skies with distinct suns.
    gt_dir, in_dir = write_real_pairs(os.path.join(work, "real"), 5, eh, ew)
    records = os.path.join(work, "real", "records")
    _, secs, _ = run_cli(dc, "cli", convert_real_eval.main,
                         ["--gt-dir", gt_dir, "--input-dir", in_dir, "--out", records,
                          "--gt-ext", "hdr"], "convert_real_eval")
    out["wall_s"]["convert_real_eval"] = secs
    for part, names in (("head", range(4)), ("tail", [4])):
        os.makedirs(os.path.join(work, "real", part))
        for i in names:
            shutil.copy(os.path.join(records, f"scene{i}.tfrecord"),
                        os.path.join(work, "real", part))
    real = {}
    for tag, rb, src, n in (("b2", 2, records, 5), ("b1", 1, records, 5),
                            ("b2 images 0-3", 2, os.path.join(work, "real", "head"), 4),
                            ("b1 image 4", 1, os.path.join(work, "real", "tail"), 1)):
        text, secs, launched = run_cli(dc, "cli", evaluate.main,
                                       eflags + ["--real-dir", src, "--batchsize", str(rb)],
                                       f"evaluate --real-dir {tag}")
        out["wall_s"][f"evaluate_real {tag}"] = secs
        real[tag] = last_json(text)
        want = {k: -(-n // rb) * v for k, v in SERVING_LAUNCHES.items()}
        check(real[tag]["images"] == n and launched == want,
              f"evaluate --real-dir {tag}: {real[tag]}, launches {launched} (want {want})")
    rel = lambda a, b: abs(a - b) / abs(b)
    for k, bound in (("psnr", 1e-3), ("si_rmse", 1e-3), ("emd", 5e-2)):
        grouped = (4 * real["b2 images 0-3"][k] + real["b1 image 4"][k]) / 5
        say("cli", f"--real-dir {k}: b2 {real['b2'][k]:.6g}, the same grouping unpadded "
            f"{grouped:.6g} (relative {rel(real['b2'][k], grouped):.3g}, bound {bound}); "
            f"b1 {real['b1'][k]:.6g} (relative {rel(real['b2'][k], real['b1'][k]):.3g})")
        check(rel(real["b2"][k], grouped) <= bound, f"real-dir padding leaks into {k}")
    out["evaluate_real"] = real

    # 6. Times of one synthetic eval step: DA 64x256 b32 and plain 32x128 b32.
    gen = torch.Generator("cuda").manual_seed(9)
    out["eval_step_ms"] = {
        f"DA {eh}x{ew} b{b}": time_eval_step(
            da_cfg, eval_work, torch.rand(b, eh, ew, 3, device="cuda", generator=gen) * 2,
            smi, f"DA {eh}x{ew} b{b}"),
        f"plain {h}x{w} b{b}": time_eval_step(
            Config(model=ModelConfig(im_height=h, im_width=w), data=DataConfig(batch_size=b)),
            plain_work, torch.rand(b, h, w, 3, device="cuda", generator=gen) * 2, smi,
            f"plain {h}x{w} b{b}")}
    say("cli", "CLI wall seconds (host clock, set-up included): "
        + ", ".join(f"{k} {v:.3f}" for k, v in out["wall_s"].items()) + f"; on {smi}")
    shutil.rmtree(work)


# The probes (K10-K12): the two shapes (x [b, h, w, c], F), the tools'
# default (the model's 64x256 DA-layer scale) and the serving trunk layer.
PROBE_SHAPES = [("default 64x256", (32, 64, 256, 64), 64),
                ("trunk 16x64", (32, 16, 64, 128), 128)]
# The exp_daconv variants the drive runs: every K10 instantiation (the pack
# and p=2 dedup variants only where p*c <= 128) and the tool's defaults.
PROBE_VARIANTS = ("prod,xla,a2,a4,a8,a2h,a2p,c2,c2h,c2p,cs2,cs2h,b2,b4,prodbf16,pairc,"
                  "pairs,noroll,nomm,mmonly,mmbf16,fullbf16,loadonly,load1only,mmhoist,"
                  "dd1,dd1m2")
PACK_VARIANTS = (",dd2,dd2m2,dd2k,pack2,pack2r,pack2k,pack2:mmonlyf,pack2:mmhoistf,"
                 "pack2:loadonlyf,pack2:load1onlyf,pack2:nommf,pack2:norollf,"
                 "pack2:fullbf16f,pack2:nomm,pack2:fullbf16")
MM_DEFAULTS = ("a18", "b9", "c3", "d2", "t18", "a18h", "b9h", "d2h")  # exp_mmshape's
MM_MORE = ("tb9", "c3h", "t18h", "tb9h")
PEAK_BF16_FLOPS = 989e12
# K10 against its plain version: the same sums in another order (f32 FMA,
# bf16 storage), or the tensor cores' accumulation order and bf16 ties of
# the samples; against the f32 DA conv: f32 storage and FMA, else bf16.
PROBE_TOL = {"fma": 1e-4, "mma": 2e-3, "conv_f32": 1e-4, "conv_bf16": 2e-2}
# exp_daconv variants on f32 storage and f32 dots (checked at 1e-4 of the
# max in the drive; the others at 2e-2)
F32_VARIANTS = ("prod", "xla", "a2", "a4", "a8", "a2p", "c2", "c2p", "cs2")


def fill_state(state, seed):
    """Every tensor of a port state drawn on the card from a seeded
    generator, nonzero and distinct: parameters N(0, 0.02), BatchNorm means
    N(0, 0.1) and variances U(0.5, 1.5), second moments U(0.5, 1.5) x
    10^U(-3, 3) per tensor and first moments U(-0.5, 0.5) x the root of the
    second (as `make_torch_golden.resume_export` draws them); a nonzero
    step, epoch and Adam count. A host draw at 64x256 takes ~42 s; this
    takes well under one."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for module in state.modules().values():
            for _, mod in module.named_modules():
                for coll, name, t, _, _ in getattr(mod, "flax_leaves", list)():
                    if coll == "params":
                        t.normal_(0.0, 0.02, generator=g)
                    elif name == "mean":
                        t.normal_(0.0, 0.1, generator=g)
                    else:
                        t.uniform_(0.5, 1.5, generator=g)
        for opt in state.optimizers().values():
            moments = opt.moments()
            for p, nu in moments["nu"].items():
                scale = 10.0 ** float(torch.empty((), device="cuda").uniform_(
                    -3.0, 3.0, generator=g))
                nu.uniform_(0.5, 1.5, generator=g).mul_(scale)
                if "mu" in moments:
                    moments["mu"][p].uniform_(-0.5, 0.5, generator=g).mul_(nu.sqrt())
    state.step, state.epoch = 40 + seed, 5
    if state.kind == "sun":
        state.opt.count = state.step
    return state


def state_bytes(state):
    from skyhdr_torch.train.engine import state_dict

    blob = state_dict(state)
    tensors = [t for sd in blob["modules"].values() for t in sd.values()]
    tensors += [t for o in blob["optimizers"].values() for v in o.values()
                if isinstance(v, list) for t in v]
    return sum(t.numel() * t.element_size() for t in tensors)


def blob_mismatches(blob, state):
    """The tensors and counters of a checkpoint's `state_dict` (read to the
    host) that are not bit-equal to `state`'s: (names, tensors compared)."""
    from skyhdr_torch.train.engine import state_dict

    want = state_dict(state)
    bad, n = [], 0
    for key in ("kind", "step", "epoch", "param_dtype"):
        if blob[key] != want[key]:
            bad.append(f"{key} {blob[key]} vs {want[key]}")
    for group in ("modules", "optimizers"):
        if sorted(blob[group]) != sorted(want[group]):
            bad.append(f"{group}: {sorted(blob[group])} vs {sorted(want[group])}")
            continue
        for name, part in want[group].items():
            for key, w in part.items():
                got = blob[group][name].get(key)
                pairs = list(zip(got, w)) if isinstance(w, list) else [(got, w)]
                if isinstance(w, list) and len(got) != len(w):
                    bad.append(f"{group}/{name}/{key}: {len(got)} vs {len(w)} tensors")
                for i, (a, b) in enumerate(pairs):
                    n += 1
                    same = (torch.equal(a.to(b.device), b) if torch.is_tensor(b)
                            else a == b)
                    if not same:
                        bad.append(f"{group}/{name}/{key}[{i}]")
    return bad, n


def serve_captured(dc, indir, outdir, workdir, h, w, batch):
    """The serving CLI from the checkpoints under `workdir`: its outputs
    (caught on their way to the .hdr encoder, which still writes them),
    wall seconds and launches (counts set to 0 just before it)."""
    from skyhdr_torch.cli import inference

    got, real = {}, inference.write_hdr

    def write(path, hdr):
        got[os.path.basename(path)] = hdr
        real(path, hdr)

    inference.write_hdr = write
    try:
        text, secs, launched = run_cli(dc, "convert", inference.main, [
            "--indir", indir, "--outdir", outdir, "--da-conv", "true", "--imheight", str(h),
            "--imwidth", str(w), "--batch", str(batch), "--workdir", workdir],
            f"inference CLI {h}x{w} DA b{batch} --workdir {os.path.basename(workdir)}")
    finally:
        inference.write_hdr = real
    return got, text, secs, launched


def serve_modules(cfg, gen_src, sun_src, indir, batch):
    """What the serving CLI computes, on fresh serving modules holding
    `gen_src`'s and `sun_src`'s tensors: the same groups, the last padded
    with its last image. {name.hdr: y_final_lin}."""
    from skyhdr_torch.cli import inference
    from skyhdr_torch.train.engine import build_models, make_inference_fn

    gen, sun = build_models(cfg, "cuda")
    gen.load_state_dict(gen_src.state_dict())
    sun.load_state_dict(sun_src.state_dict())
    infer = make_inference_fn(cfg)
    paths = sorted(os.path.join(indir, f) for f in os.listdir(indir))
    out = {}
    for start in range(0, len(paths), batch):
        group = paths[start:start + batch]
        imgs = [inference._imread01(p) for p in group]
        x = np.stack(imgs + [imgs[-1]] * (batch - len(group)))
        y = infer(gen, sun, torch.from_numpy(x).cuda())["y_final_lin"][:len(group)]
        for path, hdr in zip(group, y.float().cpu().numpy()):
            out[os.path.splitext(os.path.basename(path))[0] + ".hdr"] = hdr
    return out


def import_cli(dc, export, workdir, flags, tag):
    """The import CLI on the card; (wall s, {SKY/SUN: the CLI's own s})."""
    import re

    from skyhdr_torch.cli import import_checkpoint

    text, secs, launched = run_cli(dc, "convert", import_checkpoint.main,
                                   ["--export", export, "--workdir", workdir, *flags], tag)
    check(not any(launched.values()), f"the import launched kernels: {launched}")
    return secs, {name: (float(a), float(b), float(c)) for name, a, b, c in re.findall(
        r"^(SKY|SUN) checkpoint \d+ imported .* in ([\d.]+) s \(read onto \S+ ([\d.]+) s, "
        r"saved ([\d.]+) s\)$", text, re.M)}


def convert_golden(dc, work, report):
    """(a) The resume golden at 16x64 DA b2: the export of
    `make_torch_golden.resume_export`, imported by the CLI on the card, one
    GAN step and one sun step on the fixture's JAX-degraded inputs, held to
    JAX's metrics and update digests."""
    from skyhdr_torch.train.checkpoints import CheckpointManager
    from skyhdr_torch.utils.flax_export import write_export

    mod = golden_tool()
    stored = np.load(mod.RESUME_FIXTURE)
    export = mod.resume_export(int(stored["seed"]))
    digest = mod.export_digest(export)
    check(abs(digest - float(stored["export_digest"])) <= 1e-9 * digest,
          f"the resume export differs from the fixture's ({digest} vs "
          f"{float(stored['export_digest'])}): the numpy stream changed")
    out, pwork = os.path.join(work, "golden_export"), os.path.join(work, "golden_port")
    for name, (manifest, leaves) in export.items():
        write_export(os.path.join(out, name), manifest, leaves)
    cfg = mod.golden_config()
    import_cli(dc, out, pwork, ["--imheight", str(cfg.model.im_height), "--imwidth",
                                str(cfg.model.im_width), "--da-conv", "true"],
               "import CLI 16x64 (resume golden)")
    gan, sun = (CheckpointManager(os.path.join(pwork, "checkpoints", name)).restore_latest(
        cfg, "cuda") for name in ("SKY", "SUN"))
    check((gan.step, gan.epoch, sun.step, sun.epoch, sun.opt.count) == (12, 2, 7, 1, 7),
          "resume golden counters")
    reset_counts(dc)
    port = mod.port_steps(stored, cfg, gan, sun, "cuda")
    launched = counts(dc)
    fails, worst = mod.compare_train_golden(stored, port, GOLDEN_METRIC_RTOL,
                                            GOLDEN_UPDATE_RTOL)
    for kind in ("gan", "sun"):
        for metric, a, b in zip(stored[f"{kind}_metric_names"], port[f"{kind}_metrics"],
                                stored[f"{kind}_metrics"]):
            say("convert", f"resume golden {kind} {metric}: card {a:.7g}, JAX {b:.7g}")
    say("convert", f"resume golden 16x64 DA b2, one GAN step + one sun step from the "
        f"imported checkpoints vs JAX: worst relative {json.dumps(worst)} (metrics rtol "
        f"{GOLDEN_METRIC_RTOL}, updates {GOLDEN_UPDATE_RTOL} of sum |update|, BN sums "
        f"1e-4); launches {launched}")
    for line in fails:
        say("convert", f"FAIL {line}")
    check(not fails, f"resume golden: {len(fails)} mismatches")
    want = {k: GAN_LAUNCHES[k] + SUN_LAUNCHES[k] for k in KERNELS}
    check(launched == want, f"resume golden launches {launched}, want {want}")
    report["convert"]["golden_worst"] = worst


def convert_full_width(dc, smi, work, report):
    """(b) DA 64x256: a GanState and a SunState with every tensor drawn,
    exported by `export_from_state` and imported by the CLI one at a time
    (an export deleted once imported), checked bit-equal; served from the
    import and from the source modules; one resumed GAN step at b64 from
    each; a bfloat16-parameter SKY checkpoint served and refused a resume."""
    from skyhdr_torch.config import Config, DataConfig, ModelConfig
    from skyhdr_torch.data.degradation import make_banks
    from skyhdr_torch.models.vgg16 import random_vgg16_weights
    from skyhdr_torch.train.checkpoints import CheckpointManager
    from skyhdr_torch.train.convert import export_from_state
    from skyhdr_torch.train.engine import (empty_gan_state, empty_sun_state,
                                           make_gan_train_step, state_dict)
    from skyhdr_torch.train.loop import TrainLoop
    from skyhdr_torch.utils.flax_export import write_export
    from skyhdr_torch.utils.io import get_exposure_lists, make_synthetic_dorf

    h, w, b, serve_b = 64, 256, 64, 32
    cfg = Config(model=ModelConfig(im_height=h, im_width=w, use_da_conv=True),
                 data=DataConfig(batch_size=b))
    flags = ["--imheight", str(h), "--imwidth", str(w), "--da-conv", "true"]
    out = report["convert"]
    t0 = time.perf_counter()
    src = {"SKY": fill_state(empty_gan_state(cfg, "cuda"), 1),
           "SUN": fill_state(empty_sun_state(cfg, "cuda"), 2)}
    torch.cuda.synchronize()
    say("convert", f"DA {h}x{w}: a GanState and a SunState drawn on the card in "
        f"{time.perf_counter() - t0:.3f} s")
    pwork = os.path.join(work, "port")
    for name, state in src.items():
        export = os.path.join(work, f"export_{name}")
        gb = state_bytes(state) / 1e9
        t0 = time.perf_counter()
        manifest, leaves = export_from_state(state)
        t1 = time.perf_counter()
        write_export(os.path.join(export, name), manifest, leaves)
        t2 = time.perf_counter()
        del leaves
        wall, own = import_cli(dc, export, pwork, flags, f"import CLI {name} {h}x{w}")
        shutil.rmtree(export)
        t3 = time.perf_counter()
        blob = CheckpointManager(os.path.join(pwork, "checkpoints", name)).read_latest()
        t4 = time.perf_counter()
        bad, n = blob_mismatches(blob, state)
        del blob
        total, onto, saved = own[name]
        row = {"gb": gb, "export_from_state_s": t1 - t0, "write_export_s": t2 - t1,
               "import_cli_s": wall, "import_read_onto_card_s": onto, "import_save_s": saved,
               "read_back_s": t4 - t3, "tensors": n}
        out[name] = row
        say("convert", f"{name} DA {h}x{w} ({gb:.3f} GB): export_from_state {t1 - t0:.3f} s "
            f"(card to host, {gb / (t1 - t0):.3f} GB/s), write_export {t2 - t1:.3f} s "
            f"({gb / (t2 - t1):.3f} GB/s; no fsync); import CLI {wall:.3f} s wall "
            f"({gb / wall:.3f} GB/s): the export mapped and placed on the card {onto:.3f} s "
            f"({gb / onto:.3f} GB/s), torch.save with fsync {saved:.3f} s "
            f"({gb / saved:.3f} GB/s); read back {t4 - t3:.3f} s ({gb / (t4 - t3):.3f} "
            f"GB/s); {n} tensors and the counters bit-equal to the source: {not bad} "
            f"{bad[:5]}; on {smi}")
        check(not bad, f"{name} import not bit-equal: {bad[:10]}")

    # Serving from the imported checkpoints: SKY, then SUN's sun-pose net.
    indir = os.path.join(work, "ldr")
    write_pngs(indir, 40, h, w, seed=40)
    serve_cfg = Config(model=cfg.model, data=DataConfig(batch_size=serve_b))
    got, text, secs, launched = serve_captured(dc, indir, os.path.join(work, "hdr"), pwork,
                                               h, w, serve_b)
    dispatches = -(-40 // serve_b)
    want = {k: v * dispatches for k, v in SERVING_LAUNCHES.items()}
    check("Latest SKY checkpoint restored" in text and "Latest SUN checkpoint restored" in text,
          "serving did not restore the SKY and SUN checkpoints")
    check(launched == want, f"serving launches {launched}, want {want}")
    ref = serve_modules(serve_cfg, src["SKY"].gen, src["SUN"].sun, indir, serve_b)
    same = sorted(got) == sorted(ref) and all(np.array_equal(got[k], ref[k]) for k in ref)
    finite = all(np.isfinite(v).all() for v in got.values())
    say("convert", f"served {len(got)} panoramas at DA {h}x{w} b{serve_b} from the imported "
        f"checkpoints in {secs:.3f} s wall (restore included); launches {launched} (want "
        f"{want}); bit-equal to serving the source modules: {same}; finite: {finite}")
    check(same and finite, "serving from the import differs from the source modules")
    out["serve_s"] = secs
    del src["SUN"], ref
    free_cuda()

    # One resumed GAN step at b64 from the import and one from the source,
    # under torch's deterministic algorithms; then one more of each in the
    # default mode, which is not bitwise repeatable (cuDNN's algorithms, and
    # the atomic index_add_ of the resize's index_select backward).
    restored = CheckpointManager(os.path.join(pwork, "checkpoints", "SKY")).restore_latest(
        cfg, "cuda")
    banks = make_banks(make_synthetic_dorf(175, 1024), get_exposure_lists()[0], device="cuda")
    step = make_gan_train_step(cfg, banks, random_vgg16_weights())
    batch = train_batches(1, b, h, w, seed=3000)[0]
    resumed = {}
    # cuBLAS asks for this before it runs deterministically (checked per
    # call); restored below, so that later phases run as before.
    cublas_config = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    try:
        for mode in ("deterministic", "default"):
            # warn_only: an operation without a deterministic form warns (and
            # is named below) instead of raising.
            torch.use_deterministic_algorithms(mode == "deterministic", warn_only=True)
            metrics = {}
            for tag, state in (("imported", restored), ("source", src["SKY"])):
                reset_counts(dc)
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    _, m = step(state, batch, torch.Generator(device="cuda").manual_seed(9))
                    torch.cuda.synchronize()
                for text in sorted({str(c.message)[:160] for c in caught}):
                    say("convert", f"{mode} {tag} step warned: {text}")
                metrics[tag] = {k: float(v) for k, v in m.items()}
                launched = counts(dc)
                check(launched == GAN_LAUNCHES, f"resumed GAN step ({tag}) launches {launched}")
            bad, n = blob_mismatches(state_dict(restored), src["SKY"])
            gap = max((float((a - b_).detach().abs().max()) for a, b_ in zip(
                restored.gen.parameters(), src["SKY"].gen.parameters())), default=0.0)
            resumed[mode] = {"tensors_differing": len(bad), "tensors": n,
                             "gen_max_abs_diff": gap,
                             "metrics_equal": metrics["imported"] == metrics["source"]}
            say("convert", f"resumed GAN step at DA {h}x{w} b{b}, {mode} algorithms, from the "
                f"import and from the source: launches {GAN_LAUNCHES} each; gen_total "
                f"{metrics['imported']['gen_total']:.7g} vs {metrics['source']['gen_total']:.7g}; "
                f"{n - len(bad)} of {n} tensors and the counters bit-equal after it "
                f"{bad[:3]}; generator parameters max |diff| {gap:.3e}")
            if mode == "deterministic":
                check(not bad and metrics["imported"] == metrics["source"],
                      f"the resumed step differs: {bad[:10]}")
                # Both states stay equal for the default-mode step.
    finally:
        torch.use_deterministic_algorithms(False)
        if cublas_config is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
    out["resumed_step"] = resumed
    del restored, step
    free_cuda()

    # A SKY checkpoint trained with bfloat16 parameters: the stored values,
    # upcast; it serves, and a resume is refused.
    state = src.pop("SKY")
    with torch.no_grad():
        for module in state.modules().values():
            for p in module.parameters():
                p.copy_(p.bfloat16().float())
    state.param_dtype = "bfloat16"
    export, bf16_work = os.path.join(work, "export_bf16"), os.path.join(work, "port_bf16")
    manifest, leaves = export_from_state(state)
    check(manifest["param_dtype"] == "bfloat16" and not any(
        p.startswith("opt") for p in leaves), "bf16 export holds moments")
    write_export(os.path.join(export, "SKY"), manifest, leaves)
    del leaves
    wall, _ = import_cli(dc, export, bf16_work, flags, f"import CLI SKY bf16 params {h}x{w}")
    shutil.rmtree(export)
    blob = CheckpointManager(os.path.join(bf16_work, "checkpoints", "SKY")).read_latest()
    bad, n = blob_mismatches(blob, state)
    check(blob["param_dtype"] == "bfloat16" and blob["optimizers"] == {} and not bad,
          f"bf16 SKY checkpoint: {blob['param_dtype']}, {sorted(blob['optimizers'])}, {bad[:5]}")
    del blob
    got, text, secs, launched = serve_captured(dc, indir, os.path.join(work, "hdr_bf16"),
                                               bf16_work, h, w, serve_b)
    check(launched == want, f"bf16 serving launches {launched}, want {want}")
    ref = serve_modules(serve_cfg, state.gen, state.sun, indir, serve_b)
    same = sorted(got) == sorted(ref) and all(np.array_equal(got[k], ref[k]) for k in ref)
    refused = None
    try:
        TrainLoop(cfg, "SKY", lambda: None, None, None, None, None, workdir=bf16_work,
                  log=lambda *_: None, device="cuda")
    except NotImplementedError as e:
        refused = str(e)
    say("convert", f"bf16-parameter SKY checkpoint: {n} tensors bit-equal, no optimizer "
        f"state; served {len(got)} panoramas in {secs:.3f} s, launches {launched}, "
        f"bit-equal to its source modules: {same}; TrainLoop resume: "
        f"NotImplementedError {refused!r}")
    check(same, "bf16 serving differs from its source modules")
    check(refused is not None and "param_dtype" in refused, "TrainLoop resumed a bf16 state")
    del state
    free_cuda()


def phase_convert(dc, smi, report):
    work = tempfile.mkdtemp(prefix="skyhdr_convert_")
    report["convert"] = {"device": smi}
    try:
        say("convert", f"disk free under {work}: "
            f"{shutil.disk_usage(work).free / 1e9:.1f} GB")
        convert_golden(dc, work, report)
        convert_full_width(dc, smi, work, report)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def probe_bound(n, c, f, x_bytes, mma, summing, k_bytes=4):
    """(ms, "bytes" or "operations") of one DA probe call over n = b*h*w
    output pixels: operations 2*n*9*c*f (the products; the sum modes n*9*c
    adds) at the f32 CUDA-core or the bf16 tensor-core peak; bytes x, K
    and the f32 output, each once."""
    ops = n * 9 * c if summing else 2.0 * n * 9 * c * f
    t_ops = ops / (PEAK_BF16_FLOPS if mma else PEAK_F32_FLOPS)
    t_bytes = (n * c * x_bytes + 9 * c * f * k_bytes + n * f * 4) / PEAK_BYTES_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def probe_operands(shape, f):
    """x and K drawn as the probe tools draw them (numpy seed 0, K x 0.05)."""
    rng = np.random.default_rng(0)
    k = torch.from_numpy((rng.normal(size=(9 * shape[-1], f)) * 0.05).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return x.cuda(), k.cuda()


def drive_tool(main, argv, tag):
    """Runs a probe tool's entry point; returns its lines (none FAILED)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    lines = buf.getvalue().splitlines()
    for line in lines:
        say("probes", f"{tag} | {line}")
    check(lines and lines[0].startswith("# device: ") and "cpu" not in lines[0],
          f"{tag}: did not run on the card")
    check(not any("FAILED" in line for line in lines), f"{tag}: a variant failed")
    return lines[1:]


def parse_variant_lines(lines):
    """{name: (ms, rel err or None)} of exp_daconv's lines."""
    import re

    out = {}
    for line in lines:
        m = re.match(r"\s*(\S+): +([\d.]+) ms(?:.*\(rel ([\d.e+-]+)\))?", line)
        if m:
            out[m.group(1)] = (float(m.group(2)), float(m.group(3)) if m.group(3) else None)
    return out


def check_probes(tp, report):
    """Every K10 instantiation against its plain version and (the whole
    forward) the f32 DA conv at both shapes, K11 bitwise, K12 at every
    configuration of exp_mmshape in f32 and bf16. Returns the worst
    absolute errors."""
    from skyhdr_torch.ops.distortion import deformable_conv2d
    from skyhdr_torch.tools import exp_mmshape

    worst = {"K10": 0.0, "K11": 0.0, "K12": 0.0}
    rows = []
    for tag, shape, f in PROBE_SHAPES:
        x, k = probe_operands(shape, f)
        conv = deformable_conv2d(x, k, torch.zeros(f, device="cuda"))
        for name, p in tp.PROBES.items():
            got = tp.da_probe_k10(x, k, name)
            torch.cuda.synchronize()
            rel, ab = rel_err(got, tp.da_probe_ref(x, k, name))
            tol = PROBE_TOL["mma" if p.mma else "fma"]
            line = (f"K10 {name} {tag} x{list(shape)} F={f}: vs plain max rel err {rel:.3e} "
                    f"(max abs {ab:.3e}, tol {tol})")
            ok = rel <= tol and got.shape == conv.shape
            worst["K10"] = max(worst["K10"], ab)
            row = {"probe": name, "shape": list(shape), "f": f, "rel": rel, "abs": ab}
            if not p.diag:
                ctol = PROBE_TOL["conv_f32" if p.store == torch.float32 and not p.mma
                                 else "conv_bf16"]
                row["conv_rel"], _ = rel_err(got, conv)
                line += f"; vs the f32 DA conv {row['conv_rel']:.3e} (tol {ctol})"
                ok = ok and row["conv_rel"] <= ctol
            say("probes", line)
            check(ok, f"K10 {name} at {tag}")
            rows.append(row)
            del got
        got = tp.da_probe_k10(x, k, "dedup_bf16", rblk=4, mblk=4)
        rel, _ = rel_err(got, tp.da_probe_ref(x, k, "dedup_bf16"))
        say("probes", f"K10 dedup_bf16 rblk=mblk=4 {tag}: vs plain max rel err {rel:.3e}")
        check(rel <= PROBE_TOL["fma"], f"K10 dedup mblk=4 at {tag}")
        del x, k, conv, got
        free_cuda()
    gen = torch.Generator(device="cuda").manual_seed(5)
    for shape, p, dtype in (((32, 64, 256, 64), 2, torch.float32),
                            ((32, 64, 256, 64), 2, torch.bfloat16),
                            ((32, 16, 64, 128), 4, torch.float32)):
        x = torch.randn(shape, device="cuda", generator=gen).to(dtype)
        same = torch.equal(tp.pack_samples_k11(x, p), tp.pack_samples_ref(x, p))
        say("probes", f"K11 x{list(shape)} {str(dtype)[6:]} p={p}: bitwise equal to the "
            f"plain version: {same}")
        check(same, f"K11 {shape} p={p}")
    x600 = mm_input()
    # Every configuration, then shapes the wrapper pads (one block tile of
    # each kind, several output tiles a block) with one dot.
    cases = list(exp_mmshape.CFGS.items()) + [
        ("pad", (13, 7, 5, 1, 2)), ("pad", (300, 100, 70, 1, 3)), ("pad", (40, 600, 300, 1, 3))]
    for cfg, (m, kk, f, ndots, steps) in cases:
        for dtype in (torch.float32, torch.bfloat16):
            lhs, rhs = x600[:m, :kk].to(dtype).contiguous(), x600[:kk, :f].to(dtype).contiguous()
            got = tp.mm_shape_k12(lhs, rhs, ndots=ndots, steps=steps)
            rel, ab = rel_err(got, tp.mm_shape_ref(lhs, rhs, ndots=ndots, steps=1))
            worst["K12"] = max(worst["K12"], ab)
            tile = tp.MM_TILES[tp.mm_tiling(m, kk, f, dtype == torch.bfloat16)[3]]
            say("probes", f"K12 {cfg} {str(dtype)[6:]} ({m}x{kk}@{kk}x{f} x{ndots} x{steps}, "
                f"{tile[0]}x{tile[1]} block tile): max rel err {rel:.3e} (max abs {ab:.3e}, "
                f"tol 1e-5)")
            check(rel <= 1e-5 and got.shape == (m, f), f"K12 {cfg} {m}x{kk}x{f} {dtype}")
    report["checks"] = rows
    return worst


def k10_kernels_a_call(attempts=3):
    """{K10 name: {device kernel: count}} that one call of each
    instantiation on x in its storage type runs under torch.profiler, at
    the probes' default shape, in this process; and {name: traces that
    held no device event at all}. A trace without any device event says
    that the profiler lost the call's events (the call's output is checked
    before), not that it ran no kernel: such a trace is taken again, up to
    `attempts` traces."""
    from torch.profiler import ProfilerActivity, profile

    from skyhdr_torch.ops.kernels import probes as tp

    tag, shape, f = PROBE_SHAPES[0]
    x, k = probe_operands(shape, f)
    out, empty = {}, {}
    for name, p in tp.PROBES.items():
        xs = x.to(p.store)
        tp.da_probe_k10(xs, k, name)
        torch.cuda.synchronize()
        for _ in range(attempts):
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                tp.da_probe_k10(xs, k, name)
                torch.cuda.synchronize()
            seen = out[name] = {}
            for evt in prof.key_averages():
                t = getattr(evt, "self_device_time_total", None)
                if t is None:
                    t = getattr(evt, "self_cuda_time_total", 0.0)
                if t > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
                    seen[evt.key] = seen.get(evt.key, 0) + evt.count
            if seen:
                break
            empty[name] = empty.get(name, 0) + 1
        del xs
    return out, empty


def k10_one_kernel():
    """Each K10 instantiation runs one device kernel a call: counted by
    `k10_kernels_a_call` in a fresh process. (In this script's own process,
    after the earlier phases, the profiler has reported no device kernel
    for a K10 call at all on the H100; a fresh process, `--only probes`
    and the card tests see each call's one kernel, though a fresh process
    has also lost one call's device events once: hence the retake of an
    empty trace.)"""
    code = "import json, chip_smoke; print(json.dumps(chip_smoke.k10_kernels_a_call()))"
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=900)
    check(proc.returncode == 0, f"K10 profiler count failed: {proc.stderr[-2000:]}")
    seen, empty = json.loads(proc.stdout.strip().splitlines()[-1])
    for name, kernels in seen.items():
        check(sum(kernels.values()) == 1 and all("probe_" in key for key in kernels),
              f"K10 {name}: one call ran device kernels {kernels}, want one probe kernel "
              f"({empty.get(name, 0)} traces without any device event before)")
    say("probes", f"K10: each of the {len(seen)} instantiations ran one device kernel a call "
        f"under torch.profiler (a fresh process, x {list(PROBE_SHAPES[0][1])}); traces "
        f"taken again because they held no device event: {empty or 'none'}")
    return seen


def mm_input():
    """exp_mmshape's first input (numpy seed 0, 600x600)."""
    return torch.from_numpy(np.random.default_rng(0).normal(size=(600, 600))
                            .astype(np.float32)).cuda()


def drive_probes(tp, report):
    """The main path: the three tools through their entry points, the
    counts set to 0 just before and read just after. Returns the launches."""
    from skyhdr_torch.tools import exp_daconv, exp_mmshape, exp_pack

    for name in ("K10", "K11", "K12"):
        setattr(tp, f"{name}_LAUNCHES", 0)
    tp.K10_BY_PROBE.clear()
    tool = {}
    for tag, shape, f in PROBE_SHAPES:
        b, h, w, c = shape
        variants = PROBE_VARIANTS + (PACK_VARIANTS if 2 * c <= 128 else "")
        got = parse_variant_lines(drive_tool(exp_daconv.main, [
            "--b", str(b), "--h", str(h), "--w", str(w), "--c", str(c), "--f", str(f),
            "--iters", "8", "--variants", variants], f"exp_daconv {tag}"))
        want = set(variants.split(","))
        check(want == set(got), f"exp_daconv {tag}: lines missing or extra: "
              f"{sorted(want ^ set(got))}")
        for name, (_, rel) in got.items():
            tol = 1e-4 if name in F32_VARIANTS else 2e-2
            check(rel is None or rel <= tol, f"exp_daconv {tag} {name}: rel err {rel} > {tol}")
        tool[tag] = {"shape": list(shape), "f": f, "lines": got}
    drive_tool(exp_pack.main, ["--iters", "8"], "exp_pack")
    drive_tool(exp_mmshape.main, ["--iters", "8", "--variants",
                                  ",".join(MM_DEFAULTS + MM_MORE)], "exp_mmshape")
    launched = {"K10": tp.K10_LAUNCHES, "K11": tp.K11_LAUNCHES, "K12": tp.K12_LAUNCHES}
    by_probe = dict(tp.K10_BY_PROBE)
    say("probes", f"drive launches {launched}; K10 by instantiation {by_probe}")
    missing = sorted(set(tp.PROBES) - set(by_probe))
    check(not missing, f"the tools launched no K10 {missing}")
    check(launched["K11"] > 0 and launched["K12"] > 0, f"the tools launched {launched}")
    report.update(tool=tool, launches=launched, launches_by_probe=by_probe)
    free_cuda()
    return launched


# exp_daconv's default run: a2, a4, a8 (direct reads, f32) and b4 (nine
# taps staged, bf16 storage), one call each at the default shape.
K10_DEFAULT_RUN = (("a", 2), ("a", 4), ("a", 8), ("cs_bf16", 4))


def k10_timing(dc, tp, smi, plain=True):
    """K10 at both probe shapes: each instantiation at rblk 2 (at the
    default shape also the default run's other calls) on x in its storage
    type, and K1 on the f32 x, in device ms with work queued ahead (median
    of 20; with `plain`, in turns with the plain version, also queued).
    Returns ({(shape tag, name, rblk): row}, {shape tag: K1 ms})."""
    rows, k1s = {}, {}
    for tag, shape, f in PROBE_SHAPES:
        b, h, w, c = shape
        n = b * h * w
        x, k = probe_operands(shape, f)
        bias = torch.zeros(f, device="cuda")
        k1 = statistics.median(time_ms(lambda: dc.da_conv_forward_k1(x, k, bias), queued=True))
        k1s[tag] = k1
        k1_bound, _ = probe_bound(n, c, f, 4, False, False)
        say("probes", f"K1 {tag} x{list(shape)} F={f}: {k1:.4f} ms (queued), bound "
            f"{k1_bound:.4f} ms; on {smi}")
        runs = [(name, 2) for name in tp.PROBES]
        if tag == PROBE_SHAPES[0][0]:
            runs += [r for r in K10_DEFAULT_RUN if r[1] != 2]
        for name, rblk in runs:
            p = tp.PROBES[name]
            xs = x.to(p.store)

            def kernel():
                return tp.da_probe_k10(xs, k, name, rblk=rblk)

            if plain:
                ms, plain_ms = paired_ms(kernel, lambda: tp.da_probe_ref(xs, k, name), queued=True)
            else:
                ms, plain_ms = statistics.median(time_ms(kernel, queued=True)), None
            summing = p.diag in tp.SUM_MODES
            bms, by = probe_bound(n, c, f, xs.element_size(), p.mma, summing,
                                  2 if p.mma else 4)
            tfs = (n * 9 * c if summing else 2.0 * n * 9 * c * f) / ms / 1e9
            vs_plain = "" if plain_ms is None else f", plain {plain_ms:.4f} ms"
            say("probes", f"K10 {name} rblk={rblk} {tag}: {ms:.4f} ms ({tfs:.2f} TF/s){vs_plain}, "
                f"bound {bms:.4f} ms ({by}; {100 * bms / ms:.1f}% of it), {ms / k1:.3f}x K1's "
                f"{k1:.4f} ms; on {smi}")
            rows[tag, name, rblk] = {"probe": name, "rblk": rblk, "shape": list(shape), "f": f,
                                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                                     "bound_by": by, "tflops": tfs, "k1_ms": k1}
            del xs
        del x, k
        free_cuda()
    return rows, k1s


def time_probes(dc, tp, smi, report):
    """K10 as `k10_timing` does (with its plain version), and the default
    run also without work queued ahead (events around each call, which
    also count the wrappers' host time); K11 against its plain version and the library's
    copy; K12 at each configuration against its plain version and one
    batched matmul. Returns the JSON line's K10-K12 numbers (the tools'
    default runs)."""
    from skyhdr_torch.tools import exp_mmshape

    rows, _ = k10_timing(dc, tp, smi)
    report["k10"] = list(rows.values())
    tag, shape, f = PROBE_SHAPES[0]
    picks = [rows[tag, name, rblk] for name, rblk in K10_DEFAULT_RUN]
    x, k = probe_operands(shape, f)
    unqueued = 0.0
    for name, rblk in K10_DEFAULT_RUN:
        xs = x.to(tp.PROBES[name].store)
        unqueued += statistics.median(time_ms(lambda: tp.da_probe_k10(xs, k, name, rblk=rblk)))
        del xs
    del x, k
    free_cuda()
    out = {"K10": {"ms": sum(r["ms"] for r in picks),
                   "plain_ms": sum(r["plain_ms"] for r in picks),
                   "bound_ms": sum(r["bound_ms"] for r in picks), "library_ms": None,
                   "unqueued_ms": unqueued}}
    say("probes", f"K10 default run (a2 + a4 + a8 + b4): {out['K10']['ms']:.4f} ms queued, "
        f"{unqueued:.4f} ms unqueued (events around each call, the wrapper's host time "
        f"included), bound {out['K10']['bound_ms']:.4f} ms; on {smi}")

    x = torch.from_numpy(np.random.default_rng(0).normal(size=(32, 64, 256, 64))
                         .astype(np.float32)).cuda()
    ms, plain = paired_ms(lambda: tp.pack_samples_k11(x, 2), lambda: tp.pack_samples_ref(x, 2))
    lib = statistics.median(time_ms(lambda: tp.pack_samples_library(x, 2)))
    bms = 1e3 * 2 * x.numel() * 4 / PEAK_BYTES_S
    say("probes", f"K11 x[32, 64, 256, 64] f32 p=2: {ms:.4f} ms, plain {plain:.4f} ms, library "
        f"{lib:.4f} ms, bound {bms:.4f} ms (bytes; {100 * bms / ms:.1f}% of it); on {smi}")
    out["K11"] = {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": bms}
    del x
    free_cuda()
    x600 = mm_input()
    k12 = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    mm_rows = []
    for name in MM_DEFAULTS + MM_MORE:
        dtype = torch.bfloat16 if name.endswith("h") else torch.float32
        m, kk, f, ndots, steps = exp_mmshape.CFGS[name.rstrip("h")]
        lhs, rhs = x600[:m, :kk].to(dtype).contiguous(), x600[:kk, :f].to(dtype).contiguous()
        # Device times with work queued ahead: the bf16 kernels (~0.1 ms)
        # are shorter than the wrapper's host time.
        ms, plain = paired_ms(
            lambda: tp.mm_shape_k12(lhs, rhs, ndots=ndots, steps=steps),
            lambda: tp.mm_shape_ref(lhs, rhs, ndots=ndots, steps=steps), queued=True)
        lib = statistics.median(time_ms(lambda: tp.mm_shape_library(lhs, rhs, ndots=ndots,
                                                                    steps=steps), queued=True))
        free_cuda()
        flops = 2.0 * m * kk * f * ndots * steps
        bms = 1e3 * flops / (PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS)
        say("probes", f"K12 {name} ({m}x{kk}@{kk}x{f} x{ndots} x{steps}): {ms:.4f} ms "
            f"({flops / ms / 1e9:.2f} TF/s), plain {plain:.4f} ms, library {lib:.4f} ms, bound "
            f"{bms:.4f} ms ({100 * bms / ms:.1f}% of it); on {smi}")
        mm_rows.append({"name": name, "ms": ms, "plain_ms": plain, "library_ms": lib,
                        "bound_ms": bms})
        if name in MM_DEFAULTS:
            for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                           ("bound_ms", bms)):
                k12[key] += v
    report["k12"] = mm_rows
    out["K12"] = k12
    return out


def phase_probes(dc, smi, report):
    from skyhdr_torch.ops.kernels import probes as tp

    out = report["probes"] = {}
    worst = check_probes(tp, out)
    out["k10_device_kernels"] = k10_one_kernel()
    launched = drive_probes(tp, out)
    numbers = time_probes(dc, tp, smi, out)
    for kern, row in numbers.items():
        row.update(launches=launched[kern], max_abs_err=worst[kern])
    return numbers


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
    compile_s = {}
    for line in lib.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            say("build", line.strip())
        elif ": compiled in " in line:
            src, secs = line.split(": compiled in ")
            compile_s[os.path.basename(src)] = float(secs.split()[0])
    say("build", f"each source's own nvcc seconds, run side by side: {compile_s}; their sum "
        f"(the sources one after another) {sum(compile_s.values()):.3f} s, the parallel "
        f"build {build_s:.3f} s wall")
    report["build_s"] = build_s
    report["compile_s"] = compile_s

    def timed(name, fn, *a):
        if name not in phases:
            return None
        t = time.perf_counter()
        r = fn(*a)
        say(name, f"phase done in {time.perf_counter() - t:.1f} s")
        return r

    worst = timed("kernels", phase_kernels, dc, report)
    timed("golden", phase_golden, dc, report)
    timed("train_golden", phase_train_golden, dc, report)
    timed("serving", phase_serving, dc, report)
    launches = timed("training", phase_training, dc, smi, report)
    totals = timed("timing", phase_timing, dc, smi, report)
    da5_trees.cache_clear()
    timed("train_cli", phase_train_cli, dc, smi, report)
    timed("cli", phase_cli, dc, smi, report)
    timed("convert", phase_convert, dc, smi, report)
    probes = timed("probes", phase_probes, dc, smi, report)

    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    report["device"] = smi
    report["wall_s"] = time.perf_counter() - t_start
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.log"), "w") as f:
        f.write("\n".join(LOG) + "\n")
    say("done", f"{report['wall_s']:.1f} s wall")
    if phases != set(PHASES):
        return 0  # a subset proves nothing of the whole: no result line

    dc_src, in_src = "skyhdr_torch/csrc/deform_conv.cu", "skyhdr_torch/csrc/instnorm.cu"
    pallas = "skyhdr/ops/pallas/"
    # name, TPU kernel it replaces, the training run whose launches it reports
    about = {"K1": ("K1 da_fwd_kernel<T, 3, CH> (DA conv forward, k=3)",
                    pallas + "deform_conv.py:179", "gan"),
             "K2": ("K2 da_dx_kernel<3> (DA conv input gradient, k=3)",
                    pallas + "deform_conv.py:469", "gan"),
             "K3": ("K3 da_dk_kernel<T, 3, CH> (DA conv weight gradient, k=3)",
                    pallas + "deform_conv.py:429", "gan"),
             "K5": ("K5 da_fwd_kernel<T, 0, CH> (DA conv forward, odd k)",
                    pallas + "deform_conv.py:146", "gan_da5"),
             "K6": ("K6 da_dk_kernel<T, 0, CH> (DA conv weight gradient, odd k)",
                    pallas + "deform_conv.py:364", "gan_da5"),
             "K7": ("K7 da_dx_kernel<0> (DA conv input gradient, odd k)",
                    pallas + "deform_conv.py:400", "gan_da5"),
             "K8": ("K8 in_fwd (InstanceNorm + activation forward)",
                    pallas + "instnorm.py:104", "gan_fused"),
             "K9": ("K9 in_bwd (InstanceNorm + activation backward)",
                    pallas + "instnorm.py:123", "gan_fused")}
    per = {"gan": "", "gan_fused": " with fused_instance_norm",
           "gan_da5": " with da_kernel_size=5"}
    kernels = []
    for kern in KERNELS:
        name, replaces, run = about[kern]
        ms, plain, bms, t_ops, t_bytes = totals["gan", kern][:5]
        in_norm = kern in ("K8", "K9")
        kernels.append({
            "name": name, "route": "cuda", "source": in_src if in_norm else dc_src,
            "replaces": replaces, "launches": launches[run][kern],
            "max_abs_err": max(v for (k, res, _, dt), v in worst.items()
                               if k == kern and res == "64x256" and dt == "torch.float32"),
            "ms": ms, "plain_ms": plain, "bound_ms": bms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": totals["gan", kern][5] if in_norm else None,
            "per": f"one GAN train step at DA 64x256 b64 f32{per[run]} (launches: the 3 "
                   f"steps of the training phase{per[run]})",
        })
    probe_src = "skyhdr_torch/csrc/probes.cu"
    for kern, name, replaces, bound_by, per in (
            ("K10", "K10 probe_direct_kernel<T, VEC, FT> / probe_staged_kernel<T, TAPS, "
             "DEDUP, MMA, DIAG, CH> (DA forward probe variants)", "tools/exp_daconv.py:102",
             "operations",
             "one run of the probe at its default shape: one call each of exp_daconv's "
             "default variants a2, a4, a8 (direct reads, f32) and b4 (nine taps staged, "
             "bf16 storage) at x (32,64,256,64) -> F 64, device time with work queued "
             "ahead (the forward_a call site; the other variants' call sites "
             ":172/:272/:411/:440/:521/:604/:695 run the same kernels); launches: the "
             "probes phase's drive of the three tools"),
            ("K11", "K11 pack_samples_kernel (sample packing)", "tools/exp_pack.py:60",
             "bytes", "one run of the probe at its default shape: one pack of x "
             "(32,64,256,64) f32 with p=2; launches: the probes phase's drive"),
            ("K12", "K12 mm_shape_f32_kernel<BM> / mm_shape_bf16_kernel<WARPS_M, WTM, WTN> "
             "(dot-shape microbench)",
             "tools/exp_mmshape.py:44", "operations",
             "one run of the probe at its default shape: one call each of exp_mmshape's "
             "default configurations a18, b9, c3, d2, t18, a18h, b9h, d2h (1024 blocks "
             "each); launches: the probes phase's drive")):
        row = probes[kern]
        kernels.append({
            "name": name, "route": "cuda", "source": probe_src, "replaces": replaces,
            "launches": row["launches"], "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"], "bound_by": bound_by,
            "library_ms": row["library_ms"], "per": per})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
