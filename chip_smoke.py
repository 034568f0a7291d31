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
                    torch_golden_train_da5_16x64.npz. Then under
                    compute_dtype=bfloat16, unfused and fused: the GAN and
                    sun eval steps and one GAN step and one sun step against
                    JAX's bf16 steps (Pallas path) in
                    torch_golden_train_bf16_16x64.npz: metrics, per-leaf
                    gradient digests and BatchNorm sums, each within its
                    class's largest JAX bf16-vs-f32 gap, and their median
                    gap under half the own gap; the eval steps' and the
                    train steps' launches asserted apart. Then the layers
                    that run in bf16 there (the sun-pose net with K1-K3,
                    and K8/K9 when fused; SunRadNet) layer by layer
                    against the same port on the CPU, each from the same
                    input and cotangent: within one bf16 ulp. Then the
                    knob golden: one GAN step and one sun step at 16x64 DA
                    b2 f32 compute from the resume golden's states under
                    each storage-knob configuration (a float32 control,
                    bf16 moments, bf16 gradients, bf16 parameters with a
                    float32 master, all three), unfused and fused, against
                    torch_golden_train_knobs_16x64.npz: metrics, update
                    digests, every leaf's dtype, parameters equal to their
                    master rounded, bf16 samples bit-equal on >= 99%. Then
                    the plain-conv goldens (`skyhdr`'s default convs): one
                    GAN step and one sun step at 16x64 b2 in f32 against
                    torch_golden_train_plain_16x64.npz, unfused and fused
                    (the DA goldens' tolerances), and under bf16 compute
                    the eval steps and the train steps against
                    torch_golden_train_plain_bf16_16x64.npz, each quantity
                    reported against the card's bounds (out of resolution
                    there: the nets amplify one-ulp differences), and the
                    bf16 layers (generator, sun-pose net, SunRadNet, VGG16)
                    each within one ulp of the CPU port; no DA kernel.
  6. serving      — the inference CLI at 64x256 b32 (40 PNGs, 2 dispatches,
                    the second padded; from a SKY checkpoint of the seeded
                    k=3 weights, drawn once for serving, training and cli)
                    and at 32x128 b1 (4 PNGs, its seeded fallback); every .hdr
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
                    InstanceNorm (the same weights); under
                    compute_dtype=bfloat16 the GAN step for 3, unfused and
                    fused (the same draw), and the sun step for 3 (the sun
                    state's weights); under the storage knobs at f32
                    compute the GAN step with bf16 moments and with bf16
                    parameters (f32 master), and the sun step with bf16
                    moments; "bf16 everything" (bf16 compute and the three
                    knobs) the GAN step fused and the sun step, 3 steps
                    each, every stored leaf's dtype checked and the
                    parameters their master rounded; every metric finite,
                    gen_total moving, launch counts per step asserted (GAN:
                    20 K1, 24 K2, 20 K3, and fused 25 K8, 29 K9; k=5: 12 K5,
                    12 K6, 12 K7 and no K1-K3; sun: 4 each, and fused 6 K8,
                    6 K9). Then step times (CUDA
                    events, 1 warm-up, median of 5 further steps of the same
                    state) and peak device memory, and each bf16 row's
                    ratio to its f32 row, as each knob row's.
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
                    `TrainLoop("SUN", ...)` handed to a fresh SKY run; then
                    at plain 32x128 b32 with --compute-dtype bfloat16 (no DA
                    kernel): one epoch with its eval pass and a float32
                    checkpoint, and a resume to epoch 2, its epoch seconds;
                    then "bf16 everything" at DA 32x128 b32 (bf16 compute,
                    moments, gradients and parameters): the float32 SUN
                    checkpoint handed to a fresh run at lr 0 (its
                    checkpoint shows the master refreshed), a resume to
                    epoch 2, its epoch seconds and checkpoint bytes.
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
                    32x128 (`CONVERT_SIZE`): a GanState and a SunState
                    with every tensor drawn on the card, written by
                    `export_from_state` + `write_export` and imported by the
                    CLI, one at a time; every tensor and counter read back
                    bit-equal; the inference CLI (40 PNGs, b32) from the
                    imports bit-equal to serving the source modules, 20 K1 +
                    4 K2 per dispatch; one resumed GAN step at b32 from the
                    import and from the source bit-equal under torch's
                    deterministic algorithms (and, for the record, how far
                    apart in the default mode); a SKY checkpoint with
                    bfloat16 parameters (its float32 master and moments
                    exported too) served bit-equal to its source modules,
                    refused by a float32 run (ValueError), and resumed one
                    GAN step at b64 bit-equal to its source under
                    deterministic algorithms; a SUN checkpoint with
                    bfloat16 moments imported and resumed the same way.
                    Export, import and read-back seconds and GB/s.
  12. parallel   — data parallelism (`skyhdr_torch.parallel`): the seeded
                    DA 32x128 state drawn once and written for the ranks;
                    two gloo ranks on the one card, 16 samples each, one GAN
                    step and one sun step of `make_parallel_*_train_step`
                    against the single-process b32 steps from the same
                    weights and degradation key (the train golden's
                    tolerances), K1-K3 counted on each rank (20/24/20 a GAN
                    step, 4/4/4 a sun step), the ranks bit-equal after;
                    each rank's step ms, the gloo collectives' share of it
                    and its peak memory; then NCCL at world size 1 under
                    deterministic algorithms, its steps bit-equal to the
                    single-process steps. A failed or hung rank fails it.
  13. fsdp       — ZeRO-3 sharded training (`skyhdr_torch.parallel.fsdp`,
                    min_bytes 1 MiB) on the parallel phase's DA 32x128
                    state and b32 batch: two gloo ranks, 16 samples each,
                    one GAN step and one sun step of `make_fsdp_*` (sharded,
                    stepped, unsharded) against the single-process b32 steps
                    (the train golden's tolerances), K1-K3 counted on each
                    rank (20/24/20, 4/4/4), the ranks' unsharded states
                    bit-equal; each step's ms, collectives' share, peak and
                    at-rest bytes per rank; two GAN and two sun steps bit-equal
                    to the DP steps under deterministic algorithms; a DA
                    64x256 GanState and SunState filled on the card and
                    sharded, each rank's at-rest bytes (and the allocator's)
                    against the replicated state's; then NCCL at world size
                    1, its FSDP steps bit-equal to the single-process steps.
  14. spatial    — the width ring (`skyhdr_torch.parallel.spatial`) on
                    rings of 2 and 4 gloo ranks and NCCL at world size 1,
                    all on the one card: `ring_deformable_conv2d` at each distinct
                    DA layer shape at 64x256 b8 (halo plan and force_gather,
                    k=3 through K1 and the k=5 trunk through K5, the trunk
                    in bf16 too), one K1/K5 launch a call on each rank, each
                    block against its plain version (1e-4 f32, 2e-2 bf16)
                    and checked bit for bit against K1/K5 on the whole
                    panorama (recorded); `ring_conv2d` (cyclic and zero
                    seams) against `F.conv2d` on the padded whole panorama;
                    then K1/K5 on one 1/4 width shard at each shape at b32
                    timed beside its plain version and the whole panorama.
  15. width_step — the width-sharded GAN step (`shard_width=True`) at DA
                    32x128 b32: two gloo ranks on a (1, 2) mesh and four on
                    a (2, 2) FSDP mesh at once, against the single b32 step
                    (the train golden's tolerances), K1/K2/K3 20/24/20 a
                    rank, the ranks bit-equal, the ring K2/K3 (K7/K6 at the
                    k=5 trunk) on each rank's shard against their plain
                    versions and the whole panorama's kernels, each rank's
                    step ms, collectives' share and activation peak against
                    the single step's (below WIDTH_PEAK_RATIO); NCCL at
                    world size 1: `shard_width` on a width-1 mesh bit-equal
                    (the data-parallel step, as `skyhdr`'s) and the width
                    context on a ring of one (`ring_of_one`) against the
                    single step; the ring K2/K3/K6/K7 timed on a 1/2 shard.
  16. probes     — the DA-conv probe tools (skyhdr_torch/tools/) and their
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
  17. library    — the op-library helpers that no step calls, on the card
                    against the port's own CPU results on the same inputs
                    (f32, 1e-5 of the max; TF32 off): rgb2gray and the
                    channel flips (bitwise), positional_encoding, vmf_pdf
                    with a precomputed table, gaussian_filter2d in its three
                    paddings, dog_pyramid (value and gradient),
                    dog_l1_loss_conv (and against dog_l1_loss), instance_moments,
                    conv, avgpool2 at an odd size, FC2D / DFC2D with their
                    weights carried through `utils.transplant` both ways,
                    cast_floating on a module's state_dict and inverse_rf;
                    a stride-1 DAConv at conv2_f's shape (32x128 b32)
                    launches K1 once and meets the plain DA conv, a stride
                    of 2 raises; the synthetic-sky writer
                    (`skyhdr_torch.tools.make_synth_dataset`) writes a set
                    that the pipeline reads back equal to its draws.
  18. draws      — `--seed`'s draws (`skyhdr_torch/utils/jax_random.py`,
                    JAX's threefry stream and Flax's parameter keys) on the
                    card: the entry points' DA 16x64 draw
                    (`create_gan_state` / `create_sun_state` seed 0 and the
                    degradation draws of the loop's first key) against
                    `skyhdr`'s in tests/fixtures/torch_golden_draws_16x64.npz
                    (`make_torch_golden.compare_draws`: indices and
                    uniform-drawn leaves exact, normals within 4 ulps, sums
                    within 1e-6); the DA 64x256 GAN and SUN states' draw
                    timed (host clock, synchronised), each finite; the
                    degradation draw of one GAN step (b64) and one sun step
                    (b32) at 64x256 timed (CUDA events, median of 20).
  19. optim      — K13, the optimizer update as one pass (csrc/optim.cu),
                    at the DA 64x256 states drawn from seed 0: the SUN
                    state's Adam and the GAN state's two RMSprops, each
                    beside a copy stepped by the eager chain
                    (`step_plain`), three steps of seeded gradients of
                    10^U(-4, 2) magnitudes: every parameter and moment
                    bit-equal (the largest gap printed), one launch a leaf;
                    then each update alone timed three ways (CUDA events,
                    in turns): K13, the eager chain and, on the Adam
                    leaves, `torch.optim.Adam(fused=True)` as a yardstick
                    (its rounding differs; the port never calls it), beside
                    the bytes bound. The training phase asserts one K13
                    launch a leaf in every step it drives.
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
# Steps timed on each gloo rank of the parallel, fsdp and width_step phases
# (host clock: the ranks share the card and the host).
RANK_ITERS = 3
PHASES = ("kernels", "golden", "train_golden", "serving", "training", "timing",
          "train_cli", "cli", "convert", "parallel", "fsdp", "spatial", "width_step", "probes",
          "library", "draws", "optim")
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


@functools.lru_cache(maxsize=1)
def k3_trees():
    """The seeded k=3 DA 64x256 weights (gen, sun, disc trees, seed 0),
    drawn once on the host for the serving, training and cli phases
    (released after the cli phase): `init_gan_vars`, whose first two trees
    are `init_model_vars`'."""
    from skyhdr_torch.config import Config, ModelConfig
    from skyhdr_torch.utils.transplant import init_gan_vars

    t0 = time.perf_counter()
    trees = init_gan_vars(Config(model=ModelConfig(im_height=64, im_width=256,
                                                   use_da_conv=True)), 0)
    say("k3", f"k=3 DA 64x256: seeded weights drawn on the host in "
        f"{time.perf_counter() - t0:.3f} s (one draw for serving, training and cli)")
    return trees


def serving_checkpoint(workdir, cfg, trees):
    """<workdir>/checkpoints/SKY/1/state.pt holding the serving modules of
    `cfg` filled from `trees` (gen, sun): what the CLIs restore as "Latest
    SKY checkpoint"."""
    from skyhdr_torch.train.engine import build_models
    from skyhdr_torch.utils.transplant import load_model_vars

    gen, sun = build_models(cfg, "cpu")
    load_model_vars(gen, trees[0])
    load_model_vars(sun, trees[1])
    path = os.path.join(workdir, "checkpoints", "SKY", "1")
    os.makedirs(path)
    torch.save({"kind": "gan", "step": 0, "epoch": 1,
                "modules": {"gen": gen.state_dict(), "sun": sun.state_dict()},
                "optimizers": {}}, os.path.join(path, "state.pt"))


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
    train_golden_bf16(dc, mod, report)
    train_golden_knobs(dc, mod, report)
    train_golden_plain(dc, mod, report)


def train_golden_plain(dc, mod, report):
    """The plain-conv train goldens (`use_da_conv=False`, `skyhdr`'s
    default): one GAN step and one sun step at 16x64 b2 from the seeded
    weights on the fixtures' JAX-degraded inputs, in float32 against
    tests/fixtures/torch_golden_train_plain_16x64.npz (unfused and fused
    IN, the DA goldens' tolerances), and under compute_dtype=bfloat16 the
    eval steps and the train steps against
    torch_golden_train_plain_bf16_16x64.npz (`compare_train_golden_bf16`
    with resolved=False, the GAN-step quantities at their class bound,
    `PLAIN_BF16_AMPLIFIED`), reported: on the card they are out of the
    golden's resolution; the gate is `bf16_layers` with plain convs, every
    bf16 layer within one ulp of the CPU port. Every quantity's gap and
    the layer rows go to chiprun_out/plain_bf16_golden.json. No DA kernel
    runs; K8/K9 under fused IN."""
    from skyhdr_torch.utils.transplant import init_gan_vars, tree_digest

    stored = np.load(mod.PLAIN_TRAIN_FIXTURE)
    gv, sv, dv = init_gan_vars(mod.golden_config(use_da_conv=False), int(stored["seed"]))
    digest = tree_digest({"gen": gv, "sun": sv, "disc": dv})
    check(abs(digest - float(stored["weights_digest"])) <= 1e-9 * digest,
          f"seeded plain GAN weights differ from the fixture's ({digest} vs "
          f"{float(stored['weights_digest'])})")
    for fuse in (False, True):
        name = "plain " + ("fused IN" if fuse else "unfused IN")
        want = launches(**({k: FUSED_IN["gan"][k] + FUSED_IN["sun"][k] for k in ("K8", "K9")}
                           if fuse else {}))
        reset_counts(dc)
        port = mod.port_train_golden(stored, "cuda", fused_instance_norm=fuse, use_da_conv=False)
        launched = counts(dc)
        fails, worst = mod.compare_train_golden(stored, port, GOLDEN_METRIC_RTOL,
                                                GOLDEN_UPDATE_RTOL)
        say("train_golden", f"16x64 b2 GAN step + sun step, {name}, vs JAX: worst relative "
            f"{json.dumps(worst)} (metrics rtol {GOLDEN_METRIC_RTOL}, updates "
            f"{GOLDEN_UPDATE_RTOL} of sum |update|, BN sums 1e-4); launches {launched}")
        for line in fails:
            say("train_golden", f"FAIL {name}: {line}")
        check(not fails, f"train golden ({name}): {len(fails)} mismatches")
        check(launched == want, f"train golden ({name}) launches {launched}, want {want}")
        report[f"train_golden_plain{'_fused' if fuse else ''}_worst"] = worst
    stored = np.load(mod.PLAIN_BF16_TRAIN_FIXTURE)
    cfg = mod.bf16_config(use_da_conv=False)
    state, sun_state = mod.bf16_states(stored, cfg, "cuda")
    reset_counts(dc)
    port = mod.port_eval_bf16(stored, cfg, state, sun_state, "cuda")
    port.update(mod.port_steps(stored, cfg, state, sun_state, "cuda"))
    launched = counts(dc)
    # Reported, not gated: on the card every quantity is out of this
    # golden's resolution (the sun-pose net amplifies the card's one-ulp
    # layer differences, and the bf16 generator amplifies any);
    # the card's gate is the layer check below, each bf16 layer within one
    # ulp of the CPU port, which the CPU tests hold to `skyhdr` per quantity.
    fails, worst = mod.compare_train_golden_bf16(stored, port, resolved=False,
                                                 amplified=mod.PLAIN_BF16_AMPLIFIED)
    cpu_fails, _ = mod.compare_train_golden_bf16(stored, port, amplified=mod.PLAIN_BF16_AMPLIFIED)
    for kind in ("gan", "sun", "gan_eval", "sun_eval"):
        for metric, a, b in zip(stored[f"{kind}_metric_names"], port[f"{kind}_metrics"],
                                stored[f"{kind}_metrics"]):
            say("train_golden", f"plain bf16 {kind} {metric}: card {a:.7g}, JAX {b:.7g} "
                f"(relative {abs(a - b) / abs(b):.3e})")
    say("train_golden", f"16x64 b2 plain bf16 eval steps + GAN step + sun step vs JAX: worst "
        f"relative gap per class and as a share of its tolerance (each class's largest JAX "
        f"gap, the GAN step's its own and perturbed gaps x{mod.PLAIN_BF16_SPREAD}), median "
        f"gap / own gap of the sun steps {json.dumps(worst)}; {len(cpu_fails)} quantities "
        f"outside the CPU's per-quantity tolerances: "
        f"{[line.split(':')[0] for line in cpu_fails]}; launches {launched}")
    for line in fails:
        say("train_golden", f"plain bf16 outside the card bounds (reported): {line}")
    report["train_golden_plain_bf16_worst"] = dict(worst, resolved_misses=len(cpu_fails),
                                                   card_misses=len(fails))
    report["train_golden_plain_bf16_gaps"] = mod.bf16_gaps(stored, port)
    del state, sun_state
    tables = bf16_layers(mod, stored, False, use_da_conv=False)
    for net, rows in tables.items():
        for row in rows:
            if row[5] > 0:
                say("train_golden", f"plain bf16 layers card vs CPU {net}.{row[0]} {row[1]} "
                    f"({row[2]}, {row[4]} elements): share {row[5]:.3e}, gap {row[6]:.3e} "
                    f"{row[3]}")
        layer_rows = [r for r in rows if r[0] != "net"]
        say("train_golden", f"plain bf16 layers card vs CPU {net}: {len(layer_rows)} tensors, "
            f"{sum(r[5] > 0 for r in layer_rows)} differ; the whole run's loss "
            f"{next(r[6] for r in rows if r[:2] == ('net', 'loss')):.3e} relative")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "plain_bf16_golden.json"), "w") as f:
        json.dump({"gaps": report["train_golden_plain_bf16_gaps"], "layers": tables}, f)
    check_bf16_layers(tables, "plain bf16")
    check(launched == launches(), f"train golden (plain bf16) launches {launched}")


def train_golden_knobs(dc, mod, report):
    """The knob golden: one GAN step and one sun step at 16x64 DA b2 f32
    compute from the resume golden's states under each storage-knob
    configuration (`make_torch_golden.KNOB_CONFIGS`: a float32 control,
    bf16 moments, bf16 gradients, bf16 parameters with a float32 master,
    all three), unfused and fused IN, against `skyhdr`'s in
    tests/fixtures/torch_golden_train_knobs_16x64.npz
    (`compare_knobs_golden`: metrics, update digests, BatchNorm sums,
    every leaf's dtype, parameters == round(master), bf16 samples bit-equal
    on >= 99% and within one ulp, float32 samples within KNOB_STEP_RTOL of
    their leaf's step or KNOB_MOMENT_RTOL of their value)."""
    stored = dict(np.load(mod.KNOBS_FIXTURE))
    check(abs(mod.export_digest(mod.resume_export(0)) - float(stored["export_digest"]))
          <= 1e-12 * float(stored["export_digest"]), "the resume export differs from the "
          "knob fixture's")
    worst_all, failed = {}, []
    for fuse in (False, True):
        want = ({k: fused(GAN_LAUNCHES, "gan")[k] + fused(SUN_LAUNCHES, "sun")[k]
                 for k in KERNELS} if fuse else
                {k: GAN_LAUNCHES[k] + SUN_LAUNCHES[k] for k in KERNELS})
        step_rtol, moment_rtol, share = (KNOB_CARD_FUSED_RTOL if fuse else
                                         (mod.KNOB_STEP_RTOL, mod.KNOB_MOMENT_RTOL, 0.99))
        for c in mod.KNOB_CONFIGS:
            name = f"{c} {'fused' if fuse else 'unfused'} IN"
            reset_counts(dc)
            port = mod.port_knob_steps(c, "cuda", fused_instance_norm=fuse)
            launched = counts(dc)
            fails, worst = mod.compare_knobs_golden(stored, port, c, step_rtol, moment_rtol,
                                                    share)
            say("train_golden", f"knobs {name}: 16x64 DA b2 GAN step + sun step from the "
                f"resume states vs skyhdr: worst {json.dumps(worst)} (float32 samples: "
                f"{step_rtol} of a leaf's step, {moment_rtol} of a moment; bf16 samples "
                f">= {share} bit-equal); launches {launched}")
            for line in fails:
                say("train_golden", f"FAIL knobs {name}: {line}")
            if fails:
                failed.append(f"knob golden ({name}): {len(fails)} mismatches")
            if launched != want:
                failed.append(f"knob golden ({name}) launches {launched}, want {want}")
            worst_all[name] = worst
            del port
    check(not failed, "; ".join(failed))
    report["train_golden_knobs_worst"] = worst_all


def train_golden_bf16(dc, mod, report):
    """The bf16 train golden: the GAN and sun eval steps, then one GAN step
    and one sun step under compute_dtype=bfloat16 at 16x64 DA b2, against
    `skyhdr`'s bf16 steps (Pallas path) in
    tests/fixtures/torch_golden_train_bf16_16x64.npz, unfused and fused IN:
    metrics, per-leaf gradient digests and BatchNorm sums at the card's
    tolerances (`make_torch_golden.compare_train_golden_bf16` with
    resolved=False); and the layers that run in bf16 there held layer by
    layer against the same port on the CPU (`bf16_layers`)."""
    from skyhdr_torch.utils.transplant import init_gan_vars, tree_digest

    stored = np.load(mod.BF16_TRAIN_FIXTURE)
    gv, sv, dv = init_gan_vars(mod.bf16_config(), int(stored["seed"]))
    digest = tree_digest({"gen": gv, "sun": sv, "disc": dv})
    check(abs(digest - float(stored["weights_digest"])) <= 1e-9 * digest,
          f"seeded GAN weights differ from the bf16 fixture's ({digest} vs "
          f"{float(stored['weights_digest'])})")
    eval_want = {k: SERVING_LAUNCHES[k] + SUN_EVAL_LAUNCHES[k] for k in KERNELS}
    # The sun eval step's pull starts at sunlayer1's output, so it crosses
    # the 4 norms of sunlayer2-3 (K9) after the sun-pose forward's 6 (K8).
    fused_eval = {k: fused(SERVING_LAUNCHES, "serving")[k]
                  + dict(SUN_EVAL_LAUNCHES, K8=N_IN_SUN, K9=N_IN_PULL)[k] for k in KERNELS}
    for fuse, key in ((False, "train_golden_bf16_worst"), (True, "train_golden_bf16_fused_worst")):
        name = "bf16 k=3 " + ("fused IN" if fuse else "unfused IN")
        cfg = mod.bf16_config(fuse)
        state, sun_state = mod.bf16_states(stored, cfg, "cuda")
        reset_counts(dc)
        port = mod.port_eval_bf16(stored, cfg, state, sun_state, "cuda")
        eval_launched = counts(dc)
        reset_counts(dc)
        port.update(mod.port_steps(stored, cfg, state, sun_state, "cuda"))
        launched = counts(dc)
        fails, worst = mod.compare_train_golden_bf16(stored, port, resolved=False)
        for kind in ("gan", "sun", "gan_eval", "sun_eval"):
            for metric, a, b in zip(stored[f"{kind}_metric_names"], port[f"{kind}_metrics"],
                                    stored[f"{kind}_metrics"]):
                say("train_golden", f"{name} {kind} {metric}: card {a:.7g}, JAX {b:.7g} "
                    f"(relative {abs(a - b) / abs(b):.3e})")
        say("train_golden", f"16x64 DA b2 bf16 eval steps + GAN step + sun step, {name}, vs "
            f"JAX: worst relative gap per class and as a share of its tolerance (each "
            f"class's largest JAX bf16-vs-f32 gap), median gap / own gap "
            f"{json.dumps(worst)}; launches: eval {eval_launched}, train {launched}")
        resolved = mod.compare_train_golden_bf16(stored, port)
        say("train_golden", f"{name}: {len(resolved[0])} of the quantities outside the CPU's "
            f"per-quantity tolerances (half their JAX bf16-vs-f32 gap): "
            f"{[line.split(':')[0] for line in resolved[0]]}")
        for line in fails:
            say("train_golden", f"FAIL {line}")
        want_eval = fused_eval if fuse else eval_want
        want = {k: (fused(GAN_LAUNCHES, "gan")[k] + fused(SUN_LAUNCHES, "sun")[k]) if fuse
                else GAN_LAUNCHES[k] + SUN_LAUNCHES[k] for k in KERNELS}
        check(not fails, f"train golden ({name}): {len(fails)} mismatches")
        check(eval_launched == want_eval,
              f"train golden ({name}) eval launches {eval_launched}, want {want_eval}")
        check(launched == want, f"train golden ({name}) launches {launched}, want {want}")
        del state, sun_state
        reset_counts(dc)
        tables = bf16_layers(mod, stored, fuse)
        layer_launched = counts(dc)
        for net, rows in tables.items():
            for row in rows:
                if row[5] > 0:
                    say("train_golden", f"{name} layers card vs CPU {net}.{row[0]} {row[1]} "
                        f"({row[2]}, {row[4]} elements): share {row[5]:.3e}, gap {row[6]:.3e} "
                        f"{row[3]}")
            layer_rows = [r for r in rows if r[0] != "net"]
            say("train_golden", f"{name} layers card vs CPU {net}: {len(layer_rows)} tensors "
                f"of {len({r[0] for r in layer_rows})} layers, {sum(r[5] > 0 for r in layer_rows)} "
                f"differ; largest {max(r[6] for r in layer_rows if r[3] == 'ulps'):.3e} ulps, "
                f"{max([r[6] for r in layer_rows if r[3] == 'rel'] or [0.0]):.3e} relative; the "
                f"whole run's loss {next(r[6] for r in rows if r[:2] == ('net', 'loss')):.3e} "
                f"relative (each device from the input alone)")
        check_bf16_layers(tables, name)
        for kern in ("K1", "K2", "K3") + (("K8", "K9") if fuse else ()):
            check(layer_launched[kern] > 0, f"bf16 layers ({name}) launched no {kern}")
        report[key] = dict(worst, resolved_misses=len(resolved[0]), layers={
            net: {"largest_ulps": max(r[6] for r in rows if r[0] != "net" and r[3] == "ulps"),
                  "net_loss": next(r[6] for r in rows if r[:2] == ("net", "loss"))}
            for net, rows in tables.items()})


def bf16_gap(got, want):
    """(share of elements that differ, largest difference in bf16 ulps of
    the wanted element): one ulp is at most 2^-7 of a value, and 1e-6 of the
    tensor's largest |value| is added for the elements near zero."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    d = (got - want).abs()
    ulp = want.abs() * 2.0 ** -7 + 1e-6 * want.abs().max()
    return float((d > 0).float().mean()), float((d / ulp).max())


def compare_layer_tensors(want, got):
    """("ulps" or "rel", elements, share that differ, gap) of `got` against
    `want`: in bf16 ulps (`bf16_gap`) where `want` holds bf16 numbers, else
    relative to its largest |value|."""
    want, got = want.detach().cpu(), got.detach().cpu()
    if torch.equal(want.float(), want.float().bfloat16().float()):
        return ("ulps", want.numel(), *bf16_gap(got, want))
    return ("rel", want.numel(), float((got != want).float().mean()), rel_err(got, want)[0])


def layers_across_devices(nets, run):
    """Each leaf layer of `nets` (one module on each of two devices, the
    same weights) held between the devices on the same input: `run(net,
    device)` drives a net to a scalar loss; a run on the first device
    records each leaf layer's input, keyword arguments and output
    cotangent, then each layer runs alone on both devices from the recorded
    input and cotangent. Rows (layer, tensor, dtype on each device, share of
    elements that differ, gap): in bf16 ulps (`bf16_gap`) where the first
    device's values are bf16 numbers, else relative to its largest |value|.
    Each row: (layer, tensor, "dtype/dtype", "ulps" or "rel", elements,
    share, gap). Then rows of layer "net": the whole run's loss and parameter gradients,
    each device driven from the input alone (so one device's rounding
    differences reach the later layers)."""
    devices = [next(net.parameters()).device.type for net in nets]
    leaves = [n for n, m in nets[0].named_modules()
              if n and not any(True for _ in m.children())]
    record = {}

    def keep(name):
        def hook(module, args, kwargs, out):
            record[name] = [[a.detach() if torch.is_tensor(a) else a for a in args], kwargs]
            out.register_hook(lambda g: record[name].append(g.detach()))
        return hook

    modules = dict(nets[0].named_modules())
    handles = [modules[n].register_forward_hook(keep(n), with_kwargs=True) for n in leaves]
    whole = []
    for net, dev in zip(nets, devices):
        loss = run(net, dev)
        loss.backward()
        whole.append((loss.detach(), {n: p.grad for n, p in net.named_parameters()}))
        for h in handles:
            h.remove()
        handles = []

    rows = []
    for name in leaves:
        if len(record.get(name, ())) != 3:
            continue  # a layer that did not run, or whose output took no gradient
        args, kwargs, g = record[name]
        outs = []
        for net, dev in zip(nets, devices):
            layer = dict(net.named_modules())[name]
            ins = [a.to(dev).requires_grad_(a.is_floating_point()) if torch.is_tensor(a) else a
                   for a in args]
            y = layer(*ins, **kwargs)
            grads = torch.autograd.grad(y, ins[:1] + list(layer.parameters()), g.to(dev))
            outs.append([("y", y), ("dx", grads[0])]
                        + [(f"d{n}", t) for (n, _), t in zip(layer.named_parameters(), grads[1:])])
        for (tname, a), (_, b) in zip(*outs):
            dtypes = "/".join(str(t.dtype).replace("torch.", "") for t in (a, b))
            rows.append((name, tname, dtypes, *compare_layer_tensors(a, b)))
    (l0, g0), (l1, g1) = whole
    rows.append(("net", "loss", "float32/float32", "rel", 1, float(l1.cpu() != l0.cpu()),
                 abs(float(l1) - float(l0)) / abs(float(l0))))
    rows += [("net", f"d{n}", "float32/float32", *compare_layer_tensors(g0[n], g1[n]))
             for n in g0 if g0[n] is not None]
    return rows


def bf16_layers(mod, stored, fuse, devices=("cpu", "cuda"), use_da_conv=True):
    """`layers_across_devices` for the layers that run in bf16 in the bf16
    train golden's steps (16x64 DA b2, its seeded weights, its degraded LDR
    input): the sun-pose net under the sun step's KL loss (sunlayer2-3 are
    DA convs: K1, K2, K3; with `fuse`, K8/K9), SunRadNet in training mode
    on the CPU's Grad-CAM maps and sun-pose prediction, under the sum of
    the means of its three outputs, and VGG16's seven convs under the
    perceptual loss of the LDR input against the target clipped to [0, 1]
    (`vgg_layers_across_devices`). With plain convs (`use_da_conv=False`,
    the plain bf16 golden's) the sun-pose net has no DA conv, and the
    generator's encoder and sky decoder, which then run in bf16, are held
    too under the mean of the sky prediction. {net: rows}."""
    from skyhdr_torch.models.gradcam import sunpose_with_cams
    from skyhdr_torch.models.layers import compute_dtype
    from skyhdr_torch.ops.resize import resize_bilinear
    from skyhdr_torch.train.losses import kl_divergence

    cfg = mod.bf16_config(fuse, use_da_conv)
    seed = int(stored["seed"])
    ports = [build_port(cfg, seed, dev) for dev in devices]
    x = torch.from_numpy(np.array(stored["ldr"]))
    gt = torch.from_numpy(np.array(stored["sunpose_gt"]))
    out = {"sunpose": layers_across_devices(
        [sun.requires_grad_(True) for _, sun, _ in ports],
        lambda net, dev: kl_divergence(gt.to(dev), net(x.to(dev))[0]))}
    if not use_da_conv:
        out["generator"] = layers_across_devices(
            [gen.requires_grad_(True) for gen, _, _ in ports],
            lambda net, dev: net.sky_decode(net.encode(x.to(dev)), x.to(dev)).float().mean())
    # SunRadNet's inputs as `Generator.sun_rad_estimation` builds them.
    h, w = cfg.model.im_height, cfg.model.im_width
    sm, (cam1, cam2, cam3) = sunpose_with_cams(ports[0][1], x, compute_dtype(cfg.model))
    pred = sm.reshape(-1, h, w, 1)
    feats = torch.cat([x, cam1, resize_bilinear(cam2, (h, w)),
                       resize_bilinear(cam3, (h, w))], dim=-1).detach()
    normed = (pred / torch.max(pred)).detach()

    def sunrad(net, dev):
        return sum(t.float().mean() for t in net(normed.to(dev), feats.to(dev), True))

    out["sunrad"] = layers_across_devices(
        [gen.sun.train().requires_grad_(True) for gen, _, _ in ports], sunrad)
    hdr = torch.from_numpy(np.array(stored["hdr_t"])).clamp(0.0, 1.0)
    out["vgg16"] = vgg_layers_across_devices(x, hdr, devices)
    return out


def vgg_layers_across_devices(pred, target, devices):
    """VGG16's layers (`models.vgg16.vgg16_layer`) in bf16 held between two
    devices as `layers_across_devices` holds a module's: a run on the first
    device records each layer's input and output cotangent under the
    perceptual loss of `pred` against `target` ([b,h,w,3] in [0,1]); then
    each layer runs alone on both devices. Rows as there; the "net" row is
    `perceptual_l1` on each device."""
    from skyhdr_torch.models.vgg16 import (_LAYERS, _POOL_AFTER, perceptual_l1,
                                           random_vgg16_weights, vgg16_features,
                                           vgg16_input, vgg16_layer, vgg_constants)

    consts = [vgg_constants(random_vgg16_weights(), dev) for dev in devices]
    bf16 = torch.bfloat16
    want = iter([t.permute(0, 3, 1, 2) for t in vgg16_features(consts[0], target, bf16)])
    acts = [vgg16_input(pred, bf16).requires_grad_()]
    loss = 0.0
    for name, _, _ in _LAYERS:
        acts.append(vgg16_layer(consts[0], name, acts[-1]))
        if name in _POOL_AFTER:
            loss = loss + torch.mean(torch.abs(acts[-1] - next(want)).float())
    cots = torch.autograd.grad(loss, acts)
    rows = []
    for (name, _, _), x, cot in zip(_LAYERS, acts, cots[1:]):
        outs = []
        for c, dev in zip(consts, devices):
            xd = x.detach().to(dev).requires_grad_()
            y = vgg16_layer(c, name, xd)
            outs.append((y, torch.autograd.grad(y, xd, cot.to(dev))[0]))
        for tname, a, b in (("y", outs[0][0], outs[1][0]), ("dx", outs[0][1], outs[1][1])):
            dtypes = "/".join(str(t.dtype).replace("torch.", "") for t in (a, b))
            rows.append((name, tname, dtypes, *compare_layer_tensors(a, b)))
    l0, l1 = (float(perceptual_l1(c, pred.to(dev), target.to(dev), bf16))
              for c, dev in zip(consts, devices))
    rows.append(("net", "loss", "float32/float32", "rel", 1, float(l0 != l1),
                 abs(l1 - l0) / abs(l0)))
    return rows


def feeds_norm(layer):
    """The InstanceNorm a conv layer's output goes into, by name
    (`conv<s>` -> `norm<s>`, a resize-deconv's `conv<s>.conv` likewise), or
    None."""
    parts = layer.split(".")
    if len(parts) > 1 and parts[-1] == "conv":
        parts = parts[:-1]
    if not parts[-1].startswith("conv"):
        return None
    return ".".join(parts[:-1] + ["norm" + parts[-1][4:]])


def check_bf16_layers(tables, tag):
    """Every layer row of `bf16_layers` (not the "net" rows, which show how
    far one device's one-ulp differences carry and are reported only): the
    same dtype on both devices; bf16 numbers within one ulp, in at most an
    eighth of the elements (or one element: a float32 sum on the other
    side of a rounding boundary); other values (float32 sums of bf16
    products, summed in other orders) within 1e-4 of the largest |value|.
    A conv's bias gradient where the conv feeds an InstanceNorm is skipped
    (exactly zero: float noise on both devices).
    SunRadNet's BatchNorms' bf16 numbers are held to the share alone: in
    training mode they normalise by the variance of 2x(2x8 .. 4x16)
    values, E[x^2] - E[x]^2 in float32 (as `skyhdr`), whose cancellation
    carries float32 sum-order noise past a bf16 ulp in a few elements (an
    H100: one of 16384 by 4.2 ulps). A layer that kept a float32 operand
    where the other rounds it to bf16 differs in a large share of its
    elements."""
    for net, rows in tables.items():
        layers = {row[0] for row in rows}
        for layer, tensor, dtypes, measure, n, share, gap in rows:
            if layer == "net" or (tensor == "dbias" and feeds_norm(layer) in layers):
                continue  # an InstanceNorm cancels the bias: its gradient is float noise
            d0, d1 = dtypes.split("/")
            few = share <= max(0.125, 1.0 / n)
            if measure == "rel":
                ok = d0 == d1 and gap <= 1e-4
            elif net == "sunrad" and layer.endswith(".bn"):
                ok = d0 == d1 and few
            else:
                ok = d0 == d1 and few and gap <= 1.0
            check(ok, f"bf16 layers ({tag}) {net}.{layer} {tensor} ({dtypes}): {n} "
                  f"elements, share {share:.3e}, gap {gap:.3e} {measure}")


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


def serve(dc, work, tag, h, w, n, batch, workdir=None):
    """The inference CLI on n PNGs at DA h x w, `batch` a dispatch: its
    seeded weights, or with `workdir` the SKY checkpoint there."""
    from skyhdr_torch.cli import inference
    from skyhdr_torch.utils.io import read_hdr

    indir, outdir = os.path.join(work, tag, "ldr"), os.path.join(work, tag, "hdr")
    write_pngs(indir, n, h, w, seed=n)
    dispatches = -(-n // batch)
    reset_counts(dc)
    t0 = time.perf_counter()
    inference.main(["--indir", indir, "--outdir", outdir, "--da-conv", "true",
                    "--imheight", str(h), "--imwidth", str(w),
                    "--batch", str(batch), "--device", "cuda"]
                   + ([] if workdir is None else ["--workdir", workdir]))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = counts(dc)
    want = {k: v * dispatches for k, v in SERVING_LAUNCHES.items()}
    want["K3"] = 0
    say("serving", f"CLI {h}x{w} DA b{batch}: {n} images, {dispatches} dispatches, "
        f"{secs:.3f} s wall (weights {'restored' if workdir else 'drawn'} and loaded "
        f"included); launches {got} "
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
    # The serving path: the CLI at the DA model's full width, 64x256, b32,
    # from a SKY checkpoint of the shared seeded draw (`k3_trees`); its
    # seeded fallback at 32x128 b1.
    from skyhdr_torch.config import Config, ModelConfig

    sky = os.path.join(work, "sky_64x256")
    serving_checkpoint(sky, Config(model=ModelConfig(im_height=64, im_width=256,
                                                     use_da_conv=True)), k3_trees())
    report["serving_launches"] = serve(dc, work, "64x256_b32", 64, 256, 40, 32, sky)
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
    """Threads `state` through one step per batch, each with its key split
    off as the loop splits them; asserts each step's launches and finite
    metrics. Returns (state, per-step metrics, total
    launches); counts are set to 0 just before the first step."""
    from skyhdr_torch.utils import jax_random

    from skyhdr_torch.ops.kernels import optim as ok

    key = jax_random.key(1)
    history = []
    leaves = sum(len(o.params) for o in state.optimizers().values())
    reset_counts(dc)
    ok.K13_LAUNCHES = 0
    for i, batch in enumerate(batches):
        before, k13 = counts(dc), ok.K13_LAUNCHES
        t0 = time.perf_counter()
        key, sub = jax_random.split(key)
        state, metrics = step(state, batch, sub)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = {k: v - before[k] for k, v in counts(dc).items()}
        m = {k: float(v) for k, v in metrics.items()}
        say("training", f"{tag} step {i}: {secs:.3f} s wall; launches {launched}, K13 "
            f"{ok.K13_LAUNCHES - k13}; " + ", ".join(f"{k} {v:.6g}" for k, v in sorted(m.items())))
        check(launched == want, f"{tag} step {i} launches {launched}, want {want}")
        check(ok.K13_LAUNCHES - k13 == leaves,
              f"{tag} step {i}: {ok.K13_LAUNCHES - k13} K13 launches for {leaves} leaves")
        check(all(math.isfinite(v) for v in m.values()), f"{tag} step {i} metric not finite")
        history.append(m)
    if moving:
        vals = [m[moving] for m in history]
        check(all(a != b for a, b in zip(vals, vals[1:])), f"{tag} {moving} did not move: {vals}")
    return state, history, {**counts(dc), "K13": ok.K13_LAUNCHES}


def phase_training(dc, smi, report):
    from skyhdr_torch.config import Config, DataConfig, ModelConfig
    from skyhdr_torch.config import TrainConfig
    from skyhdr_torch.data.degradation import draw_degradation, make_banks
    from skyhdr_torch.models.vgg16 import random_vgg16_weights
    from skyhdr_torch.train.engine import (create_sun_state, empty_gan_state, empty_sun_state,
                                           load_weights, make_gan_train_step,
                                           make_sun_train_step)
    from skyhdr_torch.utils import jax_random
    from skyhdr_torch.utils.io import get_exposure_lists, make_synthetic_dorf

    h, w = 64, 256
    banks = make_banks(make_synthetic_dorf(175, 1024), get_exposure_lists()[0], device="cuda")

    def cfg_of(b, fuse=False, dtype="float32", knobs=KNOBS_F32):
        opt, grad, param = knobs
        return Config(model=ModelConfig(im_height=h, im_width=w, use_da_conv=True,
                                        fused_instance_norm=fuse, compute_dtype=dtype),
                      data=DataConfig(batch_size=b),
                      train=TrainConfig(opt_state_dtype=opt, grad_dtype=grad, param_dtype=param))

    trees = k3_trees()  # one draw for every k=3 GAN state
    out = {}
    bf16 = ("bfloat16",) * 3
    # (kind, batch, steps, fused IN, compute dtype, (opt_state, grad, param)
    # dtypes, the row of the same step in float32 that it is compared with)
    runs = (("gan", 64, 3, False, "float32", KNOBS_F32, None),
            ("gan_fused", 64, 3, True, "float32", KNOBS_F32, None),
            ("gan_bf16", 64, 3, False, "bfloat16", KNOBS_F32, "gan"),
            ("gan_bf16_fused", 64, 3, True, "bfloat16", KNOBS_F32, "gan_fused"),
            ("gan_opt", 64, 3, False, "float32", KNOBS_OPT, "gan"),
            ("gan_param", 64, 3, False, "float32", KNOBS_PARAM, "gan"),
            ("gan_bf16_all", 64, 3, True, "bfloat16", bf16, "gan_fused"),
            ("gan_da5", 64, 3, False, "float32", KNOBS_F32, None),
            ("sun", 32, 2, False, "float32", KNOBS_F32, None),
            ("sun_fused", 32, 2, True, "float32", KNOBS_F32, None),
            ("sun_bf16", 32, 3, False, "bfloat16", KNOBS_F32, "sun"),
            ("sun_opt", 32, 3, False, "float32", KNOBS_OPT, "sun"),
            ("sun_bf16_all", 32, 3, False, "bfloat16", bf16, "sun"))
    sun_weights = None  # the sun state's initial weights, on the host
    draw_ms = {}  # batch -> the degradation draw's ms in a step of that batch
    for kind, b, nsteps, fuse, dtype, knobs, f32_row in runs:
        tag = (f"{'GAN' if kind.startswith('gan') else 'sun'} DA "
               + ("k=5 " if kind == "gan_da5" else "") + f"{h}x{w} b{b}"
               + (" bf16" if dtype == "bfloat16" else "") + (" fused IN" if fuse else "")
               + knob_tag(knobs))
        t0 = time.perf_counter()
        if kind.startswith("gan"):
            cfg = da5_config(b) if kind == "gan_da5" else cfg_of(b, fuse, dtype, knobs)
            state = empty_gan_state(cfg, "cuda")
            load_weights(state, da5_trees() if kind == "gan_da5" else trees)
            step = make_gan_train_step(cfg, banks, random_vgg16_weights())
            base = DA5_GAN_LAUNCHES if kind == "gan_da5" else GAN_LAUNCHES
            want = fused(base, "gan") if fuse else base
            moving = "gen_total"
        else:
            trees = None
            cfg = cfg_of(b, fuse, dtype, knobs)
            if kind == "sun":
                state = create_sun_state(cfg, 0, "cuda")
                # The other sun states take the same weights (no second
                # draw), kept on the host so that one state at a time holds
                # device memory.
                sun_weights = {k: v.cpu() for k, v in state.sun.state_dict().items()}
            else:
                state = empty_sun_state(cfg, "cuda")
                load_sun_weights(state, sun_weights)
            step = make_sun_train_step(cfg, banks)
            want = fused(SUN_LAUNCHES, "sun") if fuse else SUN_LAUNCHES
            moving = "sun_total"
        torch.cuda.synchronize()
        say("training", f"{tag}: state built in {time.perf_counter() - t0:.3f} s")
        batches = train_batches(nsteps, b, h, w, seed=2000)
        state, history, launched = run_steps(dc, step, state, batches, want, tag, moving)
        stored = check_knob_state(state, knobs, tag)
        torch.cuda.reset_peak_memory_stats()
        key = jax_random.key(2)
        times = time_ms(lambda: step(state, batches[0], key), iters=STEP_ITERS, warmup=1)
        peak = torch.cuda.max_memory_allocated()
        ms = statistics.median(times)
        if b not in draw_ms:
            draw_ms[b] = statistics.median(time_ms(
                lambda: draw_degradation(key, (b, h, w, 3), banks), iters=STEP_ITERS, warmup=1))
        say("training", f"{tag}: step {ms:.4f} ms (median of {STEP_ITERS}, CUDA events, "
            f"spread {min(times):.4f}-{max(times):.4f}), of which the degradation draw "
            f"{draw_ms[b]:.4f} ms; peak device memory "
            f"{peak / 2**30:.3f} GiB; state {stored}; on {smi}")
        out[kind] = {"batch": b, "launches": launched, "history": history,
                     "step_ms": ms, "step_ms_all": times, "draw_ms": draw_ms[b],
                     "peak_bytes": peak,
                     "compute_dtype": dtype, "fused_instance_norm": fuse,
                     "knobs": dict(zip(("opt_state_dtype", "grad_dtype", "param_dtype"), knobs)),
                     "state_bytes": state_bytes(state)}
        if f32_row is not None:
            a, c = out[f32_row], out[kind]
            c["vs_f32_row"] = {"row": f32_row, "step_ms_ratio": c["step_ms"] / a["step_ms"],
                               "peak_ratio": c["peak_bytes"] / a["peak_bytes"]}
            say("training", f"{tag} vs {f32_row}: step {c['step_ms']:.4f} vs "
                f"{a['step_ms']:.4f} ms (ratio {c['step_ms'] / a['step_ms']:.4f}), peak "
                f"{c['peak_bytes'] / 2**30:.3f} vs {a['peak_bytes'] / 2**30:.3f} GiB (ratio "
                f"{c['peak_bytes'] / a['peak_bytes']:.4f}), state "
                f"{c['state_bytes'] / 1e9:.3f} vs {a['state_bytes'] / 1e9:.3f} GB; on {smi}")
        del state, step, batches
        free_cuda()
    for name, u, f in (("GAN DA 64x256 b64", out["gan"], out["gan_fused"]),
                       ("sun DA 64x256 b32", out["sun"], out["sun_fused"])):
        say("training", f"{name} fused vs unfused IN: step {f['step_ms']:.4f} vs "
            f"{u['step_ms']:.4f} ms ({f['step_ms'] - u['step_ms']:+.4f} ms), peak "
            f"{f['peak_bytes'] / 2**30:.3f} vs {u['peak_bytes'] / 2**30:.3f} GiB; on {smi}")
    report["training"] = out
    return {kind: o["launches"] for kind, o in out.items()}


# The knob golden on the card with fused InstanceNorm: K8/K9 sum in
# another order than the CPU, so the float32 control's GAN gradients sit
# further from `skyhdr`'s (update digests 4.1e-3 against the CPU's 6.0e-4)
# and the samples' gaps grow with them: 0.054 of a leaf's step and 8.2e-3
# of a moment in float32 (held at about 4 times that), and 98.5% of the
# bf16 parameters bit-equal under bf16 parameters, every one within one ulp
# or the float32 bound (held at 97%). The unfused card run passes the
# CPU's tolerances.
KNOB_CARD_FUSED_RTOL = (0.25, 0.04, 0.97)
KNOBS_F32 = ("float32", "float32", "float32")
KNOBS_OPT = ("bfloat16", "float32", "float32")
KNOBS_PARAM = ("float32", "float32", "bfloat16")


def knob_tag(knobs) -> str:
    """" opt bf16" etc.: the storage knobs at bfloat16, for a row's name."""
    names = [n for n, v in zip(("opt", "grad", "param"), knobs) if v == "bfloat16"]
    return "" if not names else (" " + "+".join(names) + " bf16")


def load_sun_weights(state, weights):
    """A sun-pose state_dict into a SunState: the parameters (rounded to
    their stored dtype) and, under bfloat16 parameters, the master."""
    state.sun.load_state_dict(weights)
    if state.opt.master is not None:
        master = state.opt.moments()["master"]
        with torch.no_grad():
            for name, p in state.sun.named_parameters():
                master[p].copy_(weights[name])


def check_knob_state(state, knobs, tag) -> str:
    """Checks every stored leaf's dtype under `knobs` (opt_state, grad,
    param): the parameters in param_dtype, the BatchNorm statistics
    float32, the moments in opt_state_dtype, a float32 master exactly when
    the parameters are bfloat16, and each parameter its master rounded.
    Returns a summary."""
    want_m, _, want_p = (getattr(torch, k) for k in knobs)
    params = {p.dtype for m in state.modules().values() for p in m.parameters()}
    buffers = {b.dtype for m in state.modules().values() for b in m.buffers()}
    moments, master, rounded = set(), set(), True
    for opt in state.optimizers().values():
        moments |= {t.dtype for name in opt.MOMENTS for t in getattr(opt, name)}
        if opt.master is not None:
            master |= {t.dtype for t in opt.master}
            rounded &= all(torch.equal(p, m.to(p.dtype)) for p, m in zip(opt.params, opt.master))
    check(params == {want_p} and buffers <= {torch.float32} and moments == {want_m},
          f"{tag}: params {params}, buffers {buffers}, moments {moments}")
    check(master == ({torch.float32} if want_p == torch.bfloat16 else set()),
          f"{tag}: master {master}")
    check(rounded, f"{tag}: a stored parameter is not its master rounded")
    short = lambda ds: "/".join(sorted(str(d).replace("torch.", "") for d in ds)) or "none"
    return (f"params {short(params)}, moments {short(moments)}, master {short(master)}"
            + (", params == round(master)" if master else ""))


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
    """One HDR sky dome and its sun row, drawn by the port's copy of
    `tools/make_synth_dataset.py`."""
    from skyhdr_torch.tools.make_synth_dataset import synth_panorama as draw

    return draw(rng, h, w)


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
    from skyhdr_torch.train.engine import (build_models, create_sun_state, make_sun_eval_step,
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

    def run(workdir, *extra, flags=base, da=True):
        buf = io.StringIO()
        reset_counts(dc)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            train.main(flags + ["--workdir", workdir, *extra])
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
        if da:
            check(launched["K1"] > 0 and launched["K3"] > 0, "the CLI ran no DA kernel")
        else:
            check(not any(launched.values()), f"the plain-conv CLI launched {launched}")
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

    # bf16 compute at plain 32x128 b32 (cuDNN bf16 convolutions, no DA
    # kernel): one epoch with its eval pass and checkpoint, then a resume.
    bf16 = os.path.join(work, "bf16")
    flags = list(base)
    flags[flags.index("--da-conv") + 1] = "false"
    flags += ["--compute-dtype", "bfloat16"]
    _, epochs = run(bf16, "--epochs", "1", flags=flags, da=False)
    bf16_ckpt = CheckpointManager(os.path.join(bf16, "checkpoints", "SKY"))
    check(epochs == [1] and bf16_ckpt.steps() == [1],
          f"bf16: 1 epoch, 1 checkpoint: ran {epochs}, saved {bf16_ckpt.steps()}")
    blob = bf16_ckpt.read_latest()
    check(all(v.dtype == torch.float32 for m in blob["modules"].values() for v in m.values()),
          "bf16 compute: the checkpoint holds float32 tensors")
    text, epochs = run(bf16, "--epochs", "2", flags=flags, da=False)
    check("Latest SKY checkpoint restored (epoch 1)" in text and epochs == [2]
          and bf16_ckpt.steps() == [1, 2], f"bf16 resume: ran {epochs}, saved "
          f"{bf16_ckpt.steps()}")

    # "bf16 everything" at DA 32x128 b32: the float32 SUN checkpoint above
    # handed to a fresh run at lr 0 (its first epoch's updates are zero, so
    # its checkpoint shows the sun-pose weights it started from: rounded,
    # with the float32 master equal to the SUN checkpoint's, which a stale
    # master would revert), then a resume to epoch 2 at the default lr.
    knobs = os.path.join(work, "knobs")
    flags = base + ["--compute-dtype", "bfloat16", "--opt-state-dtype", "bfloat16",
                    "--grad-dtype", "bfloat16", "--param-dtype", "bfloat16"]
    sun_dir = os.path.join(handoff, "checkpoints", "SUN")
    text, epochs = run(knobs, "--epochs", "1", "--lr", "0", "--sun", sun_dir, flags=flags)
    knob_ckpt = CheckpointManager(os.path.join(knobs, "checkpoints", "SKY"))
    blob = knob_ckpt.read_latest()
    # opt_gen's master runs over the generator's parameters, then the
    # sun-pose net's, in module order.
    gen_net, sun_net = build_models(cfg, "meta")
    n_gen = len(list(gen_net.parameters()))
    names = [n for n, _ in sun_net.named_parameters()]
    sun_master = blob["optimizers"]["opt_gen"]["master"][n_gen:n_gen + len(names)]
    want = sun_ckpt["modules"]["sun"]
    handed = all(torch.equal(m.cpu(), want[n].cpu()) and torch.equal(
        blob["modules"]["sun"][n].cpu(), want[n].cpu().to(torch.bfloat16))
        for n, m in zip(names, sun_master))
    say("train_cli", f"bf16 everything: SUN hand-off into bf16 parameters, {len(names)} "
        f"sun-pose tensors stored as the SUN checkpoint's rounded, master its float32 "
        f"values: {handed}")
    check("Pretrained SUN checkpoint restored for fine-tuning" in text and epochs == [1]
          and handed, "bf16-everything hand-off")
    dtypes = {k: {t.dtype for t in ts} for k, ts in (
        ("params", [v for m in blob["modules"].values() for k, v in m.items()
                    if not k.endswith(("mean", "var"))]),
        ("stats", [v for m in blob["modules"].values() for k, v in m.items()
                   if k.endswith(("mean", "var"))]),
        ("moments", [t for o in blob["optimizers"].values() for t in o["nu"]]),
        ("master", [t for o in blob["optimizers"].values() for t in o["master"]]))}
    check(dtypes == {"params": {torch.bfloat16}, "stats": {torch.float32},
                     "moments": {torch.bfloat16}, "master": {torch.float32}},
          f"bf16-everything checkpoint dtypes {dtypes}")
    text, epochs = run(knobs, "--epochs", "2", flags=flags)
    check("Latest SKY checkpoint restored (epoch 1)" in text and epochs == [2]
          and knob_ckpt.steps() == [1, 2], f"bf16-everything resume: ran {epochs}, saved "
          f"{knob_ckpt.steps()}")
    ckpt_bytes = {name: os.path.getsize(os.path.join(d, "checkpoints", "SKY", "1", "state.pt"))
                  for name, d in (("f32", sky), ("bf16_everything", knobs))}
    say("train_cli", f"bf16 everything at DA {h}x{w} b{b}: epoch seconds {epoch_s[knobs]} "
        f"(epoch 1 at lr 0 after the hand-off, epoch 2 resumed) vs float32 {epoch_s[sky]}; "
        f"checkpoint {ckpt_bytes['bf16_everything'] / 1e9:.4f} GB vs float32 "
        f"{ckpt_bytes['f32'] / 1e9:.4f} GB (ratio "
        f"{ckpt_bytes['bf16_everything'] / ckpt_bytes['f32']:.4f}); on {smi}")
    report["train_cli"] = {"epoch_s": epoch_s[sky], "bf16_plain_epoch_s": epoch_s[bf16],
                           "bf16_everything_epoch_s": epoch_s[knobs],
                           "checkpoint_bytes": ckpt_bytes, "device": smi}
    say("train_cli", f"epoch seconds at DA {h}x{w} b{b} (4 train steps + 1 eval batch, "
        f"checkpoint save included): {epoch_s[sky]}; on {smi}")
    say("train_cli", f"epoch seconds at plain {h}x{w} b{b} bf16 compute (4 train steps + 1 "
        f"eval batch, checkpoint save included; epoch 2 resumed): {epoch_s[bf16]}; on {smi}")


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


def last_json(text):
    return json.loads(text.strip().splitlines()[-1])


def time_eval_step(cfg, workdir, batch, smi, tag):
    """CUDA-event times (median of 20 after warm-up) of one synthetic eval
    step of `cli.evaluate` on `batch` [b, h, w, 3]: the degradation, the
    forward and the metrics, and the three in a row."""
    from skyhdr_torch.cli.common import load_banks, restore_model_vars
    from skyhdr_torch.train.engine import degrade, make_inference_fn
    from skyhdr_torch.train.evaluation import evaluate_batch
    from skyhdr_torch.utils import jax_random

    gen, sun = restore_model_vars(cfg, workdir, device="cuda", log=lambda *a: None)
    banks = load_banks(cfg, "", train=False, device="cuda", log=lambda *a: None)
    infer = make_inference_fn(cfg)
    key = jax_random.key(0)
    hdr_t, ldr = degrade(cfg, banks, key, batch)
    pred = infer(gen, sun, ldr)["y_final_lin"]

    def step():
        target, inputs = degrade(cfg, banks, key, batch)
        return evaluate_batch(infer(gen, sun, inputs)["y_final_lin"], target)

    parts = {"degradation": lambda: degrade(cfg, banks, key, batch),
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
    serving_checkpoint(eval_work, da_cfg, k3_trees())
    say("cli", f"DA {eh}x{ew}: the seeded serving weights (`k3_trees`) saved as a SKY "
        f"checkpoint in {time.perf_counter() - t0:.3f} s (for every evaluate run at this "
        f"shape)")
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


# The size of the convert phase's full-width states. At DA 64x256 its four
# states (SKY 6.5 GB, SUN 9.7 GB, bf16-parameter SKY 8.1 GB, bf16-moment SUN
# 6.4 GB), each exported and imported, write ~61 GB, past the 45 GiB of
# disk writes (deleted files count) that the card's machine allows a run:
# at 32x128 the sun-pose FCs, which are (h w)-wide, are 1/16 the size.
CONVERT_SIZE = (32, 128)


def convert_full_width(dc, smi, work, report):
    """(b) DA `CONVERT_SIZE`: a GanState and a SunState with every tensor drawn,
    exported by `export_from_state` and imported by the CLI one at a time
    (an export deleted once imported), checked bit-equal; served from the
    import and from the source modules; one resumed GAN step at b32 from
    each; a bfloat16-parameter SKY checkpoint (with its master) and a SUN
    checkpoint with bfloat16 moments imported, bit-equal, and resumed
    bit-equal to their sources; the bf16 SKY one served and refused by a
    float32 run."""
    from skyhdr_torch.config import Config, DataConfig, ModelConfig
    from skyhdr_torch.data.degradation import make_banks
    from skyhdr_torch.models.vgg16 import random_vgg16_weights
    from skyhdr_torch.train.checkpoints import CheckpointManager
    from skyhdr_torch.train.convert import export_from_state
    from skyhdr_torch.train.engine import (empty_gan_state, empty_sun_state,
                                           make_gan_train_step, make_sun_train_step,
                                           state_dict)
    from skyhdr_torch.train.loop import TrainLoop
    from skyhdr_torch.utils import jax_random
    from skyhdr_torch.utils.flax_export import write_export
    from skyhdr_torch.utils.io import get_exposure_lists, make_synthetic_dorf

    (h, w), b, serve_b = CONVERT_SIZE, 32, 32
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

    # One resumed GAN step at b32 from the import and one from the source,
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
                    _, m = step(state, batch, jax_random.key(9))
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

    # A SKY checkpoint trained with bfloat16 parameters (the source's
    # float32 weights as its master, their rounding stored): exported with
    # its master and moments, imported, served, and resumed.
    cfg_p = state_cfg(cfg, param_dtype="bfloat16")
    state = bf16_param_state(src.pop("SKY"), cfg_p)
    bf16_work = os.path.join(work, "port_bf16")
    knob_import(dc, state, "SKY", work, bf16_work, flags + ["--param-dtype", "bfloat16"],
                f"SKY bf16 params {h}x{w}", "SKY_bf16_params", out, smi)
    got, text, secs, launched = serve_captured(dc, indir, os.path.join(work, "hdr_bf16"),
                                               bf16_work, h, w, serve_b)
    check(launched == want, f"bf16 serving launches {launched}, want {want}")
    ref = serve_modules(serve_cfg, state.gen, state.sun, indir, serve_b)
    same = sorted(got) == sorted(ref) and all(np.array_equal(got[k], ref[k]) for k in ref)
    say("convert", f"bf16-parameter SKY checkpoint served: {len(got)} panoramas in {secs:.3f} s, "
        f"launches {launched}, bit-equal to its source modules: {same}")
    check(same, "bf16 serving differs from its source modules")
    refused = None
    try:
        TrainLoop(cfg, "SKY", lambda: None, None, None, None, None, workdir=bf16_work,
                  log=lambda *_: None, device="cuda")
    except ValueError as e:
        refused = str(e)
    say("convert", f"the bf16-parameter checkpoint under float32 parameters: ValueError "
        f"{refused!r}")
    check(refused is not None and "--param-dtype bfloat16" in refused,
          "a float32 run resumed a bf16-parameter checkpoint")
    step = make_gan_train_step(cfg_p, banks, random_vgg16_weights())
    out["resumed_step_bf16_params"] = knob_resume(
        dc, step, cfg_p, bf16_work, "SKY", state, batch, GAN_LAUNCHES,
        f"resumed GAN step at DA {h}x{w} b{b}, bf16 parameters")
    del state, step
    free_cuda()

    # A SUN checkpoint with bfloat16 moments, imported and resumed the same way.
    cfg_o = state_cfg(Config(model=cfg.model, data=DataConfig(batch_size=serve_b)),
                      opt_state_dtype="bfloat16")
    state = fill_state(empty_sun_state(cfg_o, "cuda"), 2)
    sun_work = os.path.join(work, "port_bf16_moments")
    knob_import(dc, state, "SUN", work, sun_work, flags + ["--opt-state-dtype", "bfloat16"],
                f"SUN bf16 moments {h}x{w}", "SUN_bf16_moments", out, smi)
    out["resumed_step_bf16_moments"] = knob_resume(
        dc, make_sun_train_step(cfg_o, banks), cfg_o, sun_work, "SUN", state,
        train_batches(1, serve_b, h, w, seed=3001)[0], SUN_LAUNCHES,
        f"resumed sun step at DA {h}x{w} b{serve_b}, bf16 moments")
    del state
    free_cuda()


def state_cfg(cfg, **knobs):
    """`cfg` with storage knobs set in its TrainConfig."""
    import dataclasses

    return cfg.replace(train=dataclasses.replace(cfg.train, **knobs))


def bf16_param_state(state, cfg):
    """`state` held under bfloat16 parameters (`cfg`), on the card: its float32
    parameters become the optimizer's master and their rounding the stored
    copy; the moments, BatchNorm statistics and counters stay."""
    from skyhdr_torch.train.engine import load_state, state_dict

    blob = state_dict(state)
    for name, opt in state.optimizers().items():
        blob["optimizers"][name]["master"] = [p.detach().clone() for p in opt.params]
    for name, module in state.modules().items():
        params = {n for n, _ in module.named_parameters()}
        blob["modules"][name] = {k: v.to(torch.bfloat16) if k in params else v
                                 for k, v in blob["modules"][name].items()}
    blob["param_dtype"] = "bfloat16"
    return load_state(blob, cfg, "cuda")


def knob_import(dc, state, name, work, pwork, flags, tag, key, out, smi):
    """`state` exported (`export_from_state`, with its master and moments),
    imported by the CLI into `pwork` and read back bit-equal, dtypes
    included."""
    from skyhdr_torch.train.checkpoints import CheckpointManager
    from skyhdr_torch.train.convert import export_from_state
    from skyhdr_torch.utils.flax_export import write_export

    export = os.path.join(work, f"export_{name}_knobs")
    gb = state_bytes(state) / 1e9
    t0 = time.perf_counter()
    manifest, leaves = export_from_state(state)
    write_export(os.path.join(export, name), manifest, leaves)
    del leaves
    t1 = time.perf_counter()
    wall, _ = import_cli(dc, export, pwork, flags, f"import CLI {tag}")
    shutil.rmtree(export)
    blob = CheckpointManager(os.path.join(pwork, "checkpoints", name)).read_latest()
    bad, n = blob_mismatches(blob, state)
    del blob
    say("convert", f"{tag} ({gb:.3f} GB, param_dtype {manifest['param_dtype']}, moments "
        f"{manifest['opt_state_dtype']}): exported in {t1 - t0:.3f} s, import CLI "
        f"{wall:.3f} s; {n} tensors (master included) and the counters bit-equal, dtypes "
        f"included: {not bad} {bad[:5]}; on {smi}")
    check(not bad, f"{tag} import not bit-equal: {bad[:10]}")
    out[key] = {"gb": gb, "import_cli_s": wall, "tensors": n}


def knob_resume(dc, step, cfg, pwork, name, source, batch, want, tag):
    """One resumed step from the import in `pwork` and one from `source`
    under deterministic algorithms: the launches, and every tensor (master
    and moments in their dtypes) and counter bit-equal after it."""
    from skyhdr_torch.train.checkpoints import CheckpointManager
    from skyhdr_torch.train.engine import state_dict
    from skyhdr_torch.utils import jax_random

    restored = CheckpointManager(os.path.join(pwork, "checkpoints", name)).restore_latest(
        cfg, "cuda")
    cublas_config = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    metrics = {}
    try:
        torch.use_deterministic_algorithms(True, warn_only=True)
        for who, state in (("imported", restored), ("source", source)):
            reset_counts(dc)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                _, m = step(state, batch, jax_random.key(9))
                torch.cuda.synchronize()
            metrics[who] = {k: float(v) for k, v in m.items()}
            launched = counts(dc)
            check(launched == want, f"{tag} ({who}) launches {launched}, want {want}")
    finally:
        torch.use_deterministic_algorithms(False)
        if cublas_config is None:
            del os.environ["CUBLAS_WORKSPACE_CONFIG"]
    bad, n = blob_mismatches(state_dict(restored), source)
    knobs = tuple(getattr(cfg.train, k) for k in ("opt_state_dtype", "grad_dtype",
                                                   "param_dtype"))
    stored = check_knob_state(restored, knobs, tag)
    total = "gen_total" if "gen_total" in metrics["source"] else "sun_total"
    say("convert", f"{tag}, from the import and from the source, deterministic algorithms: "
        f"launches {want} each; {total} {metrics['imported'][total]:.7g} vs "
        f"{metrics['source'][total]:.7g}; {n - len(bad)} of {n} tensors and the counters "
        f"bit-equal after it {bad[:3]}; {stored}")
    check(not bad and metrics["imported"] == metrics["source"], f"{tag} differs: {bad[:10]}")
    return {"tensors_differing": len(bad), "tensors": n,
            "metrics_equal": metrics["imported"] == metrics["source"]}


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


# The parallel phase: DA 32x128, full widths, a global batch of 32.
DP_H, DP_W, DP_BATCH = 32, 128, 32


@functools.lru_cache(maxsize=None)
def dp_trees():
    """The seeded DA 32x128 weights of the parallel and fsdp phases, drawn
    once: (trees, seconds the draw took)."""
    from skyhdr_torch.utils.transplant import init_gan_vars

    t0 = time.perf_counter()
    trees = init_gan_vars(golden_tool().dp_config({}, DP_H, DP_W, DP_BATCH), 0)
    return trees, time.perf_counter() - t0


_DP_SINGLE = {}


def dp_single(dc, mod, spec, trees):
    """`dp_reference` (the single-process b32 GAN and sun steps) of the
    parallel and fsdp phases, computed once and printed."""
    if not _DP_SINGLE:
        t0 = time.perf_counter()
        reset_counts(dc)
        _DP_SINGLE["ref"] = mod.dp_reference(spec, {}, trees)
        say("parallel", f"single-process b{DP_BATCH} GAN step + sun step in "
            f"{time.perf_counter() - t0:.3f} s (launches {counts(dc)})")
    return _DP_SINGLE["ref"]


def dp_spec(work, threads=4):
    """The rank spec of the parallel and fsdp phases, the seeded weights
    written to `work` for the ranks."""
    import pickle

    spec = {"device": "cuda", "h": DP_H, "w": DP_W, "batch": DP_BATCH, "seed": 0,
            "weights": os.path.join(work, "weights.pkl"), "threads": threads}
    with open(spec["weights"], "wb") as f:
        pickle.dump(dp_trees()[0], f, protocol=pickle.HIGHEST_PROTOCOL)
    return spec


def rank_launches_ok(phase, case, per_rank):
    """Each rank's K1-K3 launches of one GAN and one sun step, asserted."""
    want = {"gan": {k: GAN_LAUNCHES[k] for k in ("K1", "K2", "K3")},
            "sun": {k: SUN_LAUNCHES[k] for k in ("K1", "K2", "K3")}}
    for rank, r in enumerate(per_rank):
        say(phase, f"{case} rank {rank}: launches {r['launches']} (want {want}); "
            f"states bit-equal across ranks: {r['agree']}")
        check(r["launches"] == want, f"{case} rank {rank} launches {r['launches']}")
        check(r["agree"], f"{case}: the ranks' states differ after the steps")


def single_step_ms(mod, spec, trees):
    """{"gan", "sun"}: the single-process step's ms on the parallel phase's
    global batch (CUDA events, median of STEP_ITERS after 1 warm-up)."""
    from skyhdr_torch.train.engine import make_gan_train_step, make_sun_train_step
    from skyhdr_torch.utils import jax_random

    cfg = mod.dp_config({}, spec["h"], spec["w"], spec["batch"])
    banks, vgg, host = mod._dp_setup(spec)
    batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    gan, sun = mod._dp_states(cfg, trees, "cuda")
    key = jax_random.key(spec["seed"] + 2)
    out = {}
    for kind, step, state in (("gan", make_gan_train_step(cfg, banks, vgg), gan),
                              ("sun", make_sun_train_step(cfg, banks), sun)):
        out[kind] = statistics.median(time_ms(lambda: step(state, batch, key),
                                              iters=STEP_ITERS, warmup=1))
    return out


def phase_parallel(dc, smi, report):
    """Data parallelism on the card (`skyhdr_torch.parallel.dp`). The
    seeded state is drawn once here and written to the run's temporary
    directory; each rank process loads it.
      - Two gloo ranks on the one H100 (NCCL refuses two ranks on one
        device), 16 samples each: one GAN step and one sun step of
        `make_parallel_*_train_step` against the single-process b32 steps
        from the same weights and generator seed, run here first
        (`compare_train_golden`'s tolerances: the card's default mode is
        not bitwise repeatable), K1-K3 counted on each rank, every rank
        bit-equal after the steps; then each step timed on each rank (the
        two ranks share the card), the gloo collectives' share of it and
        the peak memory.
      - NCCL at world size 1 under deterministic algorithms: the DP steps
        bit-equal to the single-process steps in the same process.
    A rank that fails, or outlives its limit, fails the run."""
    mod = golden_tool()
    work = tempfile.mkdtemp(prefix="skyhdr_dp_")
    out = report["parallel"] = {"device": smi}
    try:
        trees, draw_s = dp_trees()
        spec = dp_spec(work)
        say("parallel", f"DA {DP_H}x{DP_W}: seeded weights drawn once in {draw_s:.3f} s")
        ref = dp_single(dc, mod, spec, trees)
        out["single_ms"] = single_step_ms(mod, spec, trees)
        say("parallel", f"single-process b{DP_BATCH} steps, for scale: GAN "
            f"{out['single_ms']['gan']:.3f} ms, sun {out['single_ms']['sun']:.3f} ms (CUDA "
            f"events, median of {STEP_ITERS} after 1 warm-up); on {smi}")
        free_cuda()
        for world, backend, case, extra in (
                (2, "gloo", "gloo2", {"timing": RANK_ITERS}),
                (1, "nccl", "nccl1", {"deterministic": True, "single": True})):
            t0 = time.perf_counter()
            cwork = os.path.join(work, case)
            os.makedirs(cwork)
            results = mod.run_dp_ranks(dict(spec, world=world, backend=backend,
                                            cases=[{"name": case, "path": "batch"}], **extra),
                                       cwork, timeout_s=300)
            say("parallel", f"{world} {backend} rank(s): run in "
                f"{time.perf_counter() - t0:.3f} s wall")
            per_rank = [r[case] for r in results]
            got = per_rank[0]
            rank_launches_ok("parallel", case, per_rank)
            if case == "gloo2":
                fails, worst = mod.compare_dp_steps(ref, got, mod.DP_RTOL["golden"])
                for kind in ("gan", "sun"):
                    for name, a, b in zip(ref[f"{kind}_metric_names"], got[f"{kind}_metrics"],
                                          ref[f"{kind}_metrics"]):
                        say("parallel", f"{case} {kind} {name}: 2 ranks {a:.7g}, single "
                            f"process {b:.7g}")
                say("parallel", f"{case}: DA {DP_H}x{DP_W} b{DP_BATCH} (16 a rank) GAN step + "
                    f"sun step vs the single-process step: worst relative {json.dumps(worst)} "
                    f"(metrics {GOLDEN_METRIC_RTOL}, updates {GOLDEN_UPDATE_RTOL}, BN sums "
                    f"1e-4)")
                for line in fails:
                    say("parallel", f"FAIL {case}: {line}")
                check(not fails, f"{case} vs the single-process step: {len(fails)} mismatches")
                for rank, r in enumerate(per_rank):
                    for kind in ("gan", "sun"):
                        say("parallel", f"{case} rank {rank} {kind} step: "
                            f"{r[f'{kind}_ms']:.3f} ms (median of {RANK_ITERS}, host clock, "
                            f"both ranks stepping on the one card; all "
                            f"{[round(t, 3) for t in r[f'{kind}_ms_all']]}), gloo "
                            f"collectives {r[f'{kind}_comm_ms']:.3f} ms = "
                            f"{100 * r[f'{kind}_comm_share']:.2f}% of a step timed with "
                            f"each collective after the queued work, peak "
                            f"{r[f'{kind}_peak_gib']:.3f} GiB; on {smi}")
                out[case] = {"worst": worst, "ranks": [
                    {k: r[k] for k in r if k.endswith(("_ms", "_ms_all", "_share", "_gib"))
                     or k == "launches"} for r in per_rank]}
            else:
                say("parallel", f"{case}: NCCL at world size 1, deterministic algorithms: DP "
                    f"steps bit-equal to the single-process steps in the same process: "
                    f"{got['single_equal']}")
                check(got["single_equal"], "nccl1: the DP steps differ from the single-process "
                      "steps")
                out[case] = {"single_equal": got["single_equal"], "launches": got["launches"]}
    finally:
        shutil.rmtree(work, ignore_errors=True)


# The fsdp phase's min_bytes: `skyhdr`'s default (the sun-pose FCs and their
# moments sharded).
FSDP_MIN_BYTES = 1 << 20


def phase_fsdp(dc, smi, report):
    """ZeRO-3 sharded training on the card (`skyhdr_torch.parallel.fsdp`),
    on the parallel phase's seeded DA 32x128 state and b32 batch. Two gloo
    ranks on the one H100, 16 samples each, in one launch:
      - one GAN step and one sun step of `make_fsdp_*_train_step` (sharded,
        stepped, unsharded) against the single-process b32 steps
        (`compare_train_golden`'s tolerances), K1-K3 counted on each rank,
        the ranks' unsharded states bit-equal; then each step timed on each
        rank (step ms, the collectives' share, peak memory) and the
        sharded state's at-rest bytes;
      - under deterministic algorithms, two consecutive GAN steps and two
        sun steps of the FSDP step and of the DP step from the same state
        and seeds: every tensor bit-equal after unsharding;
      - DA 64x256 GanState and SunState filled on the card and sharded: each
        rank's at-rest bytes (and the allocator's) against the replicated
        state's.
    Then NCCL at world size 1 under deterministic algorithms: the FSDP
    steps bit-equal to the single-process steps in the same process."""
    mod = golden_tool()
    work = tempfile.mkdtemp(prefix="skyhdr_fsdp_")
    out = report["fsdp"] = {"device": smi, "min_bytes": FSDP_MIN_BYTES}
    mb = FSDP_MIN_BYTES
    try:
        trees, _ = dp_trees()
        spec = dp_spec(work)
        ref = dp_single(dc, mod, spec, trees)
        cases = [{"name": "fsdp", "path": "batch", "fsdp": mb, "timing": RANK_ITERS},
                 {"name": "fsdp_vs_dp", "path": "batch", "fsdp": mb, "vs_dp": True,
                  "deterministic": True},
                 {"name": "at_rest_64x256", "at_rest": [64, 256], "fsdp": mb}]
        t0 = time.perf_counter()
        os.makedirs(os.path.join(work, "gloo2"))
        results = mod.run_dp_ranks(dict(spec, world=2, backend="gloo", cases=cases),
                                   os.path.join(work, "gloo2"), timeout_s=400)
        say("fsdp", f"2 gloo ranks: run in {time.perf_counter() - t0:.3f} s wall")
        per_rank = [r["fsdp"] for r in results]
        rank_launches_ok("fsdp", "fsdp", per_rank)
        fails, worst = mod.compare_dp_steps(ref, per_rank[0], mod.DP_RTOL["golden"])
        say("fsdp", f"DA {DP_H}x{DP_W} b{DP_BATCH} (16 a rank) FSDP GAN step + sun step at "
            f"min_bytes {mb} vs the single-process step: worst relative {json.dumps(worst)} "
            f"(metrics {GOLDEN_METRIC_RTOL}, updates {GOLDEN_UPDATE_RTOL}, BN sums 1e-4)")
        for line in fails:
            say("fsdp", f"FAIL fsdp: {line}")
        check(not fails, f"fsdp vs the single-process step: {len(fails)} mismatches")
        out["worst"] = worst
        out["ranks"] = []
        for rank, r in enumerate(results):
            row = {k: r["fsdp"][k] for k in r["fsdp"] if k.endswith(
                ("_ms", "_ms_all", "_share", "_gib", "_bytes"))}
            vs, rest = r["fsdp_vs_dp"], r["at_rest_64x256"]
            for kind in ("gan", "sun"):
                say("fsdp", f"rank {rank} {kind} step: {r['fsdp'][f'{kind}_ms']:.3f} ms (median "
                    f"of {RANK_ITERS}, host clock, both ranks stepping on the one card), "
                    f"collectives {r['fsdp'][f'{kind}_comm_ms']:.3f} ms = "
                    f"{100 * r['fsdp'][f'{kind}_comm_share']:.2f}%, peak "
                    f"{r['fsdp'][f'{kind}_peak_gib']:.3f} GiB; at rest "
                    f"{r['fsdp'][f'{kind}_resident_bytes']} B sharded of "
                    f"{vs[f'{kind}_replicated_bytes']} B replicated (DA {DP_H}x{DP_W}); on {smi}")
                say("fsdp", f"rank {rank} {kind}: two FSDP steps vs two DP steps under "
                    f"deterministic algorithms, tensors whose bits differ: "
                    f"{vs[f'{kind}_differ'] or 'none'}")
                check(vs[f"{kind}_differ"] == [], f"rank {rank} {kind}: FSDP != DP")
                say("fsdp", f"rank {rank} DA 64x256 {kind} state at rest: {rest[f'{kind}_bytes']}"
                    f" B sharded ({rest[f'{kind}_allocated']} B allocated, plan "
                    f"{rest[f'{kind}_plan_bytes']} B) of {rest[f'{kind}_replicated_bytes']} B "
                    f"replicated = {rest[f'{kind}_bytes'] / rest[f'{kind}_replicated_bytes']:.4f};"
                    f" peak while sharding {rest[f'{kind}_peak']} B; on {smi}")
                check(rest[f"{kind}_bytes"] == rest[f"{kind}_plan_bytes"],
                      f"rank {rank} {kind}: at-rest bytes off the plan")
                row.update({f"{kind}_differ": vs[f"{kind}_differ"],
                            f"{kind}_bytes_32x128": vs[f"{kind}_bytes"],
                            f"{kind}_replicated_32x128": vs[f"{kind}_replicated_bytes"]},
                           **{f"{kind}_{k}_64x256": rest[f"{kind}_{k}"] for k in (
                               "bytes", "allocated", "plan_bytes", "replicated_bytes", "peak")})
            check(vs["agree"], "fsdp_vs_dp: the ranks' unsharded states differ")
            out["ranks"].append(row)
        t0 = time.perf_counter()
        os.makedirs(os.path.join(work, "nccl1"))
        results = mod.run_dp_ranks(
            dict(spec, world=1, backend="nccl", deterministic=True, single=True,
                 cases=[{"name": "fsdp_nccl1", "path": "batch", "fsdp": mb}]),
            os.path.join(work, "nccl1"), timeout_s=300)
        got = results[0]["fsdp_nccl1"]
        rank_launches_ok("fsdp", "fsdp_nccl1", [got])
        say("fsdp", f"NCCL at world size 1, deterministic algorithms: FSDP steps bit-equal to "
            f"the single-process steps in the same process: {got['single_equal']} (run in "
            f"{time.perf_counter() - t0:.3f} s wall)")
        check(got["single_equal"], "fsdp_nccl1: the FSDP steps differ from the single-process "
              "steps")
        out["nccl1_single_equal"] = got["single_equal"]
    finally:
        shutil.rmtree(work, ignore_errors=True)


# The spatial phase: the DA layer shapes at 64x256 (the kernels phase's),
# this batch.
SPATIAL_BATCH = 8


def spatial_cases():
    """The spatial phase's cases (`make_torch_golden.spatial_rank`): each
    distinct k=3 DA layer shape at 64x256 under the halo plan and
    `force_gather` in f32, the trunk in bf16, the k=5 trunk (K5) under
    both, and `ring_conv2d` with cyclic and zero seams (`spatial_inputs`)."""
    cases, seen = [], set()
    for i, (name, shape, f, _, _) in enumerate(DA_LAYERS + DA5_LAYERS):
        h, w, c = scaled(shape, 2)
        k = 5 if "k=5" in name else 3
        if (h, w, c, f, k) in seen:
            continue
        seen.add((h, w, c, f, k))
        for gather in (False, True):
            cases.append({"name": f"{name} {'gather' if gather else 'halo'}", "op": "da",
                          "k": k, "f": f, "shape": [SPATIAL_BATCH, h, w, c], "seed": i,
                          "force_gather": gather})
    trunk = next(c for c in cases if c["k"] == 3 and c["shape"][1:] == [16, 64, 128]
                 and c["f"] == 128 and not c["force_gather"])
    cases.append(dict(trunk, name="trunk 16x64x128 halo bf16", dtype="bfloat16"))
    for padding in ("cyclic", "zeros"):
        cases.append({"name": f"conv3 {padding}", "op": "conv", "padding": padding, "k": 3,
                      "f": 32, "shape": [SPATIAL_BATCH, 64, 256, 32], "seed": 99})
    return cases


def ring_timing(dc, smi, width=4, batch=32):
    """K1/K5 on one width shard of `width` (extended by its halo) at each
    distinct DA layer shape at 64x256 b`batch` f32, in this process (no
    ring: the extension is cut from the whole panorama): its ms and the
    plain version's (paired, CUDA events), K1/K5 on the whole panorama for
    scale, and the shard's bound."""
    from skyhdr_torch.parallel.spatial import ring_da_plan

    rows, seen = [], set()
    gen = torch.Generator(device="cuda").manual_seed(7)
    for name, shape, f, _, _ in DA_LAYERS + DA5_LAYERS:
        h, w, c = scaled(shape, 2)
        k = 5 if "k=5" in name else 3
        if (h, w, c, f, k) in seen:
            continue
        seen.add((h, w, c, f, k))
        wl = w // width
        _, halo = ring_da_plan(h, w, wl, k)
        x, kern, bias, _ = operands((h, w, c), batch, f, torch.float32, gen, ksize=k)
        xe = x[:, :, [(c0 - halo) % w for c0 in range(wl + 2 * halo)]].contiguous()
        ring = lambda: dc.da_conv_forward_ring(xe, kern, bias, w=w, halo=halo, kernel_size=k)
        plain = lambda: dc.da_conv_forward_ring_ref(xe, kern, bias, w=w, halo=halo,
                                                    kernel_size=k)
        whole = ((lambda: dc.da_conv_forward_k1(x, kern, bias)) if k == 3
                 else (lambda: dc.da_conv_forward_k5(x, kern, bias, kernel_size=k)))
        err, _ = rel_err(ring(), plain())
        check(err <= TOL["K1" if k == 3 else "K5", torch.float32],
              f"{name}: the ring kernel vs its plain version {err:.3e}")
        same = torch.equal(ring(), whole()[:, :, :wl])
        ms, plain_ms = paired_ms(ring, plain)
        whole_ms = statistics.median(time_ms(whole))
        bms, by = bound("K1" if k == 3 else "K5", batch, (h, wl, c), f, ksize=k)
        rows.append({"layer": name, "k": k, "x": [batch, h, wl + 2 * halo, c], "f": f,
                     "halo": halo, "ms": ms, "plain_ms": plain_ms, "whole_ms": whole_ms,
                     "bound_ms": bms, "bound_by": by, "err": err, "whole_equal": same})
        say("spatial", f"{name}: K{1 if k == 3 else 5} on a 1/{width} width shard "
            f"x[{batch},{h},{wl}+2*{halo},{c}] -> {f}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
            f"the whole panorama {whole_ms:.4f} ms, the shard's bound {bms:.4f} ms by {by}); "
            f"vs plain {err:.2e}, its columns bit-equal to the whole panorama's: {same}; "
            f"on {smi}")
    return rows


def phase_spatial(dc, smi, report):
    """Width-sharded spatial parallelism on the card (`skyhdr_torch.parallel.
    spatial`): `spatial_cases` on width rings of 2 and of 4 gloo ranks (both
    launches at once, all on the one H100), then on NCCL at world size 1
    (the ring of one: its own opposite edge). Per rank and case: the DA
    conv's K1/K5 launches (one a call, and no other), its block against
    its plain version (1e-4 f32, 2e-2 bf16) and whether it equals K1/K5 on
    the whole panorama bit for bit; `ring_conv2d` against `F.conv2d` on the
    whole panorama padded the same way (1e-4). Then `ring_timing`. A rank
    that fails or hangs fails the phase."""
    mod = golden_tool()
    work = tempfile.mkdtemp(prefix="skyhdr_ring_")
    out = report["spatial"] = {"device": smi, "cases": {}}
    cases = spatial_cases()
    def ranks(name, width, backend):
        cwork = os.path.join(work, name)
        os.makedirs(cwork)
        return mod.DPRanks({"job": "spatial", "world": width, "width": width, "device": "cuda",
                            "backend": backend, "cases": cases, "threads": 2}, cwork)

    try:
        t0 = time.perf_counter()
        runs, rings = {}, {}
        try:  # the two gloo rings together, then NCCL alone
            for name, width in (("w2", 2), ("w4", 4)):
                rings[name] = ranks(name, width, "gloo")
            for name, ring in rings.items():
                runs[name] = ring.results(300)
        finally:
            for ring in rings.values():
                ring.stop()
        with ranks("nccl1", 1, "nccl") as ring:
            runs["nccl1"] = ring.results(300)
        say("spatial", f"rings of 2 and 4 gloo ranks, then NCCL at world size 1: "
            f"{time.perf_counter() - t0:.3f} s wall")
        for name, results in runs.items():
            for case in cases:
                n = case["name"]
                tol = 2e-2 if case.get("dtype") == "bfloat16" else 1e-4
                errs = [r[n]["err_plain"] for r in results]
                row = {"err_plain": max(errs), "max_abs_err": max(r[n]["max_abs_err"]
                                                                  for r in results)}
                if case["op"] == "da":
                    want = {"K1": int(case["k"] == 3), "K5": int(case["k"] != 3)}
                    launches = [r[n]["launches"] for r in results]
                    row.update(mode=results[0][n]["mode"], halo=results[0][n]["halo"],
                               launches=launches,
                               whole_equal=all(r[n]["whole_equal"] for r in results))
                    check(all(x == want for x in launches),
                          f"{name} {n}: launches {launches}, want {want} a rank")
                say("spatial", f"{name} {n}: x {case['shape']} -> {case['f']} "
                    f"{case.get('dtype', 'float32')}: worst rank vs plain {row['err_plain']:.2e}"
                    f" (tol {tol})" + (f", plan {row['mode']} (halo {row['halo']}), launches a "
                                       f"rank {row['launches']}, bit-equal to the whole "
                                       f"panorama's K{1 if case['k'] == 3 else 5}: "
                                       f"{row['whole_equal']}" if case["op"] == "da" else ""))
                check(row["err_plain"] <= tol, f"{name} {n}: {row['err_plain']:.3e} > {tol}")
                out["cases"][f"{name} {n}"] = row
        out["timing"] = ring_timing(dc, smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


# The width_step phase: the steps timed on each rank, and the FSDP min_bytes.
WIDTH_TIMING = 2
WIDTH_MIN_BYTES = 1 << 20
# The largest activation peak of a rank, as a share of the single-process
# step's at the same global batch: a (1, 2) rank holds half of every map
# (a step that gathered its activations would read 1.0 or more), a (2, 2)
# rank a quarter (0.4754 on the H100).
WIDTH_PEAK_RATIO = {"w1x2": 0.8, "w2x2_fsdp": 0.6}


def width_ring_cases():
    """Each distinct DA layer shape at 32x128 b32 (k=3, and the k=5 trunk):
    the ring backward kernels' cases (`make_torch_golden.ring_kernel_checks`,
    `width_ring_timing`)."""
    cases, seen = [], set()
    for i, (name, shape, f, _, _) in enumerate(DA_LAYERS + DA5_LAYERS):
        k = 5 if "k=5" in name else 3
        if (*shape, f, k) in seen:
            continue
        seen.add((*shape, f, k))
        cases.append({"name": name, "shape": [DP_BATCH, *shape], "f": f, "k": k,
                      "seed": 100 + i})
    return cases


def single_act_peak(mod, spec, trees):
    """The single-process GAN step's activation peak at the phase's global
    batch, in this process: a warm-up step, then the largest of two steps'
    `max_memory_allocated` above `memory_allocated` just before the step
    (bytes)."""
    from skyhdr_torch.train.engine import make_gan_train_step
    from skyhdr_torch.utils import jax_random

    cfg = mod.dp_config({}, spec["h"], spec["w"], spec["batch"])
    banks, vgg, host = mod._dp_setup(spec)
    batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
    gan = mod._gan_state(cfg, trees, "cuda")
    step = make_gan_train_step(cfg, banks, vgg)
    key = jax_random.key(spec["seed"] + 2)
    peaks = []
    for i in range(3):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        step(gan, batch, key)
        torch.cuda.synchronize()
        if i:
            peaks.append(torch.cuda.max_memory_allocated() - base)
    del gan
    free_cuda()
    return max(peaks)


def width_ring_timing(dc, smi, width=2):
    """The ring backward kernels on one 1/`width` shard (extended by its
    halo, cut from the whole panorama: no ring) at each `width_ring_cases`
    shape, f32, in this process: K2/K7 and K3/K6 against their plain
    versions (paired, CUDA events), the whole-panorama kernel for scale,
    and the shard's bound (`bound` of the shard's own columns); each also
    held to its plain version (the kernel's tolerance)."""
    from skyhdr_torch.parallel.spatial import ring_da_plan

    rows = []
    gen = torch.Generator(device="cuda").manual_seed(11)
    for case in width_ring_cases():
        b, h, w, c = case["shape"]
        k, f = case["k"], case["f"]
        wl = w // width
        _, halo = ring_da_plan(h, w, wl, k)
        x, kern, _, g = operands((h, w, c), b, f, torch.float32, gen, ksize=k)
        xe = x[:, :, [(c0 - halo) % w for c0 in range(wl + 2 * halo)]].contiguous()
        gl = g[:, :, :wl].contiguous()
        geom = dict(w=w, halo=halo, kernel_size=k)
        kx, kd = ("K2", "K3") if k == 3 else ("K7", "K6")
        calls = {
            kx: (lambda: dc.da_conv_dx_ring(gl, kern, x_shape=tuple(xe.shape), **geom),
                 lambda: dc.da_conv_dx_ring_ref(gl, kern, x_shape=tuple(xe.shape), **geom),
                 (lambda: dc.da_conv_dx_k2(g, kern, x_shape=tuple(x.shape))) if k == 3 else
                 (lambda: dc.da_conv_dx_k7(g, kern, x_shape=tuple(x.shape), kernel_size=k))),
            kd: (lambda: dc.da_conv_dk_ring(xe, gl, **geom),
                 lambda: dc.da_conv_dk_ring_ref(xe, gl, **geom),
                 (lambda: dc.da_conv_dk_k3(x, g)) if k == 3 else
                 (lambda: dc.da_conv_dk_k6(x, g, kernel_size=k)))}
        for kern_name, (ring, plain, whole) in calls.items():
            err, gap = rel_err(ring(), plain())
            check(err <= TOL[kern_name, torch.float32],
                  f"{case['name']}: {kern_name} on a width shard vs its plain version {err:.3e}")
            ms, plain_ms = paired_ms(ring, plain)
            whole_ms = statistics.median(time_ms(whole))
            bms, by = bound(kern_name, b, (h, wl, c), f, ksize=k)
            rows.append({"kernel": kern_name, "layer": case["name"], "k": k,
                         "x": [b, h, wl + 2 * halo, c], "f": f, "halo": halo, "ms": ms,
                         "plain_ms": plain_ms, "whole_ms": whole_ms, "bound_ms": bms,
                         "bound_by": by, "err": err, "max_abs_err": gap})
            say("width_step", f"{case['name']}: {kern_name} on a 1/{width} width shard "
                f"x[{b},{h},{wl}+2*{halo},{c}] -> {f}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
                f"the whole panorama {whole_ms:.4f} ms, the shard's bound {bms:.4f} ms by "
                f"{by}); vs plain {err:.2e} (max abs {gap:.3e}); on {smi}")
    return rows


def phase_width_step(dc, smi, report):
    """The width-sharded GAN step on the card (`make_parallel_gan_train_step`
    and `make_fsdp_gan_train_step` with `shard_width=True`), on the parallel
    phase's seeded DA 32x128 state and b32 batch, the ranks all on the one
    H100 over gloo:
      - two ranks on a (1, 2) mesh (each all 32 rows and 64 of the 128
        columns) and, at the same time, four on a (2, 2) mesh under FSDP
        (min_bytes 1 MiB; each 16 rows and 64 columns): one GAN step against the
        single-process b32 step from the same weights and generator seed
        (the train golden's tolerances), K1/K2/K3 counted on each rank
        (20/24/20: the ring forms of K2 and K3 run the backward), every
        rank bit-equal after; then WIDTH_TIMING steps timed per rank (host
        clock; the collectives' share) and each rank's activation peak
        (`max_memory_allocated` during a step above `memory_allocated` just
        before it) against the single-process step's at b32;
      - on each rank of the (1, 2) ring, the ring backward kernels (K2/K3,
        and K7/K6 at the k=5 trunk) at each DA layer shape at 32x128 b32 on
        its shard, extended through the real halo exchange, against their
        plain versions and the whole-panorama kernels' columns;
      - NCCL at world size 1 under deterministic algorithms: with
        shard_width=True on the width-1 mesh (the data-parallel step, no
        width code, as `skyhdr`'s) bit-equal to the single-process step;
        with `ring_of_one` too (the width context on a ring of one: the
        width ops' halos from the shard's own opposite edge, their sums and
        the step's all-reduces through NCCL) against it at the train
        golden's tolerances;
      - each rank's activation peak below WIDTH_PEAK_RATIO of the single
        step's;
      - the ring backward kernels timed on a 1/2 shard (`width_ring_timing`).
    A rank that fails or hangs fails the phase."""
    mod = golden_tool()
    work = tempfile.mkdtemp(prefix="skyhdr_width_")
    out = report["width_step"] = {"device": smi}
    try:
        trees, _ = dp_trees()
        spec = dict(dp_spec(work), job="width")
        ref = dp_single(dc, mod, spec, trees)
        single_peak = single_act_peak(mod, spec, trees)
        out["single_act_peak_gib"] = single_peak / 2**30
        say("width_step", f"single-process b{DP_BATCH} GAN step: activation peak "
            f"{single_peak / 2**30:.3f} GiB (max_memory_allocated during the step above "
            f"memory_allocated before it); on {smi}")
        want = {k: GAN_LAUNCHES[k] for k in ("K1", "K2", "K3")}
        meshes = (("w1x2", 1, 2, {"ring_kernels": width_ring_cases()}), ("w2x2_fsdp", 2, 2, {}))
        t0 = time.perf_counter()
        launched, runs = {}, {}
        try:  # the two meshes' ranks at once (six processes on the one card)
            for name, data, width, extra in meshes:
                cwork = os.path.join(work, name)
                os.makedirs(cwork)
                case = {"name": name, "path": "batch", "timing": WIDTH_TIMING}
                if name.endswith("fsdp"):
                    case["fsdp"] = WIDTH_MIN_BYTES
                launched[name] = mod.DPRanks(dict(spec, world=data * width, data=data,
                                                  width=width, backend="gloo", cases=[case],
                                                  **extra), cwork)
            for name, ranks in launched.items():
                runs[name] = ranks.results(400)
        finally:
            for ranks in launched.values():
                ranks.stop()
        say("width_step", f"2 gloo ranks on a (1, 2) mesh and 4 on a (2, 2) mesh, at once: "
            f"run in {time.perf_counter() - t0:.3f} s wall")
        for name, data, width, _ in meshes:
            results = runs[name]
            per_rank = [r[name] for r in results]
            got = per_rank[0]
            fails, worst = mod.compare_dp_steps(ref, got, mod.DP_RTOL["golden"],
                                                kinds=("gan",))
            for metric, a, b in zip(ref["gan_metric_names"], got["gan_metrics"],
                                    ref["gan_metrics"]):
                say("width_step", f"{name} gan {metric}: width-sharded {a:.7g}, single "
                    f"process {b:.7g}")
            say("width_step", f"{name}: DA {DP_H}x{DP_W} b{DP_BATCH} width-sharded GAN step vs "
                f"the single-process step: worst relative {json.dumps(worst)} (metrics "
                f"{GOLDEN_METRIC_RTOL}, updates {GOLDEN_UPDATE_RTOL}, BN sums 1e-4)")
            for line in fails:
                say("width_step", f"FAIL {name}: {line}")
            check(not fails, f"{name} vs the single-process step: {len(fails)} mismatches")
            rows = []
            for rank, r in enumerate(per_rank):
                ratio = r["act_peak_gib"] * 2**30 / single_peak
                say("width_step", f"{name} rank {rank} {results[rank]['coords']}: launches "
                    f"{r['launches']} (want {want}); states bit-equal across ranks: "
                    f"{r['agree']}; step {r['gan_ms']:.3f} ms (median of {WIDTH_TIMING}, host "
                    f"clock, the 6 ranks of both meshes stepping on the one card; all "
                    f"{[round(t, 3) for t in r['gan_ms_all']]}), collectives "
                    f"{r['gan_comm_ms']:.3f} ms = {100 * r['gan_comm_share']:.2f}% of a step "
                    f"timed with each collective after the queued work; activation peak "
                    f"{r['act_peak_gib']:.3f} GiB = {ratio:.4f} of the single-process "
                    f"step's; on {smi}")
                check(r["launches"] == want, f"{name} rank {rank} launches {r['launches']}")
                check(r["agree"], f"{name}: the ranks' states differ after the step")
                check(r["width_context"], f"{name} rank {rank}: no width context")
                check(ratio < WIDTH_PEAK_RATIO[name], f"{name} rank {rank}: activation peak "
                      f"{ratio:.4f} of the single step's, not below {WIDTH_PEAK_RATIO[name]}")
                rows.append({k: r[k] for k in ("launches", "gan_ms", "gan_ms_all",
                                               "gan_comm_share", "gan_comm_ms",
                                               "act_peak_gib")} | {"act_peak_ratio": ratio})
            out[name] = {"worst": worst, "ranks": rows}
            for rank, res in enumerate(results):
                for row in res.get("ring_kernels", []):
                    k = row["name"]
                    tol = TOL["K2" if "k=5" not in k else "K7", torch.float32]
                    tol_k = TOL["K3" if "k=5" not in k else "K6", torch.float32]
                    say("width_step", f"{name} rank {rank} {k} (halo {row['halo']}): ring "
                        f"launches {row['launches']}; dx vs plain {row['dx_vs_plain']:.2e} "
                        f"(tol {tol}), vs the whole panorama's columns "
                        f"{row['dx_vs_whole']:.2e}; dK vs plain {row['dk_vs_plain']:.2e} (tol "
                        f"{tol_k}), vs the whole panorama's (g zero outside the shard) "
                        f"{row['dk_vs_whole']:.2e}")
                    for key, t in (("dx_vs_plain", tol), ("dx_vs_whole", tol),
                                   ("dk_vs_plain", tol_k), ("dk_vs_whole", tol_k)):
                        check(row[key] <= t, f"{name} rank {rank} {k}: {key} {row[key]:.3e}")
                    check(sum(row["launches"].values()) == 2,
                          f"{name} rank {rank} {k}: launches {row['launches']}")
                out.setdefault("ring_kernels", []).append(res.get("ring_kernels", []))
        t0 = time.perf_counter()
        os.makedirs(os.path.join(work, "nccl1"))
        results = mod.run_dp_ranks(
            dict(spec, world=1, data=1, width=1, backend="nccl", deterministic=True,
                 single=True, cases=[{"name": "nccl1", "path": "batch"},
                                     {"name": "nccl1_ring", "path": "batch",
                                      "ring_of_one": True}]),
            os.path.join(work, "nccl1"), timeout_s=300)
        got = results[0]["nccl1"]
        say("width_step", f"NCCL at world size 1, shard_width=True on a width-1 mesh (the "
            f"data-parallel step, no width context: {not got['width_context']}), "
            f"deterministic algorithms: the step bit-equal to the single-process step in the "
            f"same process: {got['single_equal']}; launches {got['launches']} (both cases run "
            f"in {time.perf_counter() - t0:.3f} s wall)")
        check(got["single_equal"], "nccl1: the width-sharded step differs from the "
              "single-process step")
        check(not got["width_context"], "nccl1: a width context on a width-1 mesh")
        check(got["launches"] == want, f"nccl1 launches {got['launches']}")
        out["nccl1_single_equal"] = got["single_equal"]
        # The width code under NCCL: the ring of one takes its halos from its
        # own opposite edge (no p2p); BatchNorm's sums, the batch maximum,
        # the gradients and the metrics go through NCCL's all-reduce.
        ring1 = results[0]["nccl1_ring"]
        fails, worst = mod.compare_dp_steps(ref, ring1, mod.DP_RTOL["golden"], kinds=("gan",))
        say("width_step", f"NCCL at world size 1, the width context on a ring of one "
            f"(ring_of_one; width context {ring1['width_context']}): launches "
            f"{ring1['launches']} (want {want}); vs the single-process step: worst relative "
            f"{json.dumps(worst)} (the train golden's tolerances); bit-equal to it: "
            f"{ring1['single_equal']} (not required)")
        for line in fails:
            say("width_step", f"FAIL nccl1_ring: {line}")
        check(not fails, f"nccl1_ring vs the single-process step: {len(fails)} mismatches")
        check(ring1["width_context"], "nccl1_ring: no width context")
        check(ring1["launches"] == want, f"nccl1_ring launches {ring1['launches']}")
        out["nccl1_ring"] = {"worst": worst, "launches": ring1["launches"]}
        out["timing"] = width_ring_timing(dc, smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


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


LIBRARY_RTOL = 1e-5


def phase_library(dc, report):
    """`skyhdr`'s op-library helpers on the card against the port's CPU
    results (see the module docstring, phase 17)."""
    from skyhdr_torch.models import layers
    from skyhdr_torch.ops import dog, geometry, hdr
    from skyhdr_torch.ops.distortion import DAConv, deformable_conv2d
    from skyhdr_torch.tools import make_synth_dataset
    from skyhdr_torch.utils import io, params, transplant

    rng = np.random.default_rng(19)
    rows = {}

    def held(name, fn, *arrays, grad=False, bitwise=False):
        """fn on the card and on the CPU from the same arrays: every output
        (and with `grad` the gradient of the outputs' sum of squares w.r.t.
        each input) within LIBRARY_RTOL of the max, or bitwise."""
        def run(dev):
            ins = [torch.from_numpy(a).to(dev).requires_grad_(grad) for a in arrays]
            out = fn(*ins)
            outs = list(out) if isinstance(out, (tuple, list)) else [out]
            if grad:
                gs = torch.autograd.grad(sum((o.float() ** 2).sum() for o in outs), ins)
                outs += list(gs)
            return [o.detach().cpu() for o in outs]

        got, want = run("cuda"), run("cpu")
        err = max(rel_err(g, w)[0] for g, w in zip(got, want))
        ok = (all(torch.equal(g, w) for g, w in zip(got, want)) if bitwise
              else err <= LIBRARY_RTOL)
        check(ok, f"library {name}: card vs CPU {err:.3e} of the max")
        rows[name] = err
        say("library", f"{name}: card vs CPU {err:.3e} of the max"
            f"{' (bitwise)' if bitwise else ''}")

    img = rng.uniform(0, 2, (32, 32, 128, 3)).astype(np.float32)
    tgt = rng.uniform(0, 2, (32, 32, 128, 3)).astype(np.float32)
    held("rgb2gray", hdr.rgb2gray, img)
    held("rgb2bgr / bgr2rgb", lambda x: (hdr.rgb2bgr(x), hdr.bgr2rgb(x)), img, bitwise=True)
    feat = rng.standard_normal((32, 32, 128, 64)).astype(np.float32)
    held("positional_encoding", lambda x: (geometry.positional_encoding(x),
                                           geometry.positional_encoding(x, with_r=True)), feat)
    bins = geometry.sunpose_bins(32, 128)
    sun_y = rng.uniform(2, 29, 32).astype(np.float32)
    held("vmf_pdf(bins=)", lambda y: geometry.vmf_pdf(63.0, y, 32, 128, bins=bins), sun_y)
    yc = torch.from_numpy(sun_y).cuda()
    check(torch.equal(geometry.vmf_pdf(63.0, yc, 32, 128, bins=bins),
                      geometry.vmf_pdf(63.0, yc, 32, 128)),
          "vmf_pdf with a precomputed table differs from its own")
    for mode in ("REFLECT", "SYMMETRIC", "CONSTANT"):
        held(f"gaussian_filter2d {mode}",
             lambda x, m=mode: dog.gaussian_filter2d(x, 3, 1.6, m), img, grad=True)
    # The pyramid's gradient; the loss's adds |.|'s sign, which flips where a
    # band difference rounds across zero on one device.
    held("dog_pyramid", dog.dog_pyramid, img, grad=True)
    held("dog_l1_loss_conv", dog.dog_l1_loss_conv, img, tgt)
    pc, tc = torch.from_numpy(img).cuda(), torch.from_numpy(tgt).cuda()
    e = rel_err(dog.dog_l1_loss_conv(pc, tc), dog.dog_l1_loss(pc, tc))[0]
    check(e <= LIBRARY_RTOL, f"dog_l1_loss_conv vs dog_l1_loss on the card: {e:.3e}")
    say("library", f"dog_l1_loss_conv vs dog_l1_loss on the card: {e:.3e} of the value")
    held("instance_moments", layers.instance_moments, feat)

    def module_held(name, make, x):
        """A module built on each device from one seeded Flax-layout tree,
        which the card's module exports back equal (weights carried both
        ways)."""
        tree = transplant.init_tree(make("meta"), np.random.default_rng(7))
        mods = {dev: transplant.load_model_vars(make(dev), tree) for dev in ("cpu", "cuda")}
        back = transplant.export_model_vars(mods["cuda"])
        flat = lambda t, p="": ([(p, t)] if not isinstance(t, dict) else
                                [kv for k in sorted(t) for kv in flat(t[k], f"{p}/{k}")])
        check([(k, v.tobytes()) for k, v in flat(back)] ==
              [(k, v.tobytes()) for k, v in flat(tree)], f"library {name}: export != import")
        held(name, lambda xx: mods[xx.device.type](xx), x, grad=True)

    module_held("conv (k3 s2)", lambda d: layers.conv(64, 32, 3, 2, device=d), feat)
    held("avgpool2 (odd 31x127)", layers.avgpool2, feat[:, :31, :127], grad=True)
    small = feat[:, :8, :32]
    module_held("FC2D", lambda d: layers.FC2D(8 * 32 * 64, 64, device=d), small)
    module_held("DFC2D", lambda d: layers.DFC2D(64, 8, 32, 3, device=d),
                rng.standard_normal((32, 1, 1, 64)).astype(np.float32))

    sd = {k: v.cuda() for k, v in layers.BatchNorm(64).state_dict().items()}
    sd["step"] = torch.tensor(3, device="cuda")
    cast = params.cast_floating({"modules": sd, "n": [torch.ones(2, device="cuda")]},
                                "bfloat16")
    check(cast["modules"]["step"].dtype == torch.int64
          and all(v.dtype == torch.bfloat16 for k, v in cast["modules"].items() if k != "step")
          and cast["n"][0].dtype == torch.bfloat16, "cast_floating dtypes")
    crf = io.make_synthetic_dorf(8, 1024)
    inv = np.stack([io.inverse_rf(c) for c in crf])
    grid = np.linspace(0, 1, 1024)
    e = max(np.abs(np.interp(np.interp(grid, grid, c), grid, i) - grid).max()
            for c, i in zip(crf, inv))
    check(e < 5e-2, f"inverse_rf does not invert its curves: {e:.3e}")
    say("library", f"cast_floating on a state_dict: dtypes held; inverse_rf(c)(c(x)) - x "
        f"at most {e:.3e} over 8 curves")

    # The DA conv at stride 1 (K1 once), and the stride that raises.
    x = torch.from_numpy(rng.standard_normal((32, 32, 128, 64)).astype(np.float32)).cuda()
    da = DAConv(64, 32, device="cuda")
    transplant.load_model_vars(da, transplant.init_tree(da, np.random.default_rng(3)))
    reset_counts(dc)
    with torch.no_grad():
        y = da(x)
    got = counts(dc)
    check(got == launches(K1=1), f"a stride-1 DAConv launched {got}")
    with torch.no_grad():
        e = rel_err(y, deformable_conv2d(x, da.kernel, da.bias))[0]
    check(e <= TOL["K1", torch.float32], f"DAConv vs the plain DA conv: {e:.3e}")
    for make in (lambda: DAConv(64, 32, strides=2, device="cuda"),
                 lambda: deformable_conv2d(x, da.kernel, da.bias, stride=2)):
        try:
            make()
        except ValueError as err:
            check("stride" in str(err) and "skyhdr" in str(err), f"stride error: {err}")
        else:
            check(False, "a DA conv at stride 2 did not raise")
    say("library", f"DAConv stride 1 at 32x128x64 b32 -> 32: K1 x1, {e:.3e} of the max vs "
        f"plain; stride 2 raises ValueError")

    # The synthetic-sky writer, read back by the pipeline.
    from skyhdr_torch.data.pipeline import PanoramaDataset
    from skyhdr_torch.data.records import read_tfrecord_examples

    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        make_synth_dataset.main(["--out", tmp, "--n-train", "64", "--n-test", "16"])
        write_s = time.perf_counter() - t
        draw = np.random.default_rng(0)
        for ex in read_tfrecord_examples(os.path.join(tmp, "train")):
            want, sun_y = make_synth_dataset.synth_panorama(draw, 32, 128)
            check(ex["image"] == want[:, :, ::-1].tobytes()
                  and float(np.asarray(ex["elevation"]).reshape(-1)[0]) == np.float32(sun_y),
                  "a written record differs from its draw")
        ds = PanoramaDataset(os.path.join(tmp, "train"), imshape=(32, 128, 3), batch_size=32,
                             shuffle=False)
        batches = list(ds)
        check(len(batches) == 2 and all(b["hdr"].shape == (32, 32, 128, 3)
                                        and np.isfinite(b["hdr"]).all() for b in batches),
              "the pipeline did not read the synthetic set back")
    say("library", f"make_synth_dataset: 64 + 16 panoramas at 32x128 written in {write_s:.2f} s, "
        f"read back equal to their draws, 2 batches of 32 from the pipeline")
    report["library"] = rows


def phase_draws(report):
    """`--seed`'s draws on the card: the entry points' DA 16x64 draw against
    `skyhdr`'s fixture, the DA 64x256 states' draw timed, and a step's
    degradation draw timed at 64x256 (phase 18 of the module doc)."""
    from skyhdr_torch.config import Config, DataConfig, ModelConfig
    from skyhdr_torch.data.degradation import draw_degradation, make_banks
    from skyhdr_torch.train.engine import create_gan_state, create_sun_state
    from skyhdr_torch.utils import jax_random
    from skyhdr_torch.utils.io import get_exposure_lists, make_synthetic_dorf

    mod = golden_tool()
    with np.load(mod.DRAWS_FIXTURE) as stored:
        t0 = time.perf_counter()
        fails = mod.compare_draws(stored, mod.port_draws("cuda"))
        n_leaves = len(stored["w_names"])
    say("draws", f"DA 16x64 seed 0 on the card: {n_leaves} weight leaves of the GAN and SUN "
        f"states and the first step's degradation draws against skyhdr's "
        f"({os.path.basename(mod.DRAWS_FIXTURE)}): {fails or 'all within bounds'} "
        f"({time.perf_counter() - t0:.3f} s)")
    check(not fails, f"the card's draw is not skyhdr's: {fails}")
    out = {"fixture_fails": fails}
    cfg = Config(model=ModelConfig(im_height=64, im_width=256, use_da_conv=True),
                 data=DataConfig(batch_size=64))
    for kind, make in (("gan", create_gan_state), ("sun", create_sun_state)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state = make(cfg, 0, "cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        params = [p for m in state.modules().values() for p in m.parameters()]
        n = sum(p.numel() for p in params)
        finite = all(bool(torch.isfinite(p).all()) for p in params)
        say("draws", f"DA 64x256 {kind.upper()} state (create_{kind}_state, seed 0): "
            f"{n} parameters drawn on the card in {secs:.3f} s (host clock, synchronised); "
            f"finite {finite}")
        check(finite, f"the {kind} state's draw is not finite")
        out[f"{kind}_state_s"], out[f"{kind}_params"] = secs, n
        del state, params
        free_cuda()
    banks = make_banks(make_synthetic_dorf(175, 1024), get_exposure_lists()[0], device="cuda")
    key = jax_random.key(0)
    for kind, b in (("gan", 64), ("sun", 32)):
        times = time_ms(lambda: draw_degradation(key, (b, 64, 256, 3), banks))
        out[f"{kind}_step_draw_ms"] = statistics.median(times)
        say("draws", f"degradation draw of a {kind} step at 64x256 b{b}: "
            f"{out[f'{kind}_step_draw_ms']:.4f} ms (CUDA events, median of {ITERS}, spread "
            f"{min(times):.4f}-{max(times):.4f})")
    report["draws"] = out


def _opt_members(opt):
    names = ("params", *opt.MOMENTS) + (("master",) if opt.master is not None else ())
    return {name: getattr(opt, name) for name in names}


def update_bytes(opts) -> int:
    """The bytes an update with float32 gradients must move: each parameter
    (or its master), moment and gradient read once, each parameter, master
    and moment written once (a bfloat16 parameter under a master only
    written)."""
    total = 0
    for opt in opts:
        for i, p in enumerate(opt.params):
            n = p.numel()
            total += 12 * n  # the float32 gradient and weights read, the weights written
            total += n * p.element_size() if opt.master is not None else 0
            total += sum(2 * n * getattr(opt, m)[i].element_size() for m in opt.MOMENTS)
    return total


def phase_optim(smi, report):
    """K13 at the DA 64x256 states against the eager chain, bit for bit over
    three steps, then timed (phase 19 of the module doc)."""
    import copy

    from skyhdr_torch.config import Config, DataConfig, ModelConfig
    from skyhdr_torch.ops.kernels import optim as ok
    from skyhdr_torch.train.engine import create_gan_state, create_sun_state

    cfg = Config(model=ModelConfig(im_height=64, im_width=256, use_da_conv=True),
                 data=DataConfig(batch_size=8))
    out = {}
    for kind, make in (("sun", create_sun_state), ("gan", create_gan_state)):
        state = make(cfg, 0, "cuda")
        opts = list(state.optimizers().values())
        twins = [copy.deepcopy(o) for o in opts]
        leaves = sum(len(o.params) for o in opts)
        gen = torch.Generator(device="cuda").manual_seed(7)

        def draw():
            return [[(torch.randn(p.shape, device="cuda", generator=gen)
                      * 10.0 ** (torch.rand(p.shape, device="cuda", generator=gen) * 6 - 4))
                     for p in o.params] for o in opts]

        max_gap, differing = 0.0, 0
        for i in range(3):
            grads = draw()
            n0 = ok.K13_LAUNCHES
            for o, t, g in zip(opts, twins, grads):
                o.step(g)
                t.step_plain(g)
            torch.cuda.synchronize()
            check(ok.K13_LAUNCHES - n0 == leaves,
                  f"{kind}: {ok.K13_LAUNCHES - n0} K13 launches for {leaves} leaves")
            for o, t in zip(opts, twins):
                for name, xs in _opt_members(o).items():
                    for x, y in zip(xs, _opt_members(t)[name]):
                        if not torch.equal(x, y):
                            differing += int((x != y).sum())
                            max_gap = max(max_gap, (x.float() - y.float()).abs().max().item())
            del grads
        what = " + ".join(f"{type(o).__name__} ({len(o.params)} leaves)" for o in opts)
        say("optim", f"DA 64x256 {kind.upper()} state, {what}: 3 steps of K13 against the "
            f"eager chain, every parameter and moment: {differing} elements differ, largest "
            f"gap {max_gap:.3e}")
        check(differing == 0, f"{kind}: K13 is not the eager chain's bits ({differing} "
              f"elements, largest gap {max_gap:.3e})")
        grads = draw()

        def kernel():
            for o, g in zip(opts, grads):
                o.step(g)

        def plain():
            for t, g in zip(twins, grads):
                t.step_plain(g)

        ms, plain_ms = paired_ms(kernel, plain)
        queued = statistics.median(time_ms(kernel, ITERS // 2, queued=True))
        nbytes = update_bytes(opts)
        bound = nbytes / 3.35e12 * 1e3
        row = {"leaves": leaves, "elements": sum(p.numel() for o in opts for p in o.params),
               "ms": ms, "ms_queued": queued, "plain_ms": plain_ms, "bound_ms": bound,
               "bytes": nbytes, "max_gap": max_gap, "library_ms": None}
        lib = ""
        if kind == "sun":
            # The yardstick: one fused PyTorch Adam step on the twin's leaves.
            params = [t.params for t in twins][0]
            for p, g in zip(params, grads[0]):
                p.grad = g
            fused_adam = torch.optim.Adam(params, lr=twins[0].lr, betas=(0.9, 0.999),
                                          eps=1e-7, fused=True)
            row["library_ms"] = statistics.median(time_ms(fused_adam.step, ITERS // 2))
            lib = f", torch.optim.Adam(fused=True) {row['library_ms']:.4f} ms"
            del fused_adam
        say("optim", f"DA 64x256 {kind.upper()} update alone ({row['elements']} elements, "
            f"{leaves} launches): K13 {ms:.4f} ms ({queued:.4f} ms with device work queued "
            f"ahead), eager chain {plain_ms:.4f} ms{lib}; bound {bound:.4f} ms "
            f"({nbytes / 1e9:.3f} GB at 3.35 TB/s, {100 * bound / ms:.1f}% of it); on {smi}")
        out[kind] = row
        del state, opts, twins, grads
        free_cuda()
    report["optim"] = out
    return out


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
    k3_trees.cache_clear()
    timed("convert", phase_convert, dc, smi, report)
    timed("parallel", phase_parallel, dc, smi, report)
    timed("fsdp", phase_fsdp, dc, smi, report)
    spatial = timed("spatial", phase_spatial, dc, smi, report)
    width = timed("width_step", phase_width_step, dc, smi, report)
    probes = timed("probes", phase_probes, dc, smi, report)
    timed("library", phase_library, dc, report)
    timed("draws", phase_draws, report)
    optim = timed("optim", phase_optim, smi, report)

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
        if kern in ("K1", "K5"):
            # The same kernel on width shards (parallel/spatial.py): one launch
            # a ring call on each rank, over `ring_window_tables`.
            k = 3 if kern == "K1" else 5
            calls = {n: c["launches"] for n, c in spatial["cases"].items()
                     if "launches" in c}
            kernels[-1]["width_shards"] = {
                "route": "cuda", "source": "skyhdr_torch/parallel/spatial.py",
                "launches_per_call": sorted({r[kern] for n, c in calls.items() for r in c
                                             if r[kern]}),
                "calls": sum(1 for n, c in spatial["cases"].items()
                             if c.get("launches") and c["launches"][0][kern]),
                "timed": [{key: row[key] for key in ("layer", "x", "f", "ms", "plain_ms",
                                                     "whole_ms", "bound_ms")}
                          for row in spatial["timing"] if row["k"] == k]}
        if kern in ("K2", "K3", "K6", "K7"):
            # Its ring form (`da_conv_dx_ring` / `da_conv_dk_ring`): the
            # width-sharded GAN step's backward on each rank's extended
            # shard (K2/K3; K7/K6 checked and timed at the k=5 trunk).
            kernels[-1]["width_shards"] = {
                "route": "cuda", "source": "skyhdr_torch/ops/kernels/deform_conv.py",
                "launches_per_rank_step": sorted({r["launches"].get(kern, 0)
                                                  for name in ("w1x2", "w2x2_fsdp")
                                                  for r in width[name]["ranks"]}),
                "max_err_vs_plain": max(row[key] for rows in width["ring_kernels"]
                                        for row in rows
                                        for key in (("dx_vs_plain",) if kern in ("K2", "K7")
                                                    else ("dk_vs_plain",))
                                        if (row["name"].endswith("k=5")) == (kern in ("K6",
                                                                                      "K7"))),
                "timed": [{key: row[key] for key in ("layer", "x", "f", "ms", "plain_ms",
                                                     "whole_ms", "bound_ms", "bound_by")}
                          for row in width["timing"] if row["kernel"] == kern]}
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
    sun, gan = optim["sun"], optim["gan"]
    kernels.append({
        "name": "K13 optim_kernel<ADAM, G, MASTER, MU, NU> (the optimizer update, one pass "
                "a leaf)", "route": "cuda", "source": "skyhdr_torch/csrc/optim.cu",
        "replaces": "skyhdr/train/engine.py:158 (_adam) and :150 (_rmsprop): optax's update, "
                    "fused by XLA under jit; no pl.pallas_call",
        "launches": launches["gan"]["K13"], "max_abs_err": max(sun["max_gap"], gan["max_gap"]),
        "ms": sun["ms"], "plain_ms": sun["plain_ms"], "bound_ms": sun["bound_ms"],
        "bound_by": "bytes", "library_ms": sun["library_ms"],
        "gan_update": {key: gan[key] for key in ("ms", "plain_ms", "bound_ms", "leaves")},
        "launches_sun": launches["sun"]["K13"],
        "per": "one Adam update of the DA 64x256 SUN state (gan_update: the GAN state's two "
               "RMSprop updates, one train step's); library: torch.optim.Adam(fused=True) on "
               "the same leaves; launches: the 3 GAN steps of the training phase (one a "
               "leaf; launches_sun: its 2 sun steps)"})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
