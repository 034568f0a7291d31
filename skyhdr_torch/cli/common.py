"""Shared CLI plumbing (`skyhdr.cli.common`): flags -> Config, datasets,
degradation banks, VGG weights, str2bool."""

from __future__ import annotations

import argparse
import glob
import os

from skyhdr_torch.config import Config, DataConfig, ModelConfig, TrainConfig


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def add_common_flags(parser: argparse.ArgumentParser):
    """Every flag of `skyhdr.cli.common.add_common_flags`, plus `--device`.
    `--steps-per-dispatch` takes 1 (`config_from_args` raises
    NotImplementedError for another value); `--compilation-cache` is the
    XLA runtime's and does nothing here."""
    cwd = os.getcwd()
    parser.add_argument("--dir", type=str, default=None,
                        help="tfrecord dataset root (with train/ and test/)")
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--batchsize", type=int, default=32)
    parser.add_argument("--epochs", type=int, default=1000)
    parser.add_argument("--imheight", type=int, default=32)
    parser.add_argument("--imwidth", type=int, default=128)
    parser.add_argument("--dorf", type=str,
                        default=os.path.join(cwd, "dorfCurves.txt"))
    parser.add_argument("--vgg", type=str,
                        default=os.path.join(cwd, "vgg16.npy"))
    parser.add_argument("--da-conv", type=str2bool, default=False,
                        help="use the distortion-aware equirect conv")
    parser.add_argument("--compute-dtype", type=str, default="float32",
                        choices=("float32", "bfloat16"),
                        help="conv-stack compute dtype (radiance head, "
                             "softmax and norms stay f32)")
    parser.add_argument("--opt-state-dtype", type=str, default="float32",
                        choices=("float32", "bfloat16"),
                        help="optimizer-moment storage dtype: bfloat16 "
                             "halves the optimizer slice of device memory "
                             "and checkpoint bytes (update math stays f32; "
                             "measured quality-free in skyhdr's one-knob DA "
                             "ablation — see BASELINE.md)")
    parser.add_argument("--grad-dtype", type=str, default="float32",
                        choices=("float32", "bfloat16"),
                        help="gradient staging dtype: bfloat16 casts the "
                             "gradients before the optimizer update (update "
                             "math stays f32; costs ~1-2 dB PSNR in skyhdr's "
                             "one-knob DA ablation — prefer --opt-state-dtype "
                             "for memory relief; see BASELINE.md)")
    parser.add_argument("--param-dtype", type=str, default="float32",
                        choices=("float32", "bfloat16"),
                        help="stored model-parameter dtype for training: "
                             "bfloat16 streams half-width params through the "
                             "forward/backward while the optimizer keeps an "
                             "f32 master copy in its state (update math and "
                             "accumulation stay f32; see "
                             "TrainConfig.param_dtype)")
    parser.add_argument("--streaming", type=str2bool, default=None,
                        help="stream TFRecords with a windowed shuffle "
                             "buffer instead of caching the split in RAM "
                             "(default: auto — stream when the decoded "
                             "split would exceed ~2 GB)")
    parser.add_argument("--shuffle-buffer", type=int, default=10000,
                        help="streaming shuffle window (reference "
                             "train.py:129)")
    parser.add_argument("--workdir", type=str, default=cwd)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--ckpt-every", type=int, default=10,
                        help="checkpoint save cadence in epochs "
                             "(reference train.py:516)")
    parser.add_argument("--steps-per-dispatch", type=int, default=1,
                        help="train steps per dispatch; the port runs one "
                             "(other values raise NotImplementedError)")
    parser.add_argument("--compilation-cache", type=str, default=None,
                        metavar="DIR",
                        help="accepted for command lines of the JAX "
                             "package (its persistent XLA compilation "
                             "cache); does nothing here")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on")
    return parser


def config_from_args(args) -> Config:
    """The Config of the `add_common_flags` flags. Raises
    NotImplementedError for what the port does not run: more than one step
    per dispatch."""
    cfg = Config(
        model=ModelConfig(im_height=args.imheight, im_width=args.imwidth,
                          use_da_conv=args.da_conv,
                          compute_dtype=args.compute_dtype),
        data=DataConfig(batch_size=args.batchsize,
                        dataset_dir=args.dir or os.path.join(
                            args.workdir,
                            f"dataset_{args.imwidth}_{args.imheight}/tfrecord")),
        train=TrainConfig(learning_rate=args.lr, epochs=args.epochs,
                          vgg_path=args.vgg, ckpt_every_epochs=args.ckpt_every,
                          opt_state_dtype=args.opt_state_dtype,
                          grad_dtype=args.grad_dtype,
                          param_dtype=args.param_dtype,
                          steps_per_dispatch=args.steps_per_dispatch,
                          seed=args.seed),
    )
    if cfg.train.steps_per_dispatch != 1:
        raise NotImplementedError(
            f"--steps-per-dispatch {cfg.train.steps_per_dispatch}: the port "
            "runs one step per dispatch")
    return cfg


_STREAM_THRESHOLD_BYTES = 2 << 30  # cache below ~2 GB decoded, stream above


def make_dataset(args, cfg: Config, split_dir: str, *, shuffle: bool,
                 seed: int = 0, log=print):
    """The input dataset of one split: the in-RAM cached PanoramaDataset
    for small splits, the constant-memory StreamingPanoramaDataset
    (windowed shuffle buffer) when the decoded split would not fit
    comfortably or when --streaming true is passed."""
    from skyhdr_torch.data.pipeline import PanoramaDataset, StreamingPanoramaDataset

    streaming = args.streaming
    if streaming is None:
        # Sized from the bytes on disk (~ decoded bytes / 2, gzip).
        disk = sum(os.path.getsize(p) for p in
                   glob.glob(os.path.join(split_dir, "*.tfrecord")))
        streaming = disk * 2 > _STREAM_THRESHOLD_BYTES
    if streaming:
        log(f"[skyhdr_torch] streaming {split_dir} (shuffle buffer {args.shuffle_buffer})")
        return StreamingPanoramaDataset(
            split_dir, imshape=cfg.model.imshape,
            batch_size=cfg.data.batch_size, shuffle=shuffle,
            shuffle_buffer=args.shuffle_buffer, seed=seed)
    return PanoramaDataset(split_dir, imshape=cfg.model.imshape,
                           batch_size=cfg.data.batch_size, shuffle=shuffle,
                           seed=seed)


def load_banks(cfg: Config, dorf_path: str, train: bool = True, device="cuda",
               log=print):
    """DoRF curves + exposure sweep on `device`; the synthetic CRF family
    when dorfCurves.txt is absent (it is gitignored in the reference too)."""
    from skyhdr_torch.data.degradation import make_banks
    from skyhdr_torch.utils.io import (get_exposure_lists, load_dorf_curves,
                                       make_synthetic_dorf)

    train_t, test_t = get_exposure_lists(cfg.data.n_train_exposures,
                                         cfg.data.n_test_exposures)
    if dorf_path and os.path.exists(dorf_path):
        train_crf, test_crf = load_dorf_curves(dorf_path)
    else:
        log(f"[skyhdr_torch] {dorf_path!r} not found; using the synthetic CRF "
            f"family (see skyhdr_torch.utils.io.make_synthetic_dorf)")
        crf = make_synthetic_dorf(201, 1024)
        train_crf, test_crf = crf[:175], crf[175:]
    return make_banks(train_crf if train else test_crf,
                      train_t if train else test_t, device=device)


def restore_model_vars(cfg: Config, workdir: str, *, sky: str = None,
                       sun: str = None, seed: int = 0, device="cuda", log=print):
    """(Generator, SunPoseNet) for serving (`skyhdr.cli.common.
    restore_model_vars`), built by `build_models` on `device`: the newest
    SKY checkpoint under `<workdir>/<checkpoint_dir>/SKY` (or `sky`), its
    sun-pose net then replaced by the newest SUN checkpoint's (`sun`).
    The seeded weights of `init_model_vars(cfg, seed)` are drawn only when
    no SKY checkpoint exists (rounded to bfloat16 under `--param-dtype
    bfloat16`, as `skyhdr`'s `create_gan_state` stores them). A checkpoint
    of any `param_dtype` serves: its stored parameters load exactly. A
    checkpoint is read to the host and only the serving modules' parameters
    and buffers reach the device; the optimizer moments (2 x 3.2 GB of
    sun-pose FC at 64x256) never do."""
    import torch

    from skyhdr_torch.train.checkpoints import CheckpointManager
    from skyhdr_torch.train.engine import build_models
    from skyhdr_torch.utils.transplant import init_model_vars, load_model_vars

    gen, sun_net = build_models(cfg, device)

    def latest(ckpt_dir):
        if not os.path.isdir(ckpt_dir):
            return None
        blob = CheckpointManager(ckpt_dir, cfg.train.ckpt_max_to_keep).read_latest()
        return None if blob is None else blob["modules"]

    root = os.path.join(workdir, cfg.train.checkpoint_dir)
    modules = latest(sky or os.path.join(root, "SKY"))
    if modules is not None:
        gen.load_state_dict(modules["gen"])
        sun_net.load_state_dict(modules["sun"])
        log("Latest SKY checkpoint restored")
    else:
        gen_vars, sun_vars = init_model_vars(cfg, seed)
        load_model_vars(gen, gen_vars)
        load_model_vars(sun_net, sun_vars)
        if cfg.train.param_dtype == "bfloat16":
            with torch.no_grad():
                for p in (*gen.parameters(), *sun_net.parameters()):
                    p.copy_(p.to(torch.bfloat16))
    del modules
    # The SUN -> SKY hand-off's key handling (`engine.replace_sun_params`):
    # a SUN checkpoint holds the sun-pose net's state_dict under
    # modules/sun.
    modules = latest(sun or os.path.join(root, "SUN"))
    if modules is not None:
        sun_net.load_state_dict(modules["sun"])
        log("Latest SUN checkpoint restored")
    return gen, sun_net


def load_vgg(path: str, log=print):
    """The VGG16 weights of `path`, else the deterministic random stand-in."""
    from skyhdr_torch.models.vgg16 import load_vgg16_npy, random_vgg16_weights

    if path and os.path.exists(path):
        return load_vgg16_npy(path)
    log(f"[skyhdr_torch] {path!r} not found; using deterministic random frozen "
        f"VGG features (perceptual loss still well-defined)")
    return random_vgg16_weights()
