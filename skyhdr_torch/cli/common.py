"""Shared CLI plumbing (`skyhdr.cli.common`): the serving flags -> Config."""

from __future__ import annotations

import argparse

from skyhdr_torch.config import Config, ModelConfig


def str2bool(v) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def add_model_flags(parser: argparse.ArgumentParser):
    """The model and runtime flags the port's CLIs share."""
    parser.add_argument("--imheight", type=int, default=32)
    parser.add_argument("--imwidth", type=int, default=128)
    parser.add_argument("--da-conv", type=str2bool, default=False,
                        help="use the distortion-aware equirect conv")
    parser.add_argument("--compute-dtype", type=str, default="float32",
                        choices=("float32", "bfloat16"),
                        help="conv-stack compute dtype (norm statistics, the "
                             "sun-pose softmax and the radiance head stay "
                             "float32)")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the weights (utils.transplant."
                             "init_model_vars)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device to run on")
    return parser


def config_from_args(args) -> Config:
    return Config(model=ModelConfig(im_height=args.imheight,
                                    im_width=args.imwidth,
                                    use_da_conv=args.da_conv,
                                    compute_dtype=args.compute_dtype))
