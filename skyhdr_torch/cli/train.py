"""GAN training entry point (`skyhdr.cli.train`, reference train.py), on a
CUDA card by default.

Reads `<dir>/train` and `<dir>/test` TFRecords, runs the GAN step through
`TrainLoop` with an eval pass per epoch, TensorBoard scalars under
`<workdir>/tensorboard/SKY/` and a checkpoint every `--ckpt-every` epochs
under `<workdir>/checkpoints/SKY/` (torch format, not Orbax). A rerun
resumes from the newest SKY checkpoint; a fresh start takes the sun-pose
weights of the newest SUN checkpoint, if there is one.

Example:
  python -m skyhdr_torch.cli.train --dir dataset_128_32/tfrecord --epochs 1000
"""

from __future__ import annotations

import argparse
import os

from skyhdr_torch.cli.common import (add_common_flags, config_from_args, load_banks,
                                     load_vgg, make_dataset)
from skyhdr_torch.train.checkpoints import CheckpointManager
from skyhdr_torch.train.engine import (create_gan_state, make_gan_eval_step,
                                       make_gan_train_step, replace_sun_params)
from skyhdr_torch.train.loop import TrainLoop


def main(argv=None):
    parser = argparse.ArgumentParser(description="train the SKY GAN model (PyTorch)")
    add_common_flags(parser)
    parser.add_argument("--sky", type=str, default=None,
                        help="parsed for command lines of the JAX package, "
                             "which reads it nowhere either: a rerun "
                             "resumes from <workdir>/checkpoints/SKY")
    parser.add_argument("--sun", type=str, default=None,
                        help="pretrained SUN checkpoint dir to restore the "
                             "sun net from before fine-tuning (default: "
                             "<workdir>/checkpoints/SUN)")
    args = parser.parse_args(argv)

    cfg = config_from_args(args)
    device = args.device
    banks_train = load_banks(cfg, args.dorf, train=True, device=device)
    vgg = load_vgg(args.vgg)

    train_ds = make_dataset(args, cfg, os.path.join(cfg.data.dataset_dir, "train"),
                            shuffle=True, seed=args.seed)
    test_ds = make_dataset(args, cfg, os.path.join(cfg.data.dataset_dir, "test"),
                           shuffle=False)

    train_step = make_gan_train_step(cfg, banks_train, vgg)
    eval_step = make_gan_eval_step(cfg, load_banks(cfg, args.dorf, train=False,
                                                   device=device), vgg)

    loop = TrainLoop(cfg, "SKY", lambda: create_gan_state(cfg, args.seed, device),
                     train_step, eval_step, train_ds, test_ds,
                     workdir=args.workdir, device=device)

    # Cross-stage SUN weight hand-off (reference train.py:223-230), only on
    # a fresh start: a SKY resume already carries fine-tuned sun weights.
    # The SUN checkpoint (of any param_dtype, as `skyhdr` tries each
    # template) is read to the host and only its sun-pose parameters are
    # copied in; under --param-dtype bfloat16 they also refresh the
    # optimizer's float32 master (`replace_sun_params`).
    sun_dir = args.sun or os.path.join(args.workdir, cfg.train.checkpoint_dir, "SUN")
    if not loop.resumed and os.path.isdir(sun_dir):
        blob = CheckpointManager(sun_dir, cfg.train.ckpt_max_to_keep).read_latest()
        if blob is not None:
            loop.state = replace_sun_params(cfg, loop.state, blob["modules"]["sun"])
            print("Pretrained SUN checkpoint restored for fine-tuning")
    loop.run(epochs=cfg.train.epochs, rng_seed=args.seed)


if __name__ == "__main__":
    main()
