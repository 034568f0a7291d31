"""Sun-pose pretraining entry point (`skyhdr.cli.train_sun`, reference
train_sun.py), on a CUDA card by default.

--train true  : pretrain SunPoseNet with the KL + DoG loss through
                `TrainLoop("SUN", ...)`, checkpoints under
                `<workdir>/checkpoints/SUN/`, and per-epoch Grad-CAM PNG
                dumps (reference train_sun.py:329-373).
--train false : eval/visualization mode on .hdr files: degrade each with the
                train banks, run the sun-pose net with its Grad-CAM maps and
                save the six-panel figure (train_sun.py:393-471). The
                sun-pose weights are the newest SUN checkpoint's, else the
                `--seed` ones.

Example:
  python -m skyhdr_torch.cli.train_sun --dir dataset_128_32/tfrecord --epochs 100
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from skyhdr_torch.cli.common import (add_common_flags, config_from_args, load_banks,
                                     make_dataset, str2bool)
from skyhdr_torch.ops.resize import resize_bilinear
from skyhdr_torch.train.engine import (create_sun_state, make_sun_eval_step,
                                       make_sun_train_step)
from skyhdr_torch.train.loop import TrainLoop
from skyhdr_torch.utils import jax_random


def cam_gated_prediction(sm: torch.Tensor, cams, h: int, w: int):
    """(pred, sum_pred), each [h, w], of the first image: the sun-pose PDF
    `sm` [b, h*w] as an image, and the CAM-gated prediction
    cam1 * resize(cam2) * pred, max-normalised (reference
    train_sun.py:445-447)."""
    pred = sm.reshape(-1, h, w)[0].float()
    cam2_up = resize_bilinear(cams[1], (h, w))[0, ..., 0]
    sum_pred = cams[0][0, ..., 0] * cam2_up * pred
    return pred, sum_pred / (sum_pred.max() + 1e-5)


def restore_sun_net(cfg, workdir: str, seed: int = 0, device="cuda", log=print):
    """The serving SunPoseNet on `device`: the newest SUN checkpoint's, read
    to the host so that Adam's moments never reach the device, else the
    sun-pose weights of `skyhdr`'s `create_sun_state(cfg, PRNGKey(seed))`
    (`train.engine.create_sun_state`)."""
    from skyhdr_torch.models.sunpose import SunPoseNet
    from skyhdr_torch.train.checkpoints import CheckpointManager
    from skyhdr_torch.utils.transplant import draw_model_vars

    sun = SunPoseNet(cfg.model, device=device).eval().requires_grad_(False)
    blob = CheckpointManager(os.path.join(workdir, cfg.train.checkpoint_dir, "SUN"),
                             cfg.train.ckpt_max_to_keep).read_latest()
    if blob is not None:
        sun.load_state_dict(blob["modules"]["sun"])
        log("Latest SUN checkpoint restored")
    else:
        draw_model_vars(sun, jax_random.key(seed))
    return sun


def main(argv=None):
    parser = argparse.ArgumentParser(description="pretrain the sun-pose net (PyTorch)")
    add_common_flags(parser)
    parser.add_argument("--train", type=str2bool, default=True)
    parser.add_argument("--inference_img_dir", type=str, default=None,
                        help=".hdr directory for --train false eval mode")
    parser.add_argument("--outputimg-every", type=int, default=1,
                        help="dump CAM grids every N epochs (0 disables)")
    args = parser.parse_args(argv)

    cfg = config_from_args(args)
    device = torch.device(args.device)
    banks = load_banks(cfg, args.dorf, train=True, device=device)

    if args.train:
        train_ds = make_dataset(args, cfg, os.path.join(cfg.data.dataset_dir, "train"),
                                shuffle=True, seed=args.seed)
        test_ds = make_dataset(args, cfg, os.path.join(cfg.data.dataset_dir, "test"),
                               shuffle=False)
        train_step = make_sun_train_step(cfg, banks)
        eval_step = make_sun_eval_step(cfg, load_banks(cfg, args.dorf, train=False,
                                                       device=device))

        out_dir = os.path.join(args.workdir, "outputImg", "SUN")
        epoch_hook = None
        if args.outputimg_every:
            from skyhdr_torch.utils.io import write_hdr
            from skyhdr_torch.utils.vis import save_image_grid

            # Per-epoch dumps of the LAST eval batch, the reference's set:
            # sun_cam1/2/3 + pred + sungt grids (train_sun.py:363-373), and
            # the batch's ground-truth HDRs once, after the first epoch
            # (train_sun.py:353-359).
            def epoch_hook(epoch, outputs, batch):
                if epoch % max(args.outputimg_every, 1) != 0:
                    return
                val = os.path.join(out_dir, "val")
                for name, imgs in [("pred", outputs["pred"]),
                                   ("sungt", outputs["gt"]),
                                   ("sun_cam1", outputs["cams"][0]),
                                   ("sun_cam2", outputs["cams"][1]),
                                   ("sun_cam3", outputs["cams"][2])]:
                    save_image_grid(imgs.float().cpu().numpy(),
                                    os.path.join(val, name, f"epoch{epoch}.png"))
                gt_dir = os.path.join(out_dir, "groundTruth")
                if not os.path.isdir(gt_dir) or not os.listdir(gt_dir):
                    os.makedirs(gt_dir, exist_ok=True)
                    for i, hdr in enumerate(batch["hdr"].float().cpu().numpy()):
                        write_hdr(os.path.join(gt_dir, f"{i}_gt.hdr"), hdr)

        # A factory, not a state: TrainLoop draws the seeded weights only on
        # a fresh start.
        loop = TrainLoop(cfg, "SUN", lambda: create_sun_state(cfg, args.seed, device),
                         train_step, eval_step, train_ds, test_ds,
                         workdir=args.workdir, epoch_hook=epoch_hook, device=device)
        loop.run(epochs=cfg.train.epochs, rng_seed=args.seed)
        return

    # ----- eval/visualization mode (reference train_sun.py:393-471) -----
    from skyhdr_torch.data.degradation import degrade_batch
    from skyhdr_torch.models.gradcam import sunpose_with_cams
    from skyhdr_torch.utils.io import read_hdr
    from skyhdr_torch.utils.vis import save_eval_panel

    if not args.inference_img_dir:
        raise SystemExit("error: --inference_img_dir is required with --train false")
    sun = restore_sun_net(cfg, args.workdir, args.seed, device)
    out_dir = os.path.join(args.workdir, "outputImg", "SUN", "eval")
    h, w = cfg.model.im_height, cfg.model.im_width
    key = jax_random.key(args.seed)
    for path in sorted(glob.glob(os.path.join(args.inference_img_dir, "*.hdr"))):
        hdr = read_hdr(path)
        hdr = 0.5 * hdr / (hdr.mean() + 1e-6)
        key, sub = jax_random.split(key)
        _, ldr = degrade_batch(sub, torch.from_numpy(hdr)[None].to(device), banks)
        sm, cams = sunpose_with_cams(sun, ldr, getattr(torch, cfg.model.compute_dtype))
        pred, sum_pred = (t.cpu().numpy() for t in cam_gated_prediction(sm, cams, h, w))
        cams = [c[0].float().cpu().numpy() for c in cams]
        name = os.path.splitext(os.path.basename(path))[0]
        out_path = os.path.join(out_dir, f"{name}.png")
        # The reference's six panels (train_sun.py:449-471): CAM1-3, the
        # prediction, the CAM-gated prediction, the source HDR.
        save_eval_panel(
            [*cams, pred / (pred.max() + 1e-12), sum_pred, np.clip(hdr, 0, 1)],
            ["Grad-CAM 1", "Grad-CAM 2", "Grad-CAM 3",
             "sun-pose prediction", "CAM-gated prediction (sum_pred)",
             f"source HDR (clipped): {name}"],
            out_path,
        )
        print("wrote", out_path)


if __name__ == "__main__":
    main()
