"""Serving CLI (`skyhdr.cli.inference`): LDR JPG/PNG panoramas ->
reconstructed .hdr radiance maps, on a CUDA card by default.

Models are built and filled once, then every group of `--batch` images is
one forward; the last group is padded by repeating its last image, and the
padded outputs are dropped. The weights are those of the newest SKY
checkpoint under `<workdir>/checkpoints/SKY` (or `--sky`), with the
sun-pose net of the newest SUN checkpoint (`--sun`) over them, as the
training CLI writes them (torch format, not Orbax); only when no SKY
checkpoint exists are they drawn from `--seed`, as the JAX CLI does.

Example:
  python -m skyhdr_torch.cli.inference --indir ldr_images/ --outdir out/ \
      --da-conv true --imheight 64 --imwidth 256 --batch 32 --workdir run/
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch

from skyhdr_torch.cli.common import (add_common_flags, config_from_args,
                                     restore_model_vars)
from skyhdr_torch.train.engine import make_inference_fn
from skyhdr_torch.utils.io import write_hdr


def _imread01(path: str) -> np.ndarray:
    """Read an 8-bit image to float RGB in [0, 1]: OpenCV, else Pillow,
    else the standard-library PNG decoder."""
    try:
        import cv2

        img = cv2.imread(path, cv2.IMREAD_COLOR)
        return img[..., ::-1].astype(np.float32) / 255.0
    except ImportError:
        pass
    try:
        from PIL import Image

        return np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    except ImportError:
        pass
    if not path.lower().endswith(".png"):
        raise RuntimeError(f"{path}: reading JPEG needs OpenCV or Pillow, and "
                           f"neither is installed")
    from skyhdr_torch.utils.png import read_png

    img = read_png(path)
    if img.shape[-1] < 3:  # grey (+alpha)
        img = np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3].astype(np.float32) / 255.0


def main(argv=None):
    parser = argparse.ArgumentParser(description="LDR -> HDR inference "
                                                 "(PyTorch)")
    add_common_flags(parser)
    parser.add_argument("--indir", type=str, required=True)
    parser.add_argument("--outdir", type=str, default="inference_out")
    parser.add_argument("--sky", type=str, default=None,
                        help="SKY checkpoint dir (default: "
                             "<workdir>/checkpoints/SKY)")
    parser.add_argument("--sun", type=str, default=None,
                        help="SUN checkpoint dir whose sun-pose net "
                             "replaces the SKY one's (default: "
                             "<workdir>/checkpoints/SUN)")
    parser.add_argument("--weights-dtype", type=str, default="float32",
                        choices=("float32", "bfloat16"),
                        help="cast the weights for serving")
    parser.add_argument("--batch", type=int, default=1,
                        help="images per forward; the last group is padded "
                             "to this size")
    args = parser.parse_args(argv)
    cfg = config_from_args(args)
    device = torch.device(args.device)

    paths = sorted(glob.glob(os.path.join(args.indir, "*.jpg"))
                   + glob.glob(os.path.join(args.indir, "*.jpeg"))
                   + glob.glob(os.path.join(args.indir, "*.png")))
    if not paths:
        raise SystemExit(
            f"error: no .jpg/.jpeg/.png images found under {args.indir!r}")
    os.makedirs(args.outdir, exist_ok=True)

    gen, sun = restore_model_vars(cfg, args.workdir, sky=args.sky, sun=args.sun,
                                  seed=args.seed, device=device)
    if args.weights_dtype != "float32":
        from skyhdr_torch.utils.params import cast_model_vars

        cast_model_vars(gen, args.weights_dtype)
        cast_model_vars(sun, args.weights_dtype)

    infer = make_inference_fn(cfg)
    bsz = max(1, args.batch)
    for start in range(0, len(paths), bsz):
        group = paths[start:start + bsz]
        imgs = [_imread01(p) for p in group]
        batch = np.stack(imgs + [imgs[-1]] * (bsz - len(group)))
        out = infer(gen, sun, torch.from_numpy(batch).to(device))
        hdrs = out["y_final_lin"][:len(group)].float().cpu().numpy()
        for path, hdr in zip(group, hdrs):
            name = os.path.splitext(os.path.basename(path))[0]
            out_path = os.path.join(args.outdir, name + ".hdr")
            write_hdr(out_path, hdr)
            print("wrote", out_path)


if __name__ == "__main__":
    main()
