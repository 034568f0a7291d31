"""Dataset generation (`skyhdr.cli.dataset_generator`, reference
datasetGenerator.py): Laval HDR Sky DB -> resized sky-dome .hdr crops + CSV
-> per-image GZIP TFRecords, the files the JAX package writes.

Example:
  python -m skyhdr_torch.cli.dataset_generator --dir /path/to/LavalSkyDB \
      --imheight 32 --imwidth 128
"""

from __future__ import annotations

import argparse
import os

from skyhdr_torch.data.laval import extract_laval, make_tfrecords


def main(argv=None):
    parser = argparse.ArgumentParser(description="generate the training dataset")
    parser.add_argument("--dir", type=str, required=True,
                        help="Laval Sky DB root (with envmap/ and csv_day/)")
    parser.add_argument("--out", type=str, default=os.getcwd())
    parser.add_argument("--imheight", type=int, default=32)
    parser.add_argument("--imwidth", type=int, default=128)
    # Hardcoded in the reference (datasetGenerator.py:13).
    parser.add_argument("--img-bias", type=float, default=0.00955794)
    parser.add_argument("--train-split", type=int, default=30000)
    parser.add_argument("--envmap-ext", type=str, default="exr",
                        choices=("exr", "hdr"),
                        help="envmap format: exr (OpenCV reader, the Laval "
                             "original) or hdr (built-in RGBE codec)")
    args = parser.parse_args(argv)

    if not os.path.isdir(os.path.join(args.dir, "envmap")):
        raise SystemExit(
            f"error: {args.dir!r} does not look like a Laval Sky DB root "
            f"(missing envmap/ subdirectory)")

    imread = None
    if args.envmap_ext == "hdr":
        from skyhdr_torch.utils.io import read_hdr

        imread = lambda p: read_hdr(p)[..., ::-1]  # BGR like cv2

    size_wh = (args.imwidth, args.imheight)
    extract_laval(args.dir, args.out, size_wh, img_bias=args.img_bias,
                  train_split_count=args.train_split,
                  envmap_name=f"envmap.{args.envmap_ext}", imread=imread)
    out_root = make_tfrecords(args.out, size_wh)
    print("TFRecords written under", out_root)


if __name__ == "__main__":
    main()
