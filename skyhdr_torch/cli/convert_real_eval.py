"""Real-outdoor eval-set converter (`skyhdr.cli.convert_real_eval`,
reference convert_to_tf_record.py): pairs outdoor_real_gt/*.exr (or .hdr)
with outdoor_real_input/*.jpg, crops the top half (the sky dome) of each
and writes one {ldr, hdr} TFRecord per pair, the bytes the JAX package
writes. `cli.evaluate --real-dir` reads them.

Example:
  python -m skyhdr_torch.cli.convert_real_eval --gt-dir outdoor_real_gt \
      --input-dir outdoor_real_input --out outdoor_real_tfrecord
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from skyhdr_torch.data.records import write_tfrecord


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="convert real outdoor LDR/HDR pairs to eval TFRecords")
    parser.add_argument("--gt-dir", type=str, default="outdoor_real_gt")
    parser.add_argument("--input-dir", type=str, default="outdoor_real_input")
    parser.add_argument("--out", type=str, default="outdoor_real_tfrecord")
    parser.add_argument("--gt-ext", type=str, default="exr",
                        choices=("exr", "hdr"))
    args = parser.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)

    gts = sorted(glob.glob(os.path.join(args.gt_dir, f"*.{args.gt_ext}")))
    ldrs = sorted(glob.glob(os.path.join(args.input_dir, "*.jpg")))
    if len(gts) != len(ldrs) or not gts:
        raise SystemExit(f"error: {len(gts)} GT vs {len(ldrs)} LDR images")

    if args.gt_ext == "hdr":
        from skyhdr_torch.utils.io import read_hdr

        read_gt = lambda p: read_hdr(p)[..., ::-1]  # BGR like cv2
    else:
        import cv2

        os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "true")
        read_gt = lambda p: cv2.imread(p, cv2.IMREAD_UNCHANGED)

    def read_ldr(p):
        try:
            import cv2

            return cv2.imread(p, cv2.IMREAD_COLOR)
        except ImportError:
            from PIL import Image

            return np.asarray(Image.open(p).convert("RGB"))[..., ::-1]

    for gt_path, ldr_path in zip(gts, ldrs):
        hdr = read_gt(gt_path)
        ldr = read_ldr(ldr_path)
        # Top-half crop = the sky dome (reference convert_to_tf_record.py:49-50).
        hdr = hdr[: hdr.shape[0] // 2].astype(np.float32)
        ldr = ldr[: ldr.shape[0] // 2]
        name = os.path.splitext(os.path.basename(gt_path))[0]
        out_path = os.path.join(args.out, name + ".tfrecord")
        write_tfrecord(out_path, [{
            "ldr": np.ascontiguousarray(ldr).tobytes(),
            "hdr": np.ascontiguousarray(hdr).tobytes(),
            "height": float(hdr.shape[0]),
            "width": float(hdr.shape[1]),
            # The LDR crop's own size: the GT and input cameras need not
            # share a resolution.
            "ldr_height": float(ldr.shape[0]),
            "ldr_width": float(ldr.shape[1]),
        }])
        print("wrote", out_path)


if __name__ == "__main__":
    main()
