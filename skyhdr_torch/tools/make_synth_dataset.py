"""Write the synthetic Laval-like sky-dome TFRecord set of the quality runs
(`tools/make_synth_dataset.py`, with the same flags, seeds, draws and shard
layout, through the port's `data.records.write_tfrecord`).

Sky-dome panoramas: an elevation-graded sky of random colour, low-frequency
azimuth-periodic clouds, and a sun disc with a glow at the centre column
(as the Laval loader aligns the real sun), at a random elevation, width and
intensity (an HDR range of a few hundred). Records hold the image in BGR
float32, the azimuth and the elevation row.

Usage:
  python -m skyhdr_torch.tools.make_synth_dataset --out dataset_128_32/tfrecord \
      --n-train 2048 --n-test 256 --imheight 32 --imwidth 128
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from skyhdr_torch.data.records import write_tfrecord


def synth_panorama(rng: np.random.Generator, h: int, w: int):
    """One HDR sky dome [h, w, 3] float32 (RGB) and its sun row."""
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
    # Wrap-aware azimuth distance: the disc stays seamless at the border.
    dx = np.minimum(np.abs(xx - sun_x), w - np.abs(xx - sun_x))
    d2 = (yy - sun_y) ** 2 + dx ** 2
    warm = np.array([1.0, 0.9, 0.75], np.float32)
    sun = intensity * np.exp(-d2 / (2 * width ** 2))[..., None] * warm
    glow = 0.15 * intensity * np.exp(-d2 / (2 * (4 * width) ** 2))[..., None]

    img = sky + sun + glow
    img += rng.normal(0, 0.01, size=img.shape).astype(np.float32)
    return np.maximum(img, 1e-4).astype(np.float32), sun_y


def write_split(out_dir: str, n: int, h: int, w: int, seed: int, shard_size: int = 256):
    """n panoramas from `default_rng(seed)` into out_dir/NNNN.tfrecord,
    `shard_size` a file."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    azimuth = w * 0.5 - 1.0
    shard, shard_idx = [], 0
    for i in range(n):
        img, sun_y = synth_panorama(rng, h, w)
        shard.append({"image": img[:, :, ::-1].tobytes(),
                      "azimuth": float(azimuth), "elevation": float(sun_y)})
        if len(shard) == shard_size or i == n - 1:
            write_tfrecord(os.path.join(out_dir, f"{shard_idx:04d}.tfrecord"), shard)
            shard, shard_idx = [], shard_idx + 1
    print(f"{out_dir}: {n} samples in {shard_idx} shards")


def main(argv=None):
    ap = argparse.ArgumentParser(description="write the synthetic sky-dome TFRecord set")
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--n-train", type=int, default=2048)
    ap.add_argument("--n-test", type=int, default=256)
    ap.add_argument("--imheight", type=int, default=32)
    ap.add_argument("--imwidth", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    write_split(os.path.join(args.out, "train"), args.n_train,
                args.imheight, args.imwidth, args.seed)
    write_split(os.path.join(args.out, "test"), args.n_test,
                args.imheight, args.imwidth, args.seed + 1)


if __name__ == "__main__":
    main()
