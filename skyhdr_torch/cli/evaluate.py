"""Batched evaluation (`skyhdr.cli.evaluate`): a test set -> reconstruct ->
mean PSNR / si-RMSE / EMD per image, printed as one JSON line, on a CUDA
card by default.

Two sources: the synthetic test split (`--dir`, TFRecords of HDR skies,
degraded on the device with the test exposure and CRF banks, the draws
from `PRNGKey(--seed)` split once a batch, as `skyhdr`'s), or the real {ldr, hdr}
pairs that `cli.convert_real_eval` writes (`--real-dir`). The weights are
those `restore_model_vars` finds under `--workdir` (or `--sky`/`--sun`),
else the `--seed` ones.

Example:
  python -m skyhdr_torch.cli.evaluate --dir dataset_128_32/tfrecord/test
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from skyhdr_torch.cli.common import (add_common_flags, config_from_args, load_banks,
                                     restore_model_vars)
from skyhdr_torch.train.engine import degrade, make_inference_fn
from skyhdr_torch.train.evaluation import evaluate_batch
from skyhdr_torch.utils import jax_random


def _iter_real_batches(real_dir: str, imshape, batch_size: int):
    """(ldr, hdr, n) batches of `cli.convert_real_eval` records, resized on
    the host to the model's resolution (OpenCV, INTER_AREA): ldr RGB in
    [0, 1], hdr RGB with the training-time mean normalisation
    (`data.pipeline.prepare_sample`), so that PSNR is read in the scale the
    model was trained in. The last batch is padded to `batch_size` by
    repeating its last sample, which leaves the batch maximum that PSNR
    reads unchanged; only its first `n` rows are real."""
    from skyhdr_torch.data.records import read_tfrecord_examples

    h, w, _ = imshape

    def resize(img):
        import cv2

        return cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)

    def scalar(ex, key, default_key=None):
        v = ex.get(key) if default_key is None else ex.get(key, ex[default_key])
        return int(np.asarray(v).reshape(-1)[0])

    ldrs, hdrs = [], []
    for ex in read_tfrecord_examples(real_dir):
        hh, hw = scalar(ex, "height"), scalar(ex, "width")
        lh = scalar(ex, "ldr_height", "height")
        lw = scalar(ex, "ldr_width", "width")
        hdr = np.frombuffer(ex["hdr"], np.float32).reshape(hh, hw, 3)
        ldr = np.frombuffer(ex["ldr"], np.uint8).reshape(lh, lw, 3)
        hdr = resize(hdr[..., ::-1])  # stored BGR (OpenCV order)
        ldr = resize(ldr[..., ::-1].astype(np.float32) / 255.0)
        hdr = 0.5 * hdr / (hdr.mean() + 1e-6)
        ldrs.append(ldr)
        hdrs.append(hdr)
        if len(ldrs) == batch_size:
            yield np.stack(ldrs), np.stack(hdrs), batch_size
            ldrs, hdrs = [], []
    if ldrs:
        n = len(ldrs)
        pad = batch_size - n
        ldrs += [ldrs[-1]] * pad
        hdrs += [hdrs[-1]] * pad
        yield np.stack(ldrs), np.stack(hdrs), n


def main(argv=None):
    parser = argparse.ArgumentParser(description="evaluate on a test set (PyTorch)")
    add_common_flags(parser)
    parser.add_argument("--sky", type=str, default=None,
                        help="SKY checkpoint dir (default: "
                             "<workdir>/checkpoints/SKY)")
    parser.add_argument("--sun", type=str, default=None,
                        help="SUN checkpoint dir whose sun-pose net "
                             "replaces the SKY one's (default: "
                             "<workdir>/checkpoints/SUN)")
    parser.add_argument("--real-dir", type=str, default=None,
                        help="evaluate on REAL captured pairs from "
                             "cli.convert_real_eval ({ldr, hdr} records) "
                             "instead of degrading a synthetic test split: "
                             "the model predicts from the real LDR and is "
                             "scored against the real HDR")
    parser.add_argument("--max-batches", type=int, default=0)
    parser.add_argument("--render-dir", type=str, default=None,
                        help="also write tone-mapped PNG previews of "
                             "(input LDR, reconstruction, target) per batch")
    parser.add_argument("--weights-dtype", type=str, default="float32",
                        choices=("float32", "bfloat16"),
                        help="cast the weights for serving")
    args = parser.parse_args(argv)

    cfg = config_from_args(args)
    device = torch.device(args.device)
    if args.real_dir:
        batches = _iter_real_batches(args.real_dir, cfg.model.imshape,
                                     cfg.data.batch_size)
    else:
        from skyhdr_torch.data.pipeline import PanoramaDataset

        test_dir = args.dir or os.path.join(cfg.data.dataset_dir, "test")
        ds = PanoramaDataset(test_dir, imshape=cfg.model.imshape,
                             batch_size=cfg.data.batch_size, shuffle=False)
        banks = load_banks(cfg, args.dorf, train=False, device=device)
        batches = ((b["hdr"], None, b["hdr"].shape[0]) for b in ds)

    gen, sun = restore_model_vars(cfg, args.workdir, sky=args.sky, sun=args.sun,
                                  seed=args.seed, device=device)
    if args.weights_dtype != "float32":
        from skyhdr_torch.utils.params import cast_model_vars

        cast_model_vars(gen, args.weights_dtype)
        cast_model_vars(sun, args.weights_dtype)

    infer = make_inference_fn(cfg)
    key = jax_random.key(args.seed)
    sums, count = {}, 0
    for i, (a, b, n) in enumerate(batches):
        if args.max_batches and i >= args.max_batches:
            break
        if args.real_dir:
            ldr, hdr_t = torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)
        else:
            key, sub = jax_random.split(key)
            hdr_t, ldr = degrade(cfg, banks, sub, torch.from_numpy(a).to(device))
        pred = infer(gen, sun, ldr)["y_final_lin"]
        for k, v in evaluate_batch(pred, hdr_t).items():
            # Per-image values; only the first n rows are real (the real
            # path's last batch is padded).
            sums[k] = sums.get(k, 0.0) + float(v[:n].sum())
        count += n
        if args.render_dir:
            from skyhdr_torch.utils.vis import save_eval_panel, tonemap_for_display

            host = lambda t: t[0].float().cpu().numpy()
            save_eval_panel(
                [host(ldr), tonemap_for_display(host(pred)),
                 tonemap_for_display(host(hdr_t))],
                ["input LDR", "reconstruction (tone-mapped)",
                 "target (tone-mapped)"],
                os.path.join(args.render_dir, f"batch{i:04d}.png"),
            )

    result = {k: v / max(count, 1) for k, v in sums.items()}
    result["images"] = count
    print(json.dumps(result))


if __name__ == "__main__":
    main()
