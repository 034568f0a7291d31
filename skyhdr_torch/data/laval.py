"""Laval HDR Sky DB extraction -> sky-dome .hdr crops + CSV -> TFRecords
(`skyhdr.data.laval`, reference DataGeneration/loadLavalSkyDB.py +
makeTFRecord.py), writing the files the JAX package writes.

Walk envmap/<date>/<time>/envmap.exr with the csv_day/<date> metadata, skip
all-dark images (max < img_bias), convert the sun's zenith/azimuth radians
-> degrees -> pixels, roll the panorama cyclically so that the sun sits at
the reference's column (alignSunpose, loadLavalSkyDB.py:16-35), crop the
top half (the sky dome), write one .hdr per image and {image_name, azimuth,
elevation} CSV rows, the first `train_split_count` images as train and the
rest as test (loadLavalSkyDB.py:68,100-106); then one GZIP TFRecord per
image with {image: raw float32 bytes in BGR order, as the reference's
OpenCV-written records, azimuth, elevation} (makeTFRecord.py:24-31).

The JAX package reads the metadata with pandas; this copy reads it with the
standard library's `csv`, with the same semantics: rows whose sun fields
are missing are dropped first (pandas' default missing-value strings), the
first row of a `Datetime` wins, and an image whose `Datetime` has no row is
skipped. EXR reading needs OpenCV.
"""

from __future__ import annotations

import csv
import os
from typing import Dict, List, Tuple

import numpy as np

from skyhdr_torch.data.records import write_tfrecord
from skyhdr_torch.utils.io import read_hdr, write_hdr

_SUN_FIELDS = ("Sun elevation", "Sun azimuth")
# pandas.read_csv's default missing-value strings (its `na_values`).
_MISSING = {"", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
            "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
            "nan", "null"}


def align_sunpose(img: np.ndarray, sun_azimuth: int, out_wh: Tuple[int, int],
                  resize=None) -> np.ndarray:
    """Resize to (w, 2h), crop the sky dome (top half), roll the panorama
    by -sun_azimuth columns (loadLavalSkyDB.py:16-35: new_loc = i -
    sun_azimuth, cyclic)."""
    w, h = out_wh  # the reference passes reshape_size = [w, h]
    if resize is None:
        resize = _resize_bilinear_np
    img = resize(img, (w, 2 * h))
    img = img[:h]
    return np.roll(img, -int(sun_azimuth), axis=1)


def _resize_bilinear_np(img: np.ndarray, wh: Tuple[int, int]) -> np.ndarray:
    try:
        import cv2

        return cv2.resize(img, wh)
    except ImportError:
        from skyhdr_torch.ops.dog import _interp_matrix

        w, h = wh
        mh = _interp_matrix(img.shape[0], h)
        mw = _interp_matrix(img.shape[1], w)
        return np.einsum("Hh,hwc,Ww->HWc", mh, img, mw).astype(img.dtype)


def _sun_rows(csv_path: str) -> Dict[str, dict]:
    """Datetime -> the first metadata row of that time whose sun fields are
    both present."""
    table: Dict[str, dict] = {}
    with open(csv_path, newline="") as f:
        for row in csv.DictReader(f):
            if any(row[k] is None or row[k] in _MISSING for k in _SUN_FIELDS):
                continue
            table.setdefault(row["Datetime"], row)
    return table


def extract_laval(root_dir: str, out_dir: str, size_wh: Tuple[int, int] = (128, 32),
                  img_bias: float = 0.00955794, train_split_count: int = 30000,
                  envmap_name: str = "envmap.exr", imread=None,
                  log=print) -> Tuple[str, str]:
    """Full extraction (reference loadLavalSkyDB.py:42-143). Returns the
    (train_dir, test_dir) holding hdr/ crops and *_refine.csv files.

    `imread` (path -> BGR float array or None) defaults to OpenCV's EXR
    reader."""
    if imread is None:
        import cv2

        os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "true")
        imread = lambda p: cv2.imread(p, cv2.IMREAD_UNCHANGED)
    w, h = size_wh
    azimuth_unit = w / 360.0
    zenith_unit = h / 90.0

    new_root = os.path.join(out_dir, f"dataset_{w}_{h}")
    train_dir = os.path.join(new_root, "train")
    test_dir = os.path.join(new_root, "test")
    for d in (new_root, train_dir, test_dir,
              os.path.join(train_dir, "hdr"), os.path.join(test_dir, "hdr")):
        os.makedirs(d, exist_ok=True)

    envmap_dir = os.path.join(root_dir, "envmap")
    csvday_dir = os.path.join(root_dir, "csv_day")

    idx = train_split_count
    rows: List[dict] = []
    hdrdir = os.path.join(train_dir, "hdr")
    split_csv = os.path.join(train_dir, "train_refine.csv")

    for date in sorted(os.listdir(envmap_dir)):
        date_dir = os.path.join(envmap_dir, date)
        csv_path = os.path.join(csvday_dir, date)
        if not os.path.isdir(date_dir) or not os.path.exists(csv_path):
            continue
        sun_rows = _sun_rows(csv_path)
        for timeline in sorted(os.listdir(date_dir)):
            img_path = os.path.join(date_dir, timeline, envmap_name)
            if not os.path.exists(img_path):
                continue
            img = imread(img_path)
            if img is None or np.max(img) < img_bias:
                log("skip all-dark image", img_path)
                continue
            if idx == 0:
                _write_csv(split_csv, rows)
                rows = []
                hdrdir = os.path.join(test_dir, "hdr")
                split_csv = os.path.join(test_dir, "test_refine.csv")
                idx = -1  # switched; later decrements stay below zero

            name = "{}-{}-{}_{}:{}:{}".format(
                date[:4], date[4:6], date[6:8],
                timeline[:2], timeline[2:4], timeline[4:6])
            dt_key = "{}-{}-{} {}:{}:{}".format(
                date[:4], date[4:6], date[6:8],
                timeline[:2], timeline[2:4], timeline[4:6])
            desc = sun_rows.get(dt_key)
            if desc is None:
                continue
            # "Sun elevation" in the metadata is the zenith angle
            # (loadLavalSkyDB.py:80-84).
            sun_zenith = int(round(np.rad2deg(float(desc["Sun elevation"]))
                                   * zenith_unit))
            sun_azimuth = int(round(np.rad2deg(float(desc["Sun azimuth"]))
                                    * azimuth_unit))
            aligned = align_sunpose(img, sun_azimuth, (w, h))
            write_hdr(os.path.join(hdrdir, name + ".hdr"), aligned[..., ::-1])
            rows.append({
                "image_name": name,
                # zenith -> elevation; azimuth re-centred
                # (loadLavalSkyDB.py:132-133).
                "azimuth": sun_azimuth + 2 * h,
                "elevation": h - sun_zenith,
            })
            idx -= 1
            log("saved", name, "idx", idx)

    _write_csv(split_csv if idx < 0 else os.path.join(test_dir, "test_refine.csv"),
               rows)
    return train_dir, test_dir


def _write_csv(path: str, rows: List[dict]) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["image_name", "azimuth", "elevation"])
        writer.writeheader()
        writer.writerows(rows)


def make_tfrecords(dataset_root: str, size_wh: Tuple[int, int] = (128, 32),
                   log=print) -> str:
    """CSV-driven per-image GZIP TFRecords (reference makeTFRecord.py:48-106),
    images as raw float32 bytes in BGR order (the training parser flips
    them back to RGB, `data.pipeline.prepare_sample`)."""
    w, h = size_wh
    ds = os.path.join(dataset_root, f"dataset_{w}_{h}")
    out_root = os.path.join(ds, "tfrecord")
    for proc in ("train", "test"):
        src_dir = os.path.join(ds, proc)
        out_dir = os.path.join(out_root, proc)
        os.makedirs(out_dir, exist_ok=True)
        csv_path = os.path.join(src_dir, proc + "_refine.csv")
        with open(csv_path) as f:
            for row in csv.DictReader(f):
                img = read_hdr(os.path.join(src_dir, "hdr",
                                            row["image_name"] + ".hdr"))
                img_bgr = np.ascontiguousarray(img[..., ::-1], np.float32)
                out_path = os.path.join(out_dir, row["image_name"] + ".tfrecord")
                write_tfrecord(out_path, [{
                    "image": img_bgr.tobytes(),
                    "azimuth": float(row["azimuth"]),
                    "elevation": float(row["elevation"]),
                }])
                log("wrote", out_path)
    return out_root
