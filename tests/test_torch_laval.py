"""The port's Laval extraction (`skyhdr_torch.data.laval`) and dataset CLI
(`skyhdr_torch.cli.dataset_generator`) against `skyhdr`'s, on a synthetic
mini Laval tree (as `tests/test_laval.py` builds one) that also holds a
metadata row with a missing sun field, a duplicate row, an image with no
metadata row and an all-dark image.

`align_sunpose` is bit-equal on both resize paths (OpenCV, and the
interpolation matrices when OpenCV is missing); the CSV rows, .hdr crops
and TFRecords are byte-identical (TFRecords compared uncompressed: gzip
headers carry a time stamp)."""

import csv
import gzip
import os
import sys

import numpy as np
import pytest
import torch

from skyhdr.cli import dataset_generator as jgen
from skyhdr.data import laval as jlaval
from skyhdr_torch.cli import dataset_generator as tgen
from skyhdr_torch.data import laval as tlaval
from skyhdr_torch.utils.io import read_hdr, write_hdr

# The suite runs in several worker processes that share the CPU.
torch.set_num_threads(1)

W, H = 64, 16


@pytest.mark.parametrize("opencv", [True, False], ids=["cv2", "no-cv2"])
@pytest.mark.parametrize("azimuth", [0, 7, 63, 127])
def test_align_sunpose_bit_equal(monkeypatch, opencv, azimuth):
    if not opencv:
        monkeypatch.setitem(sys.modules, "cv2", None)  # `import cv2` raises ImportError
    img = np.random.default_rng(azimuth).uniform(0, 5, (20, 40, 3)).astype(np.float32)
    got = tlaval.align_sunpose(img, azimuth, (128, 32))
    want = jlaval.align_sunpose(img, azimuth, (128, 32))
    assert got.shape == (32, 128, 3) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _stamp(date, t):
    return f"{date[:4]}-{date[4:6]}-{date[6:8]} {t[:2]}:{t[2:4]}:{t[4:6]}"


def _synth_laval(root, rng):
    """envmap/<date>/<time>/envmap.hdr and csv_day/<date>. On 20200101 the
    15:00 image's first row lacks its elevation (dropped, the next row
    serves) and 12:00 has two rows (the first wins); on 20200102 18:00 has
    no row, 12:00 only a row with a NaN azimuth, and 15:00 is all dark."""
    fields = ["Datetime", "Sun elevation", "Sun azimuth"]
    for date in ("20200101", "20200102"):
        rows = []
        for j, t in enumerate(("090000", "120000", "150000", "180000")):
            d = os.path.join(root, "envmap", date, t)
            os.makedirs(d)
            img = (rng.uniform(0, 1, size=(64, 128, 3)) ** 2 * 3).astype(np.float32)
            if (date, t) == ("20200102", "150000"):
                img[:] = 0.0
            write_hdr(os.path.join(d, "envmap.hdr"), img)
            rad = lambda deg: repr(float(np.deg2rad(deg)))
            zen, az = rad(30.0 + 10 * j), rad(120.0 + 30 * j)
            if (date, t) == ("20200101", "150000"):
                rows.append([_stamp(date, t), "", az])
            if (date, t) == ("20200102", "120000"):
                rows.append([_stamp(date, t), zen, "NaN"])
                continue
            if (date, t) == ("20200102", "180000"):
                continue
            rows.append([_stamp(date, t), zen, az])
            if (date, t) == ("20200101", "120000"):
                rows.append([_stamp(date, t), rad(80.0), az])
        os.makedirs(os.path.join(root, "csv_day"), exist_ok=True)
        with open(os.path.join(root, "csv_day", date), "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(fields)
            writer.writerows(rows)
    return root


@pytest.fixture(scope="module")
def laval_db(tmp_path_factory):
    return _synth_laval(str(tmp_path_factory.mktemp("laval") / "db"),
                        np.random.default_rng(0))


def _tree(root):
    """{relative path: bytes} of every file under root, TFRecords
    uncompressed."""
    out = {}
    for d, _, files in os.walk(root):
        for n in files:
            p = os.path.join(d, n)
            opener = gzip.open if n.endswith(".tfrecord") else open
            with opener(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_extract_and_tfrecords_match_skyhdr(laval_db, tmp_path):
    pytest.importorskip("pandas")  # skyhdr reads the metadata with pandas
    kw = dict(size_wh=(W, H), img_bias=1e-6, train_split_count=3,
              envmap_name="envmap.hdr", imread=lambda p: read_hdr(p)[..., ::-1],
              log=lambda *a: None)
    for tag, mod in (("port", tlaval), ("jax", jlaval)):
        out = str(tmp_path / tag)
        train_dir, test_dir = mod.extract_laval(laval_db, out, **kw)
        assert train_dir == os.path.join(out, f"dataset_{W}_{H}", "train")
        mod.make_tfrecords(out, size_wh=(W, H), log=lambda *a: None)
    got, want = _tree(str(tmp_path / "port")), _tree(str(tmp_path / "jax"))
    assert sorted(got) == sorted(want)
    assert got == want
    ds = f"dataset_{W}_{H}"
    with open(tmp_path / "port" / ds / "train" / "train_refine.csv") as f:
        train = list(csv.DictReader(f))
    with open(tmp_path / "port" / ds / "test" / "test_refine.csv") as f:
        test = list(csv.DictReader(f))
    # 8 images: 02 12:00 (NaN azimuth) and 02 18:00 (no row) are skipped,
    # 02 15:00 is dark; 01 15:00 takes its second row, 01 12:00 its first.
    assert [r["image_name"] for r in train] == [
        "2020-01-01_09:00:00", "2020-01-01_12:00:00", "2020-01-01_15:00:00"]
    assert [r["image_name"] for r in test] == [
        "2020-01-01_18:00:00", "2020-01-02_09:00:00"]
    zenith_px = int(round(40.0 * H / 90.0))  # 01 12:00's first row: 30 + 10
    assert int(train[1]["elevation"]) == H - zenith_px
    assert len(os.listdir(tmp_path / "port" / ds / "tfrecord" / "train")) == 3


def test_dataset_generator_cli_matches_skyhdr(laval_db, tmp_path, capsys):
    pytest.importorskip("pandas")
    for tag, main in (("port", tgen.main), ("jax", jgen.main)):
        main(["--dir", laval_db, "--out", str(tmp_path / tag), "--imheight", str(H),
              "--imwidth", str(W), "--img-bias", "1e-6", "--train-split", "3",
              "--envmap-ext", "hdr"])
    assert "TFRecords written under" in capsys.readouterr().out
    got, want = _tree(str(tmp_path / "port")), _tree(str(tmp_path / "jax"))
    assert len(got) == 5 + 2 + 5  # .hdr crops, CSVs, TFRecords
    assert got == want


@pytest.mark.parametrize("package", ["port", "jax"])
def test_dataset_generator_needs_envmap_dir(tmp_path, package):
    main = tgen.main if package == "port" else jgen.main
    with pytest.raises(SystemExit, match="missing envmap/"):
        main(["--dir", str(tmp_path), "--out", str(tmp_path / "o")])
