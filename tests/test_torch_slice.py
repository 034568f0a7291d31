"""The port's serving slice end to end on the CPU: `make_inference_fn`
against `skyhdr`'s at 16x64, the golden fixture, the CLI, the .hdr and .png
codecs, and the port's independence from JAX."""

import importlib.util
import os
import subprocess
import sys
import zlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from skyhdr.config import Config, DataConfig, ModelConfig
from skyhdr.train.engine import make_inference_fn as j_make_inference_fn
from skyhdr.utils import io as jio
from skyhdr_torch.train.engine import build_models, make_inference_fn
from skyhdr_torch.utils import io as tio
from skyhdr_torch.utils.png import read_png, write_png
from skyhdr_torch.utils.transplant import (init_model_vars, load_model_vars,
                                           tree_digest)

# The suite runs in several worker processes that share the CPU; torch's
# default of one thread per core in each of them oversubscribes it.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUTPUTS = ("y_final_lin", "sky_pred_lin", "sun_pred_lin", "alpha",
           "sunpose_pred")


def _golden_module():
    spec = importlib.util.spec_from_file_location(
        "make_torch_golden", os.path.join(ROOT, "tools", "make_torch_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(cfg, seed=0):
    gv, sv = init_model_vars(cfg, seed)
    gen, sun = build_models(cfg, "cpu")
    load_model_vars(gen, gv)
    load_model_vars(sun, sv)
    return (gv, sv), (gen, sun)


@pytest.mark.parametrize("da,weights_dtype", [(True, "float32"), (False, "float32"),
                                              (False, "bfloat16")],
                         ids=["da", "plain", "plain-bf16-weights"])
def test_inference_matches_skyhdr(da, weights_dtype):
    """All five outputs; `--weights-dtype bfloat16` casts the same weights
    in both packages (the compute stays f32)."""
    from skyhdr.utils.params import cast_model_vars as j_cast
    from skyhdr_torch.utils.params import cast_model_vars

    cfg = Config(model=ModelConfig(im_height=16, im_width=64, use_da_conv=da,
                                   da_backend="xla"),
                 data=DataConfig(batch_size=2))
    (gv, sv), (gen, sun) = _port(cfg)
    if weights_dtype != "float32":
        gv, sv = j_cast(gv, weights_dtype), j_cast(sv, weights_dtype)
        cast_model_vars(gen, weights_dtype)
        cast_model_vars(sun, weights_dtype)
    x = np.random.default_rng(1).uniform(0, 1, (2, 16, 64, 3)).astype(np.float32)
    want = j_make_inference_fn(cfg)(gv, sv, jnp.asarray(x))
    got = make_inference_fn(cfg)(gen, sun, torch.from_numpy(x))
    wsm = np.asarray(want["sunpose_pred"]).reshape(2, -1)
    assert np.array_equal(wsm.argmax(-1),
                          got["sunpose_pred"].numpy().reshape(2, -1).argmax(-1))
    for name in OUTPUTS:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   rtol=1e-3, atol=1e-3, err_msg=name)


def test_golden_fixture_regenerates():
    mod = _golden_module()
    stored = np.load(mod.FIXTURE)
    fresh = mod.make_golden(int(stored["seed"]))
    assert sorted(fresh) == sorted(stored.files)
    for name in stored.files:
        np.testing.assert_allclose(fresh[name], stored[name], rtol=1e-6,
                                   atol=1e-6, err_msg=name)


def test_port_matches_golden_fixture():
    mod = _golden_module()
    stored = np.load(mod.FIXTURE)
    cfg = mod.golden_config()
    (gv, sv), (gen, sun) = _port(cfg, int(stored["seed"]))
    assert tree_digest({"gen": gv, "sun": sv}) == pytest.approx(
        float(stored["weights_digest"]), rel=1e-9)
    out = make_inference_fn(cfg)(gen, sun, torch.from_numpy(stored["input"]))
    want_bins = stored["sunpose_pred"].reshape(len(stored["input"]), -1).argmax(-1)
    got_bins = out["sunpose_pred"].numpy().reshape(len(want_bins), -1).argmax(-1)
    assert np.array_equal(got_bins, want_bins)
    for name in ("y_final_lin", "sunpose_pred", "alpha"):
        np.testing.assert_allclose(out[name].numpy(), stored[name], rtol=1e-3,
                                   atol=1e-3, err_msg=name)


def test_cli_writes_finite_hdr(tmp_path):
    from skyhdr_torch.cli import inference

    rng = np.random.default_rng(0)
    indir = tmp_path / "ldr"
    indir.mkdir()
    for i in range(3):
        write_png(str(indir / f"pano{i}.png"),
                  rng.integers(0, 256, (16, 64, 3), dtype=np.uint8))
    inference.main(["--indir", str(indir), "--outdir", str(tmp_path / "out"),
                    "--imheight", "16", "--imwidth", "64", "--da-conv", "true",
                    "--batch", "2", "--device", "cpu"])
    for i in range(3):
        hdr = tio.read_hdr(str(tmp_path / "out" / f"pano{i}.hdr"))
        assert hdr.shape == (16, 64, 3) and np.all(np.isfinite(hdr))
        assert hdr.max() > 0


def test_imread_png_fallback_matches_pil(tmp_path, monkeypatch):
    """Without OpenCV and Pillow the CLI decodes PNG itself."""
    import builtins

    from PIL import Image

    from skyhdr_torch.cli.inference import _imread01

    rgb = np.random.default_rng(0).integers(0, 256, (8, 20, 3), dtype=np.uint8)
    path = str(tmp_path / "a.png")
    Image.fromarray(rgb).save(path)
    real_import = builtins.__import__

    def no_cv(name, *args, **kw):
        if name in ("cv2", "PIL") or name.startswith("PIL."):
            raise ImportError(name)
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_cv)
    np.testing.assert_array_equal(_imread01(path), rgb.astype(np.float32) / 255)
    with pytest.raises(RuntimeError, match="JPEG"):
        _imread01(str(tmp_path / "a.jpg"))


def _png_filtered(img: np.ndarray, ft: int) -> bytes:
    """Encode with every row in filter `ft` (the PNG spec's forward filters)."""
    import struct

    h, w, bpp = img.shape
    rows = img.reshape(h, w * bpp).astype(np.int64)
    raw = bytearray()
    for y in range(h):
        cur = rows[y]
        up = rows[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        if ft == 0:
            pred = 0
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = up
        elif ft == 3:
            pred = (left + up) // 2
        else:
            p = left + up - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
        raw.append(ft)
        raw.extend(((cur - pred) % 256).astype(np.uint8).tobytes())
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[bpp]

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ft", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("bpp", [1, 3, 4])
def test_png_decoder_every_filter(tmp_path, ft, bpp):
    img = np.random.default_rng(ft).integers(0, 256, (5, 7, bpp), dtype=np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_png_filtered(img, ft))
    np.testing.assert_array_equal(read_png(str(path)), img)


def test_png_writer_reads_back_in_pil(tmp_path):
    from PIL import Image

    rgb = np.random.default_rng(0).integers(0, 256, (9, 13, 3), dtype=np.uint8)
    write_png(str(tmp_path / "w.png"), rgb)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "w.png")), rgb)
    np.testing.assert_array_equal(read_png(str(tmp_path / "w.png")), rgb)


def test_hdr_codec_copy_matches_skyhdr(tmp_path):
    img = np.random.default_rng(0).gamma(1.0, 3.0, (12, 40, 3)).astype(np.float32)
    img[0, :5] = 0.0
    tio.write_hdr(str(tmp_path / "t.hdr"), img)
    jio.write_hdr(str(tmp_path / "j.hdr"), img)
    assert (tmp_path / "t.hdr").read_bytes() == (tmp_path / "j.hdr").read_bytes()
    np.testing.assert_array_equal(tio.read_hdr(str(tmp_path / "j.hdr")),
                                  jio.read_hdr(str(tmp_path / "t.hdr")))


def test_entry_twin_runs():
    from skyhdr_torch.entry import entry

    fn, args = entry("cpu")
    y = fn(*args)
    assert y.shape == (1, 32, 128, 3) and torch.isfinite(y).all()


def test_port_imports_no_jax():
    """Every skyhdr_torch module imports without JAX or the JAX package."""
    code = (
        "import pkgutil, importlib, sys, skyhdr_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(skyhdr_torch.__path__,"
        " 'skyhdr_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'skyhdr'))\n"
        "assert not bad, bad\n"
        "assert len(names) >= 15, names\n"
        "assert 'skyhdr_torch.tools.exp_daconv' in names, names\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
