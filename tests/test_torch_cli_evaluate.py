"""The port's evaluation CLI (`skyhdr_torch.cli.evaluate`) and real-pair
converter (`skyhdr_torch.cli.convert_real_eval`) against `skyhdr`'s, on the
CPU at 16x64.

- The converter writes the same record bytes as `skyhdr`'s for the same
  pairs (an LDR of another size than its GT), with either GT format and
  either LDR reader; a count mismatch exits in both.
- `evaluate --real-dir` through both CLIs on the same records, each with
  its own `--seed 0` weights (no checkpoint: `skyhdr`'s
  `create_gan_state(cfg, PRNGKey(0))`, which the port draws too), DA b2, 3
  images (the last batch padded): the metrics within rtol 1e-3, the
  serving golden's tolerance (`tests/test_torch_slice.py`). The port at b2 against b1: si_rmse within
  rtol 1e-3 and emd within 5e-2 (`tests/test_convert_real_eval.py`'s bounds).
- The synthetic eval step: the port's `degrade_with` fed the draws of
  `skyhdr`'s `degrade_batch`, then `make_inference_fn` and `evaluate_batch`,
  against `skyhdr`'s chain on the same draws, rtol 2e-3 (the JPEG model
  lets 1% of the LDR's pixels differ by up to 3/255,
  `tests/test_torch_train_ops.py`); then the synthetic CLI is repeatable
  for a seed, and from `--seed 3` gives `skyhdr`'s CLI's metrics (the same
  weights and degradation draws) within rtol 2e-3.
"""

import contextlib
import gzip
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyhdr_torch.cli import convert_real_eval, evaluate
from skyhdr_torch.data import records as trec
from skyhdr_torch.utils import io as tio
from skyhdr_torch.utils.transplant import init_model_vars

# The suite runs in several worker processes that share the CPU.
torch.set_num_threads(1)

H, W = 16, 64
FLAGS = ["--imheight", str(H), "--imwidth", str(W), "--da-conv", "true"]


def _synth_pairs(root, rng, n=3, h=2 * H, w=W, gt_ext="hdr"):
    """n real-capture-shaped pairs, as `tests/test_convert_real_eval.py`
    makes them: a GT .hdr (named .exr for the EXR reader, which the tests
    point at the RGBE codec) and a JPEG LDR of half the GT's size."""
    from PIL import Image

    gt_dir, in_dir = os.path.join(root, "gt"), os.path.join(root, "in")
    os.makedirs(gt_dir)
    os.makedirs(in_dir)
    for i in range(n):
        hdr = (rng.uniform(0, 1, size=(h, w, 3)) ** 2 * 20).astype(np.float32)
        tio.write_hdr(os.path.join(gt_dir, f"scene{i}.{gt_ext}"), hdr)
        ldr = (rng.uniform(0, 1, size=(h // 2, w // 2, 3)) * 255).astype(np.uint8)
        Image.fromarray(ldr).save(os.path.join(in_dir, f"scene{i}.jpg"), quality=92)
    return gt_dir, in_dir


def _payloads(folder):
    """{file name: the uncompressed bytes}: gzip headers carry a time stamp."""
    return {n: gzip.open(os.path.join(folder, n)).read() for n in sorted(os.listdir(folder))}


@pytest.fixture
def exr_as_hdr(monkeypatch):
    """OpenCV here reads no EXR: the GT reader's `cv2.imread` of a .exr
    returns the RGBE codec's image in BGR order, as OpenCV's reader would."""
    import cv2

    real = cv2.imread

    def imread(path, flags=cv2.IMREAD_COLOR):
        if path.endswith(".exr"):
            assert flags == cv2.IMREAD_UNCHANGED
            return tio.read_hdr(path)[..., ::-1]
        return real(path, flags)

    monkeypatch.setattr(cv2, "imread", imread)


@pytest.mark.parametrize("gt_ext,reader", [("hdr", "cv2"), ("hdr", "pil"), ("exr", "cv2")])
def test_converter_writes_skyhdr_bytes(tmp_path, monkeypatch, exr_as_hdr, gt_ext, reader):
    from skyhdr.cli import convert_real_eval as jconvert

    gt_dir, in_dir = _synth_pairs(str(tmp_path), np.random.default_rng(0), gt_ext=gt_ext)
    if reader == "pil":
        monkeypatch.setitem(sys.modules, "cv2", None)  # `import cv2` raises ImportError
    outs = {}
    for tag, main in (("port", convert_real_eval.main), ("jax", jconvert.main)):
        outs[tag] = str(tmp_path / tag)
        main(["--gt-dir", gt_dir, "--input-dir", in_dir, "--out", outs[tag],
              "--gt-ext", gt_ext])
    got, want = _payloads(outs["port"]), _payloads(outs["jax"])
    assert sorted(got) == [f"scene{i}.tfrecord" for i in range(3)]
    assert got == want
    ex = next(trec.read_tfrecord_examples(os.path.join(outs["port"], "scene0.tfrecord")))
    assert [ex[k][0] for k in ("height", "width", "ldr_height", "ldr_width")] == \
        [H, W, H // 2, W // 2]


@pytest.mark.parametrize("package", ["port", "jax"])
def test_converter_count_mismatch_exits(tmp_path, package):
    from skyhdr.cli import convert_real_eval as jconvert

    gt_dir, in_dir = _synth_pairs(str(tmp_path), np.random.default_rng(1), n=2)
    os.remove(os.path.join(in_dir, "scene1.jpg"))
    main = convert_real_eval.main if package == "port" else jconvert.main
    with pytest.raises(SystemExit, match="2 GT vs 1 LDR"):
        main(["--gt-dir", gt_dir, "--input-dir", in_dir, "--out", str(tmp_path / "o"),
              "--gt-ext", "hdr"])


@pytest.fixture(scope="module")
def real_records(tmp_path_factory):
    root = tmp_path_factory.mktemp("real")
    gt_dir, in_dir = _synth_pairs(str(root), np.random.default_rng(2))
    out = str(root / "records")
    convert_real_eval.main(["--gt-dir", gt_dir, "--input-dir", in_dir, "--out", out,
                            "--gt-ext", "hdr"])
    return out


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _port_eval(capsys, workdir, *extra):
    evaluate.main(FLAGS + ["--workdir", str(workdir), "--device", "cpu", "--dorf", "",
                           *extra])
    return _last_json(capsys)


@pytest.fixture(scope="module")
def port_real_b2(real_records, tmp_path_factory):
    """The port's `--real-dir` result at b2 (3 images: the last batch padded)."""
    work = tmp_path_factory.mktemp("port_b2")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        evaluate.main(FLAGS + ["--workdir", str(work), "--device", "cpu", "--dorf", "",
                               "--real-dir", real_records, "--batchsize", "2"])
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_evaluate_real_matches_skyhdr(real_records, port_real_b2, tmp_path, capsys):
    from skyhdr.cli import evaluate as jevaluate

    jevaluate.main(FLAGS + ["--workdir", str(tmp_path), "--dorf", "", "--real-dir",
                            real_records, "--batchsize", "2"])
    want = _last_json(capsys)
    got = port_real_b2
    assert sorted(got) == sorted(want) == ["emd", "images", "psnr", "si_rmse"]
    assert got["images"] == want["images"] == 3
    for k in ("psnr", "si_rmse", "emd"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, err_msg=k)


def test_evaluate_real_padding_is_masked(real_records, port_real_b2, tmp_path, capsys):
    """b2 pads the last batch with a repeat; b1 has no padding. psnr is left
    out: its max_val is the batch's maximum, so it moves with the grouping."""
    b1 = _port_eval(capsys, tmp_path, "--real-dir", real_records, "--batchsize", "1")
    assert b1["images"] == port_real_b2["images"] == 3
    np.testing.assert_allclose(port_real_b2["si_rmse"], b1["si_rmse"], rtol=1e-3)
    np.testing.assert_allclose(port_real_b2["emd"], b1["emd"], rtol=5e-2)


def test_render_dir_writes_panels(real_records, tmp_path, capsys):
    pytest.importorskip("matplotlib")
    out = _port_eval(capsys, tmp_path, "--real-dir", real_records, "--batchsize", "2",
                     "--render-dir", str(tmp_path / "render"))
    assert out["images"] == 3
    assert sorted(os.listdir(tmp_path / "render")) == ["batch0000.png", "batch0001.png"]


def test_synthetic_eval_step_matches_skyhdr():
    """degrade (shared draws) -> make_inference_fn -> evaluate_batch."""
    from skyhdr.config import Config, DataConfig, ModelConfig
    from skyhdr.data import degradation as jdeg
    from skyhdr.train.engine import make_inference_fn as j_make_inference_fn
    from skyhdr.train.evaluation import evaluate_batch as j_evaluate_batch
    from skyhdr.utils import io as jio
    from skyhdr_torch.data import degradation as tdeg
    from skyhdr_torch.train.engine import build_models, make_inference_fn
    from skyhdr_torch.train.evaluation import evaluate_batch
    from skyhdr_torch.utils.transplant import load_model_vars

    cfg = Config(model=ModelConfig(im_height=H, im_width=W, use_da_conv=True),
                 data=DataConfig(batch_size=2))
    d = cfg.data
    kw = dict(jpeg_lo=d.jpeg_quality_lo, jpeg_hi=d.jpeg_quality_hi,
              sigma_s_scale=d.sigma_s_scale, sigma_c_scale=d.sigma_c_scale,
              chroma_subsample=d.jpeg_chroma_subsample)
    _, test_t = jio.get_exposure_lists()
    curves = jio.make_synthetic_dorf(201, 1024)[175:]
    jb = jdeg.make_banks(curves, test_t)
    tb = tdeg.make_banks(curves, test_t, device="cpu")
    hdr = np.random.default_rng(4).gamma(1.0, 0.5, (2, H, W, 3)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    want_t, want_ldr = jdeg.degrade_batch(key, jnp.asarray(hdr), jb, **kw)
    k_crf, k_t, k_ss, k_sc, k_ns, k_nc = jax.random.split(key, 6)
    t = lambda a: torch.from_numpy(np.array(a))
    draws = tdeg.Draws(t_idx=t(jax.random.randint(k_t, (2,), 0, len(test_t))).long(),
                       u_s=t(jax.random.uniform(k_ss, (2, 1, 1, 3))),
                       u_c=t(jax.random.uniform(k_sc, (2, 1, 1, 3))),
                       z_s=t(jax.random.normal(k_ns, hdr.shape)),
                       z_c=t(jax.random.normal(k_nc, hdr.shape)),
                       crf_idx=t(jax.random.randint(k_crf, (2,), 0, len(curves))).long())
    hdr_t, ldr = tdeg.degrade_with(torch.from_numpy(hdr), tb, draws, **kw)
    np.testing.assert_allclose(hdr_t.numpy(), np.asarray(want_t), atol=1e-6)

    gv, sv = init_model_vars(cfg, 0)
    gen, sun = build_models(cfg, "cpu")
    load_model_vars(gen, gv)
    load_model_vars(sun, sv)
    got = evaluate_batch(make_inference_fn(cfg)(gen, sun, ldr)["y_final_lin"], hdr_t)
    want = j_evaluate_batch(j_make_inference_fn(cfg)(gv, sv, want_ldr)["y_final_lin"],
                            want_t)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=2e-3,
                                   err_msg=k)


def _synthetic_records(tmp_path):
    rng = np.random.default_rng(6)
    os.makedirs(tmp_path / "test")
    trec.write_tfrecord(str(tmp_path / "test" / "0000.tfrecord"), [
        {"image": rng.uniform(0.0, 4.0, (H, W, 3)).astype(np.float32).tobytes(),
         "azimuth": float(W // 2 - 1), "elevation": float(rng.uniform(2, H - 3))}
        for _ in range(4)])
    return str(tmp_path / "test")


def test_synthetic_cli_repeatable(tmp_path, capsys):
    """Two runs with one --seed print the same JSON; --max-batches 1 scores
    one batch."""
    args = ("--dir", _synthetic_records(tmp_path), "--batchsize", "2", "--max-batches", "1",
            "--seed", "3")
    first = _port_eval(capsys, tmp_path, *args)
    assert first == _port_eval(capsys, tmp_path, *args)
    assert first["images"] == 2
    assert all(np.isfinite(first[k]) for k in ("psnr", "si_rmse", "emd"))


def test_synthetic_cli_from_a_seed_is_skyhdrs(tmp_path, capsys):
    """The synthetic path of both CLIs from `--seed 3` with no checkpoint:
    the same seeded weights and the same degradation draws, two batches
    (the key split once a batch), so the same metrics within the synthetic
    step's rtol 2e-3."""
    from skyhdr.cli import evaluate as jevaluate

    args = ["--dir", _synthetic_records(tmp_path), "--batchsize", "2", "--seed", "3"]
    got = _port_eval(capsys, tmp_path, *args)
    jevaluate.main(FLAGS + ["--workdir", str(tmp_path / "jax"), "--dorf", "", *args])
    want = _last_json(capsys)
    assert got["images"] == want["images"] == 4
    for k in ("psnr", "si_rmse", "emd"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-3, err_msg=k)
