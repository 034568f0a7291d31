"""The port's sun-pose pretraining CLI (`skyhdr_torch.cli.train_sun`) on the
CPU at 16x64 DA.

- `--train true` writes the per-epoch dumps `skyhdr`'s does (the file set
  `tests/test_integration.py` asserts for it) and a SUN checkpoint.
- `--train false` writes the six-panel figure per .hdr; from that SUN
  checkpoint it prints the restore line, reading the checkpoint to the
  host and touching none of its optimizer tensors.
- The CAM-gated prediction against `skyhdr`'s expression
  (`skyhdr/cli/train_sun.py:128-132`) on the same weights
  (`init_model_vars(cfg, 0)`) and the same LDR, the JAX side built from
  `sunpose_with_cams` and `resize_bilinear`: rtol 1e-3 (the serving
  golden's), atol 1e-3 of the map's maximum. With seeded weights the CAMs
  are ~1e-5, so the +1e-5 of the normalisation sets the gated map's scale
  (~3e-3): an absolute 1e-3 would hold nothing.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyhdr_torch.cli import train_sun
from skyhdr_torch.data import records as trec
from skyhdr_torch.train.checkpoints import CheckpointManager
from skyhdr_torch.utils import io as tio

# The suite runs in several worker processes that share the CPU.
torch.set_num_threads(1)

H, W = 16, 64
FLAGS = ["--imheight", str(H), "--imwidth", str(W), "--da-conv", "true",
         "--device", "cpu", "--dorf", ""]


@pytest.fixture(scope="module")
def sun_run(tmp_path_factory):
    """One `--train true` epoch with dumps: the work directory."""
    pytest.importorskip("matplotlib")
    root = tmp_path_factory.mktemp("sun")
    rng = np.random.default_rng(0)
    for split in ("train", "test"):
        os.makedirs(root / "data" / split)
        for i in range(4):
            img = (rng.uniform(0, 1, size=(H, W, 3)) ** 2 * 3).astype(np.float32)
            trec.write_tfrecord(str(root / "data" / split / f"{split}{i}.tfrecord"),
                                [{"image": img.tobytes(), "azimuth": 31.0,
                                  "elevation": float(4 + i)}])
    train_sun.main(FLAGS + ["--train", "true", "--dir", str(root / "data"),
                            "--batchsize", "2", "--epochs", "1", "--ckpt-every", "1",
                            "--workdir", str(root), "--outputimg-every", "1"])
    return root


def test_train_epoch_dumps(sun_run):
    val = sun_run / "outputImg" / "SUN" / "val"
    for name in ("pred", "sungt", "sun_cam1", "sun_cam2", "sun_cam3"):
        assert (val / name / "epoch1.png").exists(), name
    gts = sorted((sun_run / "outputImg" / "SUN" / "groundTruth").glob("*.hdr"))
    assert [p.name for p in gts] == ["0_gt.hdr", "1_gt.hdr"]  # the last eval batch, b2
    assert np.isfinite(tio.read_hdr(str(gts[0]))).all()
    assert CheckpointManager(str(sun_run / "checkpoints" / "SUN")).steps() == [1]


def _hdr_dir(root):
    hdr_dir = root / "hdrs"
    hdr_dir.mkdir()
    rng = np.random.default_rng(3)
    img = (rng.uniform(0, 1, size=(H, W, 3)) ** 2 * 4).astype(np.float32)
    img[5, 30] = 300.0
    tio.write_hdr(str(hdr_dir / "scene.hdr"), img)
    return hdr_dir


def test_eval_mode_six_panels_seeded(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    train_sun.main(FLAGS + ["--train", "false", "--inference_img_dir",
                            str(_hdr_dir(tmp_path)), "--workdir", str(tmp_path)])
    assert (tmp_path / "outputImg" / "SUN" / "eval" / "scene.png").exists()
    assert "checkpoint restored" not in capsys.readouterr().out


def test_eval_mode_restores_sun_on_host(sun_run, tmp_path, monkeypatch, capsys):
    """The checkpoint is read to the host (`read_latest`) and only its
    sun-pose tensors are used: the restore runs on a blob without the
    optimizer moments, and the full-state restore is never called."""
    from skyhdr_torch.config import Config, ModelConfig

    read = CheckpointManager.read_latest

    def read_latest(self):
        blob = read(self)
        assert all(t.device.type == "cpu" for t in blob["modules"]["sun"].values())
        return {k: v for k, v in blob.items() if k != "optimizers"}

    def restore_latest(self, *a, **kw):
        raise AssertionError("the whole state was rebuilt")

    monkeypatch.setattr(CheckpointManager, "read_latest", read_latest)
    monkeypatch.setattr(CheckpointManager, "restore_latest", restore_latest)
    cfg = Config(model=ModelConfig(im_height=H, im_width=W, use_da_conv=True))
    sun = train_sun.restore_sun_net(cfg, str(sun_run), device="cpu")
    assert "Latest SUN checkpoint restored" in capsys.readouterr().out
    want = read(CheckpointManager(str(sun_run / "checkpoints" / "SUN")))["modules"]["sun"]
    got = sun.state_dict()
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], v) for k, v in want.items())

    train_sun.main(FLAGS + ["--train", "false", "--inference_img_dir",
                            str(_hdr_dir(tmp_path)), "--workdir", str(sun_run)])
    assert "Latest SUN checkpoint restored" in capsys.readouterr().out
    assert (sun_run / "outputImg" / "SUN" / "eval" / "scene.png").exists()


def test_cam_gated_prediction_matches_skyhdr():
    from skyhdr.config import Config, ModelConfig
    from skyhdr.models.gradcam import sunpose_with_cams as j_sunpose_with_cams
    from skyhdr.models.sunpose import SunPoseNet as JSunPoseNet
    from skyhdr.ops.resize import resize_bilinear as j_resize
    from skyhdr_torch.models.gradcam import sunpose_with_cams
    from skyhdr_torch.models.sunpose import SunPoseNet
    from skyhdr_torch.utils.transplant import init_model_vars, load_model_vars

    cfg = Config(model=ModelConfig(im_height=H, im_width=W, use_da_conv=True))
    _, sv = init_model_vars(cfg, 0)
    ldr = np.random.default_rng(7).uniform(0, 1, (1, H, W, 3)).astype(np.float32)

    jsun = JSunPoseNet(cfg.model)
    sm, cams = jax.jit(lambda v, x: j_sunpose_with_cams(
        lambda vv, xx, eps: jsun.apply(vv, xx, eps), v, x, None))(
            jax.tree_util.tree_map(jnp.asarray, sv), jnp.asarray(ldr))
    # skyhdr/cli/train_sun.py:126-132
    pred = np.asarray(sm).reshape(H, W)
    cam2_up = np.asarray(j_resize(cams[1], (H, W)))[0, ..., 0]
    want = np.asarray(cams[0])[0, ..., 0] * cam2_up * pred
    want = want / (want.max() + 1e-5)

    sun = SunPoseNet(cfg.model, device="cpu").eval().requires_grad_(False)
    load_model_vars(sun, sv)
    tsm, tcams = sunpose_with_cams(sun, torch.from_numpy(ldr), torch.float32)
    got_pred, got = train_sun.cam_gated_prediction(tsm, tcams, H, W)
    assert got.shape == (H, W)
    assert int(got_pred.argmax()) == int(pred.argmax())
    for name, g, w in (("pred", got_pred.numpy(), pred), ("sum_pred", got.numpy(), want)):
        assert w.max() > 0, name
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3 * w.max(), err_msg=name)
