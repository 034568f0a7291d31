"""The port's serving CLI serves from checkpoints, as `skyhdr.cli.inference`
does (`skyhdr.cli.common.restore_model_vars`): the newest SKY checkpoint,
its sun-pose net replaced by the newest SUN checkpoint's, and the seeded
weights only when no SKY checkpoint exists. On the CPU at 16x64, the
checkpoints written by the port's own training CLI and `TrainLoop`.

Tolerances: the CLI's outputs against `make_inference_fn` on the modules
that `CheckpointManager.restore_latest` rebuilds, rtol 1e-6 (the same
weights and the same function); the seeded fallback exactly."""

import os

import numpy as np
import pytest
import torch

from skyhdr_torch.cli import inference
from skyhdr_torch.cli.common import restore_model_vars
from skyhdr_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from skyhdr_torch.data import records as trec
from skyhdr_torch.data.degradation import make_banks
from skyhdr_torch.data.pipeline import PanoramaDataset
from skyhdr_torch.train import engine
from skyhdr_torch.train.checkpoints import CheckpointManager
from skyhdr_torch.train.loop import TrainLoop
from skyhdr_torch.utils.io import get_exposure_lists, make_synthetic_dorf
from skyhdr_torch.utils.png import write_png

# The suite runs in several worker processes that share the CPU.
torch.set_num_threads(1)

H, W = 16, 64
CFG = Config(model=ModelConfig(im_height=H, im_width=W),
             data=DataConfig(batch_size=2), train=TrainConfig(ckpt_every_epochs=1))


def _write_records(root, counts, seed=0):
    """<root>/<split>/0000.tfrecord of random HDR skies in the reference's
    record format (BGR float32 image, azimuth, elevation)."""
    rng = np.random.default_rng(seed)
    for split, n in counts.items():
        os.makedirs(os.path.join(root, split))
        examples = [{"image": rng.uniform(0.0, 4.0, (H, W, 3)).astype(np.float32).tobytes(),
                     "azimuth": float(W // 2 - 1), "elevation": float(rng.uniform(2, H - 3))}
                    for _ in range(n)]
        trec.write_tfrecord(os.path.join(root, split, "0000.tfrecord"), examples)
    return root


def _write_pngs(folder, n=2, seed=1):
    rng = np.random.default_rng(seed)
    os.makedirs(folder)
    for i in range(n):
        write_png(os.path.join(folder, f"pano{i}.png"),
                  rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    return folder


@pytest.fixture(scope="module")
def sky_run(tmp_path_factory):
    """One epoch of the training CLI: (workdir, dataset root)."""
    from skyhdr_torch.cli import train

    root = tmp_path_factory.mktemp("restore")
    ds = _write_records(str(root / "ds"), {"train": 2, "test": 2})
    work = str(root / "run")
    train.main(["--dir", ds, "--imheight", str(H), "--imwidth", str(W), "--batchsize", "2",
                "--epochs", "1", "--ckpt-every", "1", "--workdir", work, "--device", "cpu",
                "--dorf", "", "--vgg", ""])
    return work, ds


@pytest.fixture(scope="module")
def pngs(tmp_path_factory):
    folder = _write_pngs(str(tmp_path_factory.mktemp("ldr") / "in"))
    imgs = np.stack([inference._imread01(os.path.join(folder, f"pano{i}.png"))
                     for i in range(2)])
    return folder, torch.from_numpy(imgs)


def _serve(monkeypatch, indir, outdir, *extra):
    """The CLI's outputs {name: hdr}, caught before the .hdr encoding."""
    got = {}
    monkeypatch.setattr(inference, "write_hdr",
                        lambda path, hdr: got.__setitem__(os.path.basename(path), hdr))
    inference.main(["--indir", indir, "--outdir", outdir, "--imheight", str(H),
                    "--imwidth", str(W), "--batch", "2", "--device", "cpu", *extra])
    return np.stack([got[f"pano{i}.hdr"] for i in range(2)])


def _expected(gen, sun, ldr):
    with torch.no_grad():
        return engine.make_inference_fn(CFG)(gen, sun, ldr)["y_final_lin"].numpy()


def _seeded(seed=0):
    """The generator and sun-pose net of `create_gan_state(CFG, seed)`,
    whose trees `skyhdr`'s serving fallback takes."""
    state = engine.create_gan_state(CFG, seed, "cpu")
    return state.gen.eval(), state.sun.eval()


def _sun_checkpoint(work, ds, seed=7):
    """One SUN pretrain epoch from other weights than the SKY run's, saved
    under <work>/checkpoints/SUN; returns its sun-pose net's state_dict."""
    banks = make_banks(make_synthetic_dorf(201, 1024)[:175], get_exposure_lists()[0],
                       device="cpu")
    kw = dict(imshape=(H, W, 3), batch_size=2, seed=0)
    TrainLoop(CFG, "SUN", lambda: engine.create_sun_state(CFG, seed, "cpu"),
              engine.make_sun_train_step(CFG, banks), engine.make_sun_eval_step(CFG, banks),
              PanoramaDataset(os.path.join(ds, "train"), **kw),
              PanoramaDataset(os.path.join(ds, "test"), shuffle=False, **kw),
              workdir=work, log=lambda *_: None, device="cpu").run(epochs=1)
    return CheckpointManager(os.path.join(work, "checkpoints", "SUN")).read_latest()[
        "modules"]["sun"]


def _state_equal(module, state):
    got = module.state_dict()
    return sorted(got) == sorted(state) and all(torch.equal(got[k], v)
                                                for k, v in state.items())


def test_cli_serves_the_newest_sky_checkpoint(sky_run, pngs, tmp_path, monkeypatch, capsys):
    work, _ = sky_run
    indir, ldr = pngs
    out = _serve(monkeypatch, indir, str(tmp_path / "out"), "--workdir", work)
    assert "Latest SKY checkpoint restored" in capsys.readouterr().out
    state = CheckpointManager(os.path.join(work, "checkpoints", "SKY")).restore_latest(
        CFG, "cpu")
    want = _expected(state.gen, state.sun, ldr)
    np.testing.assert_allclose(out, want, rtol=1e-6, atol=0)
    # The epoch moved the weights: serving the seed would differ.
    assert not np.allclose(out, _expected(*_seeded(), ldr), rtol=1e-3)


def test_cli_without_a_sky_checkpoint_serves_the_seed(pngs, tmp_path, monkeypatch, capsys):
    indir, ldr = pngs
    empty = tmp_path / "empty"
    empty.mkdir()
    out = _serve(monkeypatch, indir, str(tmp_path / "out"), "--workdir", str(empty),
                 "--seed", "3")
    assert "checkpoint restored" not in capsys.readouterr().out
    np.testing.assert_array_equal(out, _expected(*_seeded(3), ldr))
    assert not (empty / "checkpoints").exists()  # reading creates no directory


def test_sun_checkpoint_overrides_only_the_sun_pose_net(sky_run, pngs, tmp_path,
                                                        monkeypatch, capsys):
    work, ds = sky_run
    indir, ldr = pngs
    sun_dir = str(tmp_path / "sunrun")
    sun_state = _sun_checkpoint(sun_dir, ds)
    sky_dir = os.path.join(work, "checkpoints", "SKY")
    sky = CheckpointManager(sky_dir).read_latest()["modules"]
    logs = []
    gen, sun = restore_model_vars(CFG, work, sun=os.path.join(sun_dir, "checkpoints", "SUN"),
                                  device="cpu", log=logs.append)
    assert logs == ["Latest SKY checkpoint restored", "Latest SUN checkpoint restored"]
    assert _state_equal(gen, sky["gen"]) and _state_equal(sun, sun_state)
    assert not _state_equal(sun, sky["sun"])
    # Through the CLI, with --sky and --sun naming the directories.
    out = _serve(monkeypatch, indir, str(tmp_path / "out"), "--workdir", str(tmp_path),
                 "--sky", sky_dir, "--sun", os.path.join(sun_dir, "checkpoints", "SUN"))
    text = capsys.readouterr().out
    assert "Latest SKY checkpoint restored" in text and "Latest SUN checkpoint restored" in text
    np.testing.assert_allclose(out, _expected(gen, sun, ldr), rtol=1e-6, atol=0)
    # A SUN checkpoint without a SKY one: the seeded generator, the SUN net.
    logs.clear()
    gen, sun = restore_model_vars(CFG, sun_dir, seed=5, device="cpu", log=logs.append)
    seeded_gen, _ = _seeded(5)
    assert logs == ["Latest SUN checkpoint restored"]
    assert _state_equal(gen, seeded_gen.state_dict()) and _state_equal(sun, sun_state)
