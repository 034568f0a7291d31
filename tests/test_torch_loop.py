"""The port's training orchestration against `skyhdr`'s on the CPU: the
TFRecord codec, the input pipeline, the TensorBoard writer, the eval steps,
`TrainLoop` (with a deterministic fake step, then with the real GAN step
and an exact resume) and the training CLI, with its SUN -> SKY hand-off.

Tolerances: the eval steps' metrics rtol 1e-4 (atol 1e-6) as the train
steps' in `tests/test_torch_train.py`, their outputs rtol / atol 1e-3 as the
serving forward in `tests/test_torch_slice.py`; everything else exact."""

import gzip
import importlib.util
import os
import struct

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyhdr.data import pipeline as jpipe
from skyhdr.data import records as jrec
from skyhdr.train import metrics as jmetrics
from skyhdr_torch.config import Config, DataConfig, ModelConfig, TrainConfig
from skyhdr_torch.data import pipeline as tpipe
from skyhdr_torch.data import records as trec
from skyhdr_torch.data.degradation import make_banks
from skyhdr_torch.models.vgg16 import random_vgg16_weights
from skyhdr_torch.train import engine as tengine
from skyhdr_torch.train import metrics as tmetrics
from skyhdr_torch.train.checkpoints import CheckpointManager
from skyhdr_torch.train.loop import TrainLoop
from skyhdr_torch.utils.io import get_exposure_lists, make_synthetic_dorf

# The suite runs in several worker processes that share the CPU; torch's
# default of one thread per core in each of them oversubscribes it.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


G = _load_tool("make_torch_golden")


def _write_dataset(root, h, w, counts, seed=0, per_file=1):
    """Synthetic skies (`tools/make_synth_dataset.synth_panorama`) written
    with the port's writer as <root>/<split>/NNNN.tfrecord."""
    synth = _load_tool("make_synth_dataset").synth_panorama
    rng = np.random.default_rng(seed)
    for split, n in counts.items():
        d = os.path.join(root, split)
        os.makedirs(d)
        examples = []
        for i in range(n):
            img, sun_y = synth(rng, h, w)
            examples.append({"image": img[:, :, ::-1].tobytes(),
                             "azimuth": float(w * 0.5 - 1.0), "elevation": float(sun_y)})
        for f in range(0, n, per_file):
            trec.write_tfrecord(os.path.join(d, f"{f // per_file:04d}.tfrecord"),
                                examples[f:f + per_file])
    return root


# --- records ----------------------------------------------------------------

def test_records_bytes_equal_and_cross_read(tmp_path):
    rng = np.random.default_rng(0)
    examples = [{"image": rng.random((4, 8, 3), np.float32).tobytes(),
                 "azimuth": float(rng.random()), "elevation": float(rng.random()),
                 "ids": [1, 2 ** 40, 7], "names": [b"a", b"bc"]} for _ in range(3)]
    for comp in ("", "GZIP"):
        pt, pj = str(tmp_path / f"t{comp}.tfrecord"), str(tmp_path / f"j{comp}.tfrecord")
        trec.write_tfrecord(pt, examples, compression=comp)
        jrec.write_tfrecord(pj, examples, compression=comp)
        read = (lambda p: gzip.open(p).read()) if comp else (lambda p: open(p, "rb").read())
        assert read(pt) == read(pj)  # gzip headers carry a time stamp
        for a, b in ((pt, jrec), (pj, trec)):
            got = list(b.read_tfrecord_examples(a, compression=comp, verify_crc=True))
            assert got == [jrec.decode_example(jrec.encode_example(e)) for e in examples]


def test_records_crc_mismatch_raises(tmp_path):
    p = str(tmp_path / "x.tfrecord")
    trec.write_tfrecord(p, [{"elevation": 1.0}], compression="")
    data = bytearray(open(p, "rb").read())
    data[-1] ^= 1
    open(p, "wb").write(bytes(data))
    with pytest.raises(ValueError, match="crc"):
        list(trec.iter_tfrecord(p, compression="", verify_crc=True))


# --- pipeline ---------------------------------------------------------------

@pytest.fixture(scope="module")
def small_ds(tmp_path_factory):
    return _write_dataset(str(tmp_path_factory.mktemp("ds")), 8, 32,
                          {"train": 12, "test": 4}, per_file=2)


@pytest.mark.parametrize("kind", ["cached", "streaming", "synthetic"])
def test_pipeline_batches_match_skyhdr(small_ds, kind):
    split = os.path.join(small_ds, "train")
    kw = dict(imshape=(8, 32, 3), batch_size=3, shuffle=True, seed=5, decode_workers=2)
    if kind == "synthetic":
        t, j = (mod.synthetic_dataset(12, (8, 32, 3), seed=5, batch_size=3)
                for mod in (tpipe, jpipe))
    elif kind == "cached":
        t, j = tpipe.PanoramaDataset(split, **kw), jpipe.PanoramaDataset(split, **kw)
    else:
        kw.update(shuffle_buffer=5)
        t = tpipe.StreamingPanoramaDataset(split, **kw)
        j = jpipe.StreamingPanoramaDataset(split, process_index=0, process_count=1, **kw)
    assert len(t) == len(j) == 4
    for _ in range(2):  # two epochs: the reshuffle follows the same stream
        tb, jb = list(t), list(j)
        assert len(tb) == len(jb) == 4
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a["hdr"], b["hdr"])
            np.testing.assert_array_equal(a["elevation"], b["elevation"])


def test_prefetch_yields_tensors_in_order_and_raises():
    batches = [{"hdr": np.full((2, 3), i, np.float32)} for i in range(5)]
    got = [b["hdr"] for b in tpipe.prefetch_to_device(iter(batches), "cpu", size=2)]
    assert [int(g[0, 0]) for g in got] == list(range(5))

    def failing():
        yield batches[0]
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(tpipe.prefetch_to_device(failing(), "cpu"))


# --- metrics ----------------------------------------------------------------

def _read_varint(buf, pos):
    return jrec._read_varint(buf, pos)


def _scalars(logdir):
    """[(tag, step, value)] of the scalar events of one TB directory, read
    with `skyhdr.data.records`."""
    (name,) = os.listdir(logdir)
    out = []
    for rec in jrec.iter_tfrecord(os.path.join(logdir, name), compression="",
                                  verify_crc=True):
        pos, step, summary = 0, 0, None
        while pos < len(rec):
            key, pos = _read_varint(rec, pos)
            field, wire = key >> 3, key & 7
            if wire == 1:
                pos += 8
            elif wire == 0:
                val, pos = _read_varint(rec, pos)
                step = val if field == 2 else step
            else:
                ln, pos = _read_varint(rec, pos)
                if field == 5:
                    summary = rec[pos:pos + ln]
                pos += ln
        if summary is not None:
            _, p = _read_varint(summary, 0)
            _, p = _read_varint(summary, p)
            _, p = _read_varint(summary, p)       # value: tag field
            n, p = _read_varint(summary, p)
            tag = summary[p:p + n].decode()
            value = struct.unpack("<f", summary[p + n + 1:p + n + 5])[0]
            out.append((tag, step, value))
    return out


def test_event_writer_matches_skyhdr(tmp_path):
    for mod, d in ((tmetrics, "t"), (jmetrics, "j")):
        w = mod.EventWriter(str(tmp_path / d))
        w.scalars({"gen_total": 1.5, "kl": 0.25}, 1)
        w.scalars({"gen_total": 1.25, "kl": 0.125}, 2)
        w.close()
    got = _scalars(str(tmp_path / "t"))
    assert got == _scalars(str(tmp_path / "j"))
    assert got == [("gen_total", 1, 1.5), ("kl", 1, 0.25), ("gen_total", 2, 1.25),
                   ("kl", 2, 0.125)]


def test_mean_metrics_matches_skyhdr():
    vals = [{"a": 1.0, "b": 3.0}, {"a": 2.0, "b": 5.5}, {"a": 4.0, "b": -1.0}]
    t, j = tmetrics.MeanMetrics(), jmetrics.MeanMetrics()
    for v in vals:
        t.update({k: torch.tensor(x) for k, x in v.items()})
        j.update({k: jnp.asarray(x) for k, x in v.items()})
    assert t.result() == pytest.approx(j.result(), rel=1e-12)
    t.reset()
    assert t.result() == {}


# --- eval steps -------------------------------------------------------------

@pytest.fixture(scope="module")
def golden():
    return np.load(G.TRAIN_FIXTURE)


@pytest.fixture(scope="module")
def banks():
    return make_banks(make_synthetic_dorf(175, 1024), get_exposure_lists()[0], device="cpu")


def _jax_side(stored):
    """(jax cfg, banks, batch, key, GanState, SunState) of the train golden."""
    from skyhdr.config import Config as JConfig
    from skyhdr.config import DataConfig as JDataConfig
    from skyhdr.config import ModelConfig as JModelConfig
    from skyhdr.data.degradation import make_banks as j_make_banks
    from skyhdr.train import engine
    from skyhdr.utils.io import get_exposure_lists as j_exp
    from skyhdr.utils.io import make_synthetic_dorf as j_dorf
    from skyhdr_torch.utils.transplant import init_gan_vars

    tcfg = G.golden_config()
    cfg = JConfig(model=JModelConfig(**vars(tcfg.model)), data=JDataConfig(batch_size=G.BATCH))
    seed = int(stored["seed"])
    gv, sv, dv = init_gan_vars(tcfg, seed)
    lr = cfg.train.learning_rate
    state = engine.GanState(
        gen_vars=gv, sun_vars=sv, disc_vars=dv,
        opt_gen=engine._rmsprop(lr).init((gv["params"], sv["params"])),
        opt_disc=engine._rmsprop(lr).init(dv["params"]),
        step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32))
    sun_state = engine.SunState(sun_vars={"params": sv["params"]},
                                opt=engine._adam(lr).init(sv["params"]),
                                step=jnp.zeros((), jnp.int32), epoch=jnp.zeros((), jnp.int32))
    hdr, elevation = G.train_batch(seed)
    batch = {"hdr": jnp.asarray(hdr), "elevation": jnp.asarray(elevation)}
    banks = j_make_banks(j_dorf(175, 1024), j_exp()[0])
    return cfg, banks, batch, jax.random.PRNGKey(seed + 1), state, sun_state


def _inputs(stored):
    return [torch.from_numpy(np.array(stored[k])) for k in ("hdr_t", "ldr", "sunpose_gt")]


def _check_metrics(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-4, abs=1e-6), k


def test_eval_steps_match_skyhdr(golden, banks):
    from skyhdr.models.vgg16 import random_vgg16_weights as j_vgg
    from skyhdr.train import engine

    cfg, jbanks, batch, key, jstate, jsun = _jax_side(golden)
    hdr_t, _ = engine._degrade(cfg, jbanks, key, batch["hdr"])
    np.testing.assert_array_equal(np.asarray(hdr_t), golden["hdr_t"])  # the same pair
    tcfg = G.golden_config()
    seed = int(golden["seed"])

    want_m, want_o = engine.make_gan_eval_step(cfg, jbanks, j_vgg())(jstate, batch, key)
    state = G.harness_gan_state(tcfg, seed, "cpu")
    step = tengine.make_gan_eval_step(tcfg, banks, random_vgg16_weights())
    got_m, got_o = step.eval_on(state, *_inputs(golden))
    _check_metrics(got_m, want_m)
    assert sorted(got_o) == sorted(want_o)
    for k in want_o:
        np.testing.assert_allclose(got_o[k].numpy(), np.asarray(want_o[k]), rtol=1e-3,
                                   atol=1e-3, err_msg=k)

    want_m, want_o = engine.make_sun_eval_step(cfg, jbanks)(jsun, batch, key)
    sun_state = G.harness_sun_state(tcfg, seed, "cpu")
    got_m, got_o = tengine.make_sun_eval_step(tcfg, banks).eval_on(sun_state, *_inputs(golden))
    _check_metrics(got_m, want_m)
    for k in ("pred", "gt"):
        np.testing.assert_allclose(got_o[k].numpy(), np.asarray(want_o[k]), rtol=1e-3,
                                   atol=1e-3, err_msg=k)
    for a, b in zip(got_o["cams"], want_o["cams"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-3)


# --- loop -------------------------------------------------------------------

@flax.struct.dataclass
class _JState:
    w: jnp.ndarray
    step: jnp.ndarray
    epoch: jnp.ndarray


def test_loop_mechanics_match_skyhdr(small_ds, tmp_path):
    """The same fake steps under both loops: batch order, eval calls, the
    epochs saved and kept, and the TensorBoard scalars."""
    from skyhdr.config import Config as JConfig
    from skyhdr.config import TrainConfig as JTrainConfig
    from skyhdr.train.loop import TrainLoop as JTrainLoop

    tc = dict(ckpt_every_epochs=1, ckpt_max_to_keep=2)
    tcfg = Config(model=ModelConfig(im_height=8, im_width=32), train=TrainConfig(**tc))
    jcfg = JConfig(train=JTrainConfig(**tc))
    seen = {"t": [], "j": []}

    def make(tag, as_array):
        def train_step(state, batch, _rng):
            seen[tag].append(("train", np.asarray(batch["elevation"]).tolist()))
            if tag == "t":
                state.step += 1
            else:
                state = state.replace(step=state.step + 1)
            return state, {"m": as_array(batch["hdr"].mean()),
                           "e": as_array(batch["elevation"].sum())}

        def eval_step(state, batch, _rng):
            seen[tag].append(("eval", np.asarray(batch["elevation"]).tolist()))
            return {"m": as_array(batch["hdr"].max())}, {}
        return train_step, eval_step

    kw = dict(imshape=(8, 32, 3), batch_size=3, seed=1)
    for tag in ("t", "j"):
        pipe = tpipe if tag == "t" else jpipe
        train_ds = pipe.PanoramaDataset(os.path.join(small_ds, "train"), shuffle=True, **kw)
        test_ds = pipe.PanoramaDataset(os.path.join(small_ds, "test"), shuffle=False, **kw)
        workdir = str(tmp_path / tag)
        if tag == "t":
            factory = lambda: tengine.empty_sun_state(tcfg, "cpu")
            loop = TrainLoop(tcfg, "SUN", factory, *make("t", torch.as_tensor), train_ds,
                             test_ds, workdir=workdir, log=lambda *_: None, device="cpu")
        else:
            factory = lambda: _JState(w=jnp.zeros(3), step=jnp.zeros((), jnp.int32),
                                      epoch=jnp.zeros((), jnp.int32))
            loop = JTrainLoop(jcfg, "SUN", factory, *make("j", jnp.asarray), train_ds,
                              test_ds, workdir=workdir, log=lambda *_: None)
        assert not loop.resumed
        loop.run(epochs=3)
        assert int(loop.state.epoch) == 3 and int(loop.state.step) == 12
    assert seen["t"] == seen["j"] and len(seen["t"]) == 3 * (4 + 1)
    ckpts = {tag: sorted(int(n) for n in os.listdir(tmp_path / tag / "checkpoints" / "SUN")
                         if n.isdigit()) for tag in ("t", "j")}
    assert ckpts["t"] == ckpts["j"] == [2, 3]
    for split in ("train", "val"):
        tb = {tag: _scalars(os.path.join(_only_dir(tmp_path / tag / "tensorboard" / "SUN"),
                                         split)) for tag in ("t", "j")}
        assert [r[:2] for r in tb["t"]] == [r[:2] for r in tb["j"]]
        assert [r[2] for r in tb["t"]] == pytest.approx([r[2] for r in tb["j"]], rel=1e-6)
        assert len(tb["t"]) == (6 if split == "train" else 3)


def _only_dir(path):
    (name,) = os.listdir(path)
    return os.path.join(path, name)


def _snapshot(state):
    blob = tengine.state_dict(state)
    flat = {f"{g}/{n}/{k}": v.clone() for g in ("modules",) for n, sd in blob[g].items()
            for k, v in sd.items()}
    for n, o in blob["optimizers"].items():
        for k, v in o.items():
            if isinstance(v, list):
                flat.update({f"opt/{n}/{k}/{i}": t.clone() for i, t in enumerate(v)})
            else:
                flat[f"opt/{n}/{k}"] = v
    return flat, blob["step"], blob["epoch"]


def test_loop_resume_is_exact(tmp_path, banks):
    """Two epochs of the real GAN step, then a resume: the restored state
    equals the saved one bit for bit, and the factory is not called."""
    cfg = Config(model=ModelConfig(im_height=16, im_width=64, use_da_conv=True),
                 data=DataConfig(batch_size=2), train=TrainConfig(ckpt_every_epochs=1))
    ds = _write_dataset(str(tmp_path / "ds"), 16, 64, {"train": 4, "test": 2})
    kw = dict(imshape=(16, 64, 3), batch_size=2, seed=0)
    train_ds = tpipe.PanoramaDataset(os.path.join(ds, "train"), shuffle=True, **kw)
    test_ds = tpipe.PanoramaDataset(os.path.join(ds, "test"), shuffle=False, **kw)
    vgg = random_vgg16_weights()
    steps = (tengine.make_gan_train_step(cfg, banks, vgg),
             tengine.make_gan_eval_step(cfg, banks, vgg))
    hooked = []
    loop = TrainLoop(cfg, "SKY", lambda: tengine.create_gan_state(cfg, 0, "cpu"), *steps,
                     train_ds, test_ds, workdir=str(tmp_path), log=lambda *_: None,
                     device="cpu", epoch_hook=lambda e, out, b: hooked.append((e, sorted(out))))
    loop.run(epochs=2)
    assert [e for e, _ in hooked] == [1, 2] and "y_final_lin" in hooked[0][1]
    saved = _snapshot(loop.state)
    assert saved[1:] == (4, 2)

    def factory():
        raise AssertionError("a resume must not draw a new state")

    again = TrainLoop(cfg, "SKY", factory, *steps, train_ds, test_ds, workdir=str(tmp_path),
                      log=lambda *_: None, device="cpu")
    assert again.resumed
    got = _snapshot(again.state)
    assert got[1:] == saved[1:] and sorted(got[0]) == sorted(saved[0])
    for k, v in saved[0].items():
        assert torch.equal(got[0][k], v) if torch.is_tensor(v) else got[0][k] == v, k
    again.run(epochs=3)
    assert again.state.epoch == 3 and again.ckpt.steps() == [1, 2, 3]


def test_loop_rejects_chunked_dispatch():
    cfg = Config(train=TrainConfig(steps_per_dispatch=4))
    with pytest.raises(NotImplementedError, match="steps_per_dispatch"):
        TrainLoop(cfg, "SKY", None, None, None, [], [], device="cpu")


# --- CLI --------------------------------------------------------------------

def test_train_cli_runs_resumes_and_takes_the_sun_checkpoint(tmp_path, banks, capsys):
    from skyhdr_torch.cli import train

    h, w = 16, 64
    ds = _write_dataset(str(tmp_path / "ds"), h, w, {"train": 4, "test": 2})
    cfg = Config(model=ModelConfig(im_height=h, im_width=w, use_da_conv=True),
                 data=DataConfig(batch_size=2), train=TrainConfig(ckpt_every_epochs=1))
    # A SUN pretrain epoch from other weights than the SKY run draws.
    kw = dict(imshape=(h, w, 3), batch_size=2, seed=0)
    sun_loop = TrainLoop(cfg, "SUN", lambda: tengine.create_sun_state(cfg, 7, "cpu"),
                         tengine.make_sun_train_step(cfg, banks),
                         tengine.make_sun_eval_step(cfg, banks),
                         tpipe.PanoramaDataset(os.path.join(ds, "train"), **kw),
                         tpipe.PanoramaDataset(os.path.join(ds, "test"), shuffle=False, **kw),
                         workdir=str(tmp_path), log=lambda *_: None, device="cpu")
    sun_loop.run(epochs=1)
    args = ["--dir", ds, "--imheight", str(h), "--imwidth", str(w), "--da-conv", "true",
            "--batchsize", "2", "--ckpt-every", "1", "--workdir", str(tmp_path),
            "--device", "cpu", "--dorf", "", "--vgg", ""]
    # lr 0: the SKY run moves no weight, so its checkpoint shows the hand-off.
    train.main(args + ["--epochs", "1", "--lr", "0"])
    out = capsys.readouterr().out
    assert "Pretrained SUN checkpoint restored for fine-tuning" in out
    assert "Epoch 1:" in out
    sky = CheckpointManager(str(tmp_path / "checkpoints" / "SKY"))
    sun = CheckpointManager(str(tmp_path / "checkpoints" / "SUN")).read_latest()
    got = sky.read_latest()["modules"]["sun"]
    assert sorted(got) == sorted(sun["modules"]["sun"])
    assert all(torch.equal(got[k], v) for k, v in sun["modules"]["sun"].items())
    train.main(args + ["--epochs", "2"])
    out = capsys.readouterr().out
    assert "Latest SKY checkpoint restored (epoch 1)" in out
    assert "Pretrained SUN" not in out and "Epoch 2:" in out and "Epoch 1:" not in out
    assert sky.steps() == [1, 2]
