"""Every `skyhdr` CLI's command line parses through its port counterpart to
the same values, and what the port does not run raises NotImplementedError
(more than one step per dispatch), not an argparse exit. Each storage-dtype
knob at bfloat16 runs through the four model CLIs at 16x64 on the CPU, and
a training CLI's checkpoint holds the dtypes the knob stores. Also
`StepTimer`'s stats keys."""

import argparse
import importlib
import os

import numpy as np
import pytest
import torch

# The suite runs in several worker processes that share the CPU.
torch.set_num_threads(1)

CLIS = ("inference", "train", "train_sun", "evaluate", "convert_real_eval",
        "dataset_generator")


class _Parser(Exception):
    def __init__(self, parser):
        self.parser = parser


def _parser_of(package, cli, monkeypatch):
    """The ArgumentParser that `<package>.cli.<cli>.main` builds."""
    main = importlib.import_module(f"{package}.cli.{cli}").main

    def capture(self, args=None, namespace=None):
        raise _Parser(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Parser) as e:
            main([])
    return e.value.parser


def _value(action):
    """A valid value of one flag, as a string."""
    if action.choices:
        return "float32" if "float32" in action.choices else action.choices[-1]
    if action.type is int:
        return "1"
    if action.type is float:
        return "0.5"
    if getattr(action.type, "__name__", "") == "str2bool":  # either package's
        return "true"
    return f"v_{action.dest}"


@pytest.mark.parametrize("cli", CLIS)
def test_skyhdr_command_line_parses_in_port(cli, monkeypatch):
    jax_parser = _parser_of("skyhdr", cli, monkeypatch)
    port_parser = _parser_of("skyhdr_torch", cli, monkeypatch)
    argv = []
    for action in jax_parser._actions:
        if action.option_strings and not isinstance(action, argparse._HelpAction):
            argv += [action.option_strings[-1], _value(action)]
    want = vars(jax_parser.parse_args(argv))
    got = vars(port_parser.parse_args(argv))
    assert len(want) > 3
    assert {k: got.get(k) for k in want} == want
    assert set(got) - set(want) <= {"device"}


def _main(cli):
    return importlib.import_module(f"skyhdr_torch.cli.{cli}").main


def _records(root, n=2, h=16, w=64, seed=0):
    """<root>/{train,test}/0000.tfrecord: `n` random HDR skies each."""
    from skyhdr_torch.data import records as trec

    rng = np.random.default_rng(seed)
    for split in ("train", "test"):
        os.makedirs(os.path.join(root, split))
        trec.write_tfrecord(os.path.join(root, split, "0000.tfrecord"), [
            {"image": rng.uniform(0.0, 4.0, (h, w, 3)).astype(np.float32).tobytes(),
             "azimuth": float(w // 2 - 1), "elevation": float(rng.uniform(2, h - 3))}
            for _ in range(n)])
    return root


def _stored_dtypes(blob):
    """{what: set of dtypes} of a training checkpoint's state_dict."""
    params = {t.dtype for name, sd in blob["modules"].items() for k, t in sd.items()
              if not k.endswith(("mean", "var"))}
    stats = {t.dtype for sd in blob["modules"].values() for k, t in sd.items()
             if k.endswith(("mean", "var"))}
    opts = blob["optimizers"].values()
    moments = {t.dtype for o in opts for k in ("mu", "nu") for t in o.get(k, ())}
    master = {t.dtype for o in opts for t in o.get("master", ())}
    return {"params": params, "stats": stats, "moments": moments, "master": master}


@pytest.mark.parametrize("knob", ["--opt-state-dtype", "--grad-dtype", "--param-dtype"])
@pytest.mark.parametrize("cli", ["inference", "train", "train_sun", "evaluate"])
def test_bf16_knob_runs(cli, knob, tmp_path):
    """The CLI runs with the knob at bfloat16; a training CLI's checkpoint
    stores the parameters, moments and master in the knob's dtypes (the
    gradient staging leaves no trace at rest), BatchNorm statistics float32."""
    from skyhdr_torch.train.checkpoints import CheckpointManager
    from skyhdr_torch.utils.png import write_png

    work = str(tmp_path / "run")
    argv = ["--imheight", "16", "--imwidth", "64", "--batchsize", "2", "--device", "cpu",
            "--dorf", "", "--vgg", "", "--workdir", work, knob, "bfloat16"]
    ds = _records(str(tmp_path / "ds"))
    if cli == "inference":
        os.makedirs(tmp_path / "in")
        write_png(str(tmp_path / "in" / "pano.png"),
                  np.random.default_rng(1).integers(0, 256, (16, 64, 3), dtype=np.uint8))
        argv += ["--indir", str(tmp_path / "in"), "--outdir", str(tmp_path / "out")]
    elif cli == "evaluate":
        argv += ["--dir", os.path.join(ds, "test")]
    else:
        argv += ["--dir", ds, "--epochs", "1", "--ckpt-every", "1"]
        argv += ["--train", "true", "--outputimg-every", "0"] * (cli == "train_sun")
    _main(cli)(argv)
    if cli == "inference":
        assert sorted(os.listdir(tmp_path / "out"))
        return
    if cli == "evaluate":
        return
    name = "SKY" if cli == "train" else "SUN"
    blob = CheckpointManager(os.path.join(work, "checkpoints", name)).read_latest()
    bf16, f32 = {torch.bfloat16}, {torch.float32}
    want = {"params": bf16 if knob == "--param-dtype" else f32,
            "stats": f32 if cli == "train" else set(),
            "moments": bf16 if knob == "--opt-state-dtype" else f32,
            "master": f32 if knob == "--param-dtype" else set()}
    assert _stored_dtypes(blob) == want
    assert blob["param_dtype"] == ("bfloat16" if knob == "--param-dtype" else "float32")


@pytest.mark.parametrize("cli", ["inference", "train", "train_sun", "evaluate"])
def test_steps_per_dispatch_raises(cli, tmp_path):
    with pytest.raises(NotImplementedError, match="one step per dispatch"):
        _main(cli)(["--indir", str(tmp_path)] * (cli == "inference")
                   + ["--device", "cpu", "--steps-per-dispatch", "2"])


def test_step_timer_stats_keys():
    from skyhdr.train.profiling import StepTimer as JStepTimer
    from skyhdr_torch.train.profiling import StepTimer

    durations = [0.004, 0.001, 0.003, 0.010, 0.002]
    timers = StepTimer(), JStepTimer()
    for t in timers:
        assert t.stats() == {}
        t._durations.extend(durations)
    assert timers[0].stats() == timers[1].stats()
    timers[0].start()
    timers[0].stop(torch.ones(2))
    assert timers[0].stats()["steps"] == 6
