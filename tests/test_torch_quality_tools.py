"""The quality-run tools of the port on the CPU: its synthetic-sky writer
against `tools/make_synth_dataset.py`, `skyhdr_torch.tools.quality_run`'s
stages at 16x64 (the dataset, the untrained floor, SUN, the GAN and the
evaluation, each a subprocess), its skips and resumes, and
`tools/quality_report.py` reading the port's event files."""

import gzip
import importlib.util
import json
import math
import os
import re
import sys
from contextlib import redirect_stdout
from io import StringIO
from pathlib import Path

import numpy as np
import pytest

from skyhdr.data.records import read_tfrecord_examples as j_read
from skyhdr_torch.data.records import read_tfrecord_examples
from skyhdr_torch.tools import make_synth_dataset, quality_run

ROOT = Path(__file__).resolve().parent.parent


def _tool(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dataset_writers_agree(tmp_path, monkeypatch):
    """The same flags through both writers: the same shard files, whose
    gunzipped payloads are equal (the gzip headers carry a time), and the
    same decoded examples through both packages' readers."""
    flags = ["--n-train", "3", "--n-test", "2", "--imheight", "16", "--imwidth", "64"]
    make_synth_dataset.main(["--out", str(tmp_path / "port"), *flags])
    monkeypatch.setattr(sys, "argv", ["make_synth_dataset.py", "--out",
                                      str(tmp_path / "skyhdr"), *flags])
    _tool("make_synth_dataset").main()
    for split, n in (("train", 3), ("test", 2)):
        ours, theirs = tmp_path / "port" / split, tmp_path / "skyhdr" / split
        files = sorted(p.name for p in ours.iterdir())
        assert files == sorted(p.name for p in theirs.iterdir()) == ["0000.tfrecord"]
        for f in files:
            assert gzip.decompress((ours / f).read_bytes()) == \
                gzip.decompress((theirs / f).read_bytes())
        got, want = list(read_tfrecord_examples(str(ours))), list(j_read(str(theirs)))
        assert len(got) == len(want) == n
        for a, b in zip(got, want):
            assert a.keys() == b.keys()
            for k in a:
                assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


SMALL = ["--preset", "plain32", "--device", "cpu", "--imheight", "16", "--imwidth", "64",
         "--n-train", "4", "--n-test", "2", "--batchsize", "2", "--sun-epochs", "1",
         "--gan-epochs", "1", "--ckpt-every", "1", "--stages", "floor,sun,gan,eval"]


def _last_json(text):
    return json.loads(text.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One quality run at 16x64 on the CPU: (work dir, its output)."""
    work = tmp_path_factory.mktemp("qrun")
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")
    out = StringIO()
    with redirect_stdout(out):
        quality_run.main([*SMALL, "--work", str(work)])
    mp.undo()
    return work, out.getvalue()


def test_quality_run_drives_every_stage(run):
    work, text = run
    result = _last_json(text)
    assert result["preset"] == "plain32" and result["work"] == str(work)
    assert sorted(result["results"]) == ["eval", "floor"]
    assert result["results"]["floor"]["checkpoints"] == {}
    assert result["results"]["eval"]["checkpoints"] == {"SUN": 1, "SKY": 1}
    for row in result["results"].values():
        assert row["images"] == 2
        assert all(math.isfinite(row[k]) for k in ("psnr", "si_rmse", "emd"))
    assert result["results"]["eval"] != result["results"]["floor"]
    data = work / "dataset_64_16" / "tfrecord"
    assert len(list(read_tfrecord_examples(str(data / "train")))) == 4
    assert len(list(read_tfrecord_examples(str(data / "test")))) == 2
    assert not (work / "dataset_64_16" / "tfrecord.partial").exists()
    assert quality_run.latest_epoch(str(work / "f32" / "checkpoints" / "SUN")) == 1
    assert quality_run.latest_epoch(str(work / "f32" / "checkpoints" / "SKY")) == 1
    assert "Pretrained SUN checkpoint restored for fine-tuning" in text
    assert not (work / "bf16").exists()  # not in --stages
    for stage in ("floor", "sun", "gan", "eval"):
        assert (work / f"{stage}.log").is_file()


def test_quality_run_skips_finished_stages_and_resumes_cut_ones(run, monkeypatch, capsys):
    work, text = run

    def no_subprocess(*a, **k):
        raise AssertionError("a finished stage ran again")

    monkeypatch.setattr(quality_run, "_run", no_subprocess)
    quality_run.main([*SMALL, "--work", str(work)])
    again = capsys.readouterr().out
    assert _last_json(again)["results"] == _last_json(text)["results"]
    for stage in ("floor", "sun", "gan", "eval"):
        assert f"[quality_run] {stage}: done before" in again
    monkeypatch.undo()

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    longer = [a if a != "floor,sun,gan,eval" else "gan" for a in SMALL]
    longer[longer.index("--gan-epochs") + 1] = "2"
    quality_run.main([*longer, "--work", str(work)])
    out = capsys.readouterr().out
    assert "(from epoch 1)" in out and "Latest SKY checkpoint restored (epoch 1)" in out
    assert quality_run.latest_epoch(str(work / "f32" / "checkpoints" / "SKY")) == 2
    # The kept evaluation read epoch 1's checkpoint: it is not reported for epoch 2's.
    monkeypatch.setattr(quality_run, "_run", no_subprocess)
    with pytest.raises(AssertionError, match="ran again"):
        quality_run.main([*longer[:-1], "eval", "--work", str(work)])


def test_quality_run_evaluates_only_finished_training(tmp_path, monkeypatch):
    monkeypatch.setattr(quality_run, "write_dataset", lambda *a: False)
    with pytest.raises(RuntimeError, match=r"\['sun', 'gan'\] have not reached"):
        quality_run.main([*SMALL[:-1], "eval", "--work", str(tmp_path)])


def test_quality_run_refuses_a_cadence_that_skips_the_last_epoch(tmp_path):
    with pytest.raises(ValueError, match="does not divide"):
        quality_run.main([*SMALL[:-2], "--ckpt-every", "2", "--gan-epochs", "3",
                          "--work", str(tmp_path)])
    assert not any(tmp_path.iterdir())


def test_quality_run_forwards_the_seed_to_every_stage(tmp_path, monkeypatch):
    """`--seed s` reaches every stage's command line (0 by default), so that
    a row's weights, degradations and evaluation draws are `skyhdr`'s for
    that seed; the synthetic set is written with its own seed."""
    cmds = []

    def fake_run(cmd, log_path, echo):
        cmds.append(cmd)
        return '{"psnr": 1.0, "si_rmse": 1.0, "emd": 1.0, "images": 2}'

    def trained(work, stage):
        wd = os.path.join(work, stage.workdir)
        return int(any(c[2] == quality_run._CLI[stage.kind] and wd in c for c in cmds))

    monkeypatch.setattr(quality_run, "write_dataset", lambda *a: False)
    monkeypatch.setattr(quality_run, "_run", fake_run)
    monkeypatch.setattr(quality_run, "_trained", trained)
    monkeypatch.setattr(quality_run, "latest_epoch", lambda d: 1)
    preset = quality_run.PRESETS["plain32"]
    kw = dict(size=(16, 64), n_train=4, n_test=2, epochs={"sun": 1, "gan": 1}, ckpt_every=1,
              flags=["--device", "cpu"])
    quality_run.run_preset(preset, str(tmp_path / "a"), seed=5, **kw)
    assert len(cmds) == len(preset.stages)
    for cmd in cmds:
        assert cmd[cmd.index("--seed") + 1] == "5", cmd
    cmds.clear()
    quality_run.run_preset(preset, str(tmp_path / "b"), **kw)
    assert all(cmd[cmd.index("--seed") + 1] == "0" for cmd in cmds)

    seen = {}
    monkeypatch.setattr(quality_run, "run_preset",
                        lambda *a, **k: (seen.update(k), ({}, {}))[1])
    monkeypatch.setattr(quality_run, "report", lambda *a: None)
    monkeypatch.setattr(quality_run, "health", lambda *a: {"ok": True, "faults": []})
    out = StringIO()
    with redirect_stdout(out):
        quality_run.main(["--preset", "da32", "--seed", "3", "--work", str(tmp_path / "c")])
    assert seen["seed"] == 3 and _last_json(out.getvalue())["seed"] == 3


def test_quality_report_reads_the_port_event_files(run):
    """`tools/quality_report.py` (standard library only) on the port's
    TensorBoard files: every scalar of each stage's epoch line."""
    work, _ = run
    curves = _tool("quality_report").load_workdir(str(work / "f32"))
    assert {("SUN", "train"), ("SUN", "val"), ("SKY", "train"), ("SKY", "val")} <= set(curves)
    for stage, log in (("SUN", "sun.log"), ("SKY", "gan.log")):
        line = next(l for l in (work / log).read_text().splitlines() if l.startswith("Epoch 1:"))
        parts = re.search(r"train=\{(.*)\} test=\{(.*)\}", line).groups()
        for split, part in zip(("train", "val"), parts):
            printed = dict((k, float(v)) for k, v in re.findall(r"(\w+)=([-\d.e+]+)", part))
            assert set(printed) <= set(curves[stage, split])
            for k, v in printed.items():
                assert curves[stage, split][k][1] == pytest.approx(v, rel=5e-4), (stage, k)
    report = (work / "report.md").read_text()
    assert "### SUN / train" in report and "### SKY / val" in report


def test_port_scalar_reader_agrees_with_quality_report(run, da_run):
    """`train.metrics.load_scalars` (the port's reader, which `health`
    uses) against `tools/quality_report.py`'s on the same event files:
    every stage, split, tag, epoch and value."""
    from skyhdr_torch.train.metrics import load_scalars

    tool = _tool("quality_report")
    for wd in (run[0] / "f32", da_run[1] / "da"):
        got, want = load_scalars(str(wd)), tool.load_workdir(str(wd))
        assert got and {k: {t: dict(c) for t, c in v.items()} for k, v in got.items()} == \
            {k: {t: dict(c) for t, c in v.items()} for k, v in want.items()}


# ---------------------------------------------------------------------------
# The DA presets: each driven at 16x64 on the CPU, and held to its script
# ---------------------------------------------------------------------------

def script_settings(script: str) -> dict:
    """What a `tools/quality_run*.sh` sets, read from its text: epochs
    (None where it trains no such stage), batch, checkpoint cadence, the DA
    flag, the size and whether it evaluates an untrained floor. Unset, the
    batch and size are `skyhdr`'s CLI defaults."""
    from skyhdr.config import DataConfig, ModelConfig

    text = (ROOT / script).read_text()

    def default(name):
        m = re.search(rf"{name}=\$\{{{name}:-(\d+)\}}", text)
        return int(m.group(1)) if m else None

    def flag(name, fallback):
        found = set(re.findall(rf"--{name} (\d+)", text))
        assert len(found) <= 1, (script, name, found)
        return int(found.pop()) if found else fallback

    cadence = set(re.findall(r"--ckpt-every (\d+)", text))
    assert len(cadence) == 1, (script, cadence)
    batch = default("BATCH")
    return {"sun_epochs": default("SUN_EPOCHS"), "gan_epochs": default("GAN_EPOCHS"),
            "batch": DataConfig().batch_size if batch is None else batch,
            "ckpt_every": int(cadence.pop()), "da_conv": "--da-conv true" in text,
            "size": (flag("imheight", ModelConfig().im_height),
                     flag("imwidth", ModelConfig().im_width)),
            "floor": bool(re.search(r"evaluate .*--workdir \"\$WORK/(untrained|floor)\"",
                                    text.replace("\\\n", " ")))}


def preset_settings(preset) -> dict:
    """The same settings as `quality_run` runs a preset (the port's CLI
    defaults where its flags set none)."""
    from skyhdr_torch.config import DataConfig

    def last(name, fallback):  # the CLIs' argparse takes a flag's last value
        flags = list(preset.flags)
        return flags[len(flags) - flags[::-1].index(name)] if name in flags else fallback

    trained = {s.workdir for s in preset.stages if s.kind != "eval"}
    kinds = {s.kind for s in preset.stages}
    return {"sun_epochs": preset.sun_epochs if "sun" in kinds else None,
            "gan_epochs": preset.gan_epochs,
            "batch": int(last("--batchsize", DataConfig().batch_size)),
            "ckpt_every": preset.ckpt_every,
            "da_conv": last("--da-conv", "false") == "true",
            "size": preset.size,
            "floor": any(s.kind == "eval" and s.workdir not in trained for s in preset.stages)}


@pytest.mark.parametrize("name", sorted(quality_run.PRESETS))
def test_preset_runs_what_its_script_sets(name):
    preset = quality_run.PRESETS[name]
    assert preset_settings(preset) == script_settings(preset.script)


# A planted edit of each setting the table reads, on each DA preset of one call.
PLANTED = {
    "sun_epochs": lambda p: p._replace(sun_epochs=p.sun_epochs - 1),
    "gan_epochs": lambda p: p._replace(gan_epochs=p.gan_epochs * 2),
    "ckpt_every": lambda p: p._replace(ckpt_every=p.ckpt_every // 2),
    "batch": lambda p: p._replace(flags=(*p.flags, "--batchsize", "16")),
    "da_conv": lambda p: p._replace(flags=tuple(f for f in p.flags
                                                if f not in ("--da-conv", "true"))),
    "floor": lambda p: p._replace(stages=_toggle_floor(p.stages)),
}


def _toggle_floor(stages):
    """The stages without their floor, or with one where they have none."""
    kept = tuple(s for s in stages if s.name != "floor")
    return kept if kept != stages else (quality_run.Stage("floor", "eval", "untrained"),
                                        *stages)


@pytest.mark.parametrize("name", ["da32", "da64"])
@pytest.mark.parametrize("edit", sorted(PLANTED))
def test_planted_preset_edit_fails_the_table(name, edit):
    preset = quality_run.PRESETS[name]
    edited = PLANTED[edit](preset)
    got, want = preset_settings(edited), script_settings(preset.script)
    assert got != want and got[edit] != want[edit]


def _small(name):
    return ["--preset", name, "--device", "cpu", "--imheight", "16", "--imwidth", "64",
            "--n-train", "4", "--n-test", "2", "--batchsize", "2", "--sun-epochs", "1",
            "--gan-epochs", "1", "--ckpt-every", "1"]


@pytest.fixture(scope="module", params=["da32", "da64"])
def da_run(request, tmp_path_factory):
    """A DA preset at 16x64 b2 on the CPU, one epoch a stage, through the
    plain versions: (preset name, work dir, its output)."""
    work = tmp_path_factory.mktemp(f"qrun_{request.param}")
    mp = pytest.MonkeyPatch()
    mp.setenv("OMP_NUM_THREADS", "1")
    out = StringIO()
    with redirect_stdout(out):
        quality_run.main([*_small(request.param), "--work", str(work)])
    mp.undo()
    return request.param, work, out.getvalue()


def test_da_preset_drives_every_stage(da_run):
    name, work, text = da_run
    preset = quality_run.PRESETS[name]
    result = _last_json(text)
    evals = [s.name for s in preset.stages if s.kind == "eval"]
    assert result["preset"] == name and sorted(result["results"]) == sorted(evals)
    for stage in preset.stages:
        log = (work / f"{stage.name}.log").read_text()
        assert "--da-conv true" in log.splitlines()[0], stage.name
        if stage.kind != "eval":
            sec = result["seconds"][stage.name]
            assert sec["epochs"] == [1] and sec["first"] > 0 and len(sec["saves_s"]) == 1
            assert f"Saved {'SUN' if stage.kind == 'sun' else 'SKY'} checkpoint for epoch 1 in" \
                in log
    for row in result["results"].values():
        assert row["images"] == 2
        assert all(math.isfinite(row[k]) for k in ("psnr", "si_rmse", "emd"))
    assert result["results"]["eval"]["checkpoints"] == {"SUN": 1, "SKY": 1}
    assert quality_run.latest_epoch(str(work / "da" / "checkpoints" / "SKY")) == 1
    assert "Pretrained SUN checkpoint restored for fine-tuning" in text
    health = result["health"]
    assert health["ok"], health["faults"]
    assert health["da"]["SKY/train"] == health["da"]["SUN/val"] == 1


def test_stage_seconds_reads_the_epoch_lines():
    text = "\n".join(["tensorboard --logdir=x",
                      "Epoch 1: train={a=1} test={a=2} elapsed=30.5s",
                      "Epoch 2: train={a=1} test={a=2} elapsed=12.0s",
                      "Saved SKY checkpoint for epoch 3 in 4.5s",
                      "Epoch 3: train={a=1} test={a=2} elapsed=16.5s",
                      "Epoch 4: train={a=1} test={a=2} elapsed=13.0s"])
    sec = quality_run.stage_seconds(text, 80.04)
    assert sec == {"wall": 80.0, "epochs": [1, 2, 3, 4], "epoch_s": [30.5, 12.0, 16.5, 13.0],
                   "first": 30.5, "median_later": 13.0, "saves_s": [4.5]}
    assert quality_run.stage_seconds("", 1.0)["median_later"] is None


def _events(wd, stage, split, rows):
    from skyhdr_torch.train.metrics import EventWriter

    writer = EventWriter(str(wd / "tensorboard" / stage / "0" / split))
    for epoch, values in enumerate(rows, 1):
        writer.scalars(values, epoch)
    writer.close()


HEALTHY_GAN = {t: 1.0 for t in quality_run.GAN_TERMS}


@pytest.mark.parametrize("fault", ["none", "nan_term", "missing_term", "inf_term",
                                   "kl_not_falling", "nan_sun"])
def test_health_reports_each_fault(fault, tmp_path):
    """`health` on event files written by the port's EventWriter: healthy
    trajectories pass, each planted fault is named."""
    wd = tmp_path / "da"
    gan = [dict(HEALTHY_GAN), dict(HEALTHY_GAN)]
    kl = [{"kl": 1.0, "dog": 0.1}, {"kl": 0.5, "dog": 0.1}]
    if fault == "nan_term":
        gan[1]["l1"] = math.nan
    elif fault == "missing_term":
        del gan[1]["perceptual"]
    elif fault == "inf_term":
        gan[0]["adv"] = math.inf
    elif fault == "kl_not_falling":
        kl[1]["kl"] = 1.0
    elif fault == "nan_sun":
        kl[0]["dog"] = math.nan
    for split in ("train", "val"):
        _events(wd, "SKY", split, gan)
        _events(wd, "SUN", split, kl)
    checked = quality_run.health(quality_run.PRESETS["da32"], str(tmp_path))
    assert checked["ok"] == (fault == "none"), checked["faults"]
    assert checked["da"]["SUN/val kl"] == [1.0, kl[1]["kl"]]
    words = {"nan_term": "l1", "missing_term": "perceptual", "inf_term": "adv",
             "kl_not_falling": "did not fall", "nan_sun": "dog NaN"}
    if fault != "none":
        assert any(words[fault] in f for f in checked["faults"]), checked["faults"]
