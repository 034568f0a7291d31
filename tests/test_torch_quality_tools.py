"""The quality-run tools of the port on the CPU: its synthetic-sky writer
against `tools/make_synth_dataset.py`, `skyhdr_torch.tools.quality_run`'s
stages at 16x64 (the dataset, the untrained floor, SUN, the GAN and the
evaluation, each a subprocess), its skips and resumes, and
`tools/quality_report.py` reading the port's event files."""

import gzip
import importlib.util
import json
import math
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
