"""The quality runs of `skyhdr` (`tools/quality_run{,_da,_da64,_da64_lowp,
_da64_ablate}.sh`) through the port: the synthetic sky set, sun-pose
pretraining, the GAN stage(s) and PSNR / si-RMSE / EMD on the held-out
split, beside the untrained floor.

Each `--preset` runs its script's stages, each in a subprocess, with the
script's flags and epochs, and `--seed` (default 0, the scripts' seed)
handed to every stage: the SUN and GAN stages' initial weights and
degradations and each evaluation's draws are `skyhdr`'s for that seed. The
synthetic set is the scripts' (`make_synth_dataset`'s own seed, 0) for
every `--seed`:

  python -m skyhdr_torch.tools.make_synth_dataset   the set, if absent
  python -m skyhdr_torch.cli.train_sun              SUN pretrain
  python -m skyhdr_torch.cli.train                  the GAN stage(s)
  python -m skyhdr_torch.cli.evaluate               the floor and each row

A training stage whose newest checkpoint already reaches its epoch count
is skipped, and a stage cut short resumes from its newest checkpoint (the
CLIs restore it; the draws of the resumed epochs are seeded anew). An
evaluation runs once the training stages of its workdir are done, and is
skipped when its result file names the same checkpoints (`checkpoints`:
the newest SKY / SUN epoch it read). `--ckpt-every` must
divide every stage's epochs, so that a finished stage ends on a
checkpoint. Every stage's output goes to `<work>/<stage>.log`; its epoch
lines and results are printed, and after each training stage its seconds:
the stage's wall time, the first epoch's, the median of the others' and
the checkpoint saves' (host clock; an epoch line's `elapsed` holds its
save). Then `tools/quality_report.py` (standard library only, run as a
command) tabulates each workdir's loss trajectories from its TensorBoard
event files into `<work>/report.md`, and `health` reads the same files
(`train.metrics.load_scalars`): every GAN loss term finite in every
epoch, no metric NaN, the SUN val KL lower at the end than at the start.
The last line printed is one JSON object of the evaluations, the stages'
seconds and the health check.

Usage:
  python -m skyhdr_torch.tools.quality_run --preset plain32            # the card
  python -m skyhdr_torch.tools.quality_run --preset plain32 --device cpu \\
      --imheight 16 --imwidth 64 --n-train 4 --n-test 2 --batchsize 2 \\
      --sun-epochs 1 --gan-epochs 1 --ckpt-every 1 --work run/
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple, Optional, Tuple

from skyhdr_torch.train.metrics import load_scalars

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class Stage(NamedTuple):
    name: str
    kind: str                 # "sun" | "gan" | "eval"
    workdir: str              # under <work>
    flags: Tuple[str, ...] = ()
    sun_from: Optional[str] = None   # a workdir whose SUN checkpoint the GAN stage takes


class Preset(NamedTuple):
    script: str
    work: str                 # default <work> under the temporary directory
    size: Tuple[int, int]     # (imheight, imwidth)
    flags: Tuple[str, ...]
    sun_epochs: int
    gan_epochs: int
    ckpt_every: int
    stages: Tuple[Stage, ...]


_DA64 = ("--batchsize", "8", "--da-conv", "true")
_BF16_STATE = ("--opt-state-dtype", "bfloat16", "--grad-dtype", "bfloat16")

PRESETS = {
    # 32x128 plain convs (`Config()` defaults): f32 and bf16 GAN stages from one SUN.
    "plain32": Preset("tools/quality_run.sh", "qrun", (32, 128), (), 120, 200, 20, (
        Stage("floor", "eval", "untrained"),
        Stage("sun", "sun", "f32"),
        Stage("gan", "gan", "f32"),
        Stage("gan_bf16", "gan", "bf16", ("--compute-dtype", "bfloat16"), sun_from="f32"),
        Stage("eval", "eval", "f32"),
        Stage("eval_bf16", "eval", "bf16"),
    )),
    "da32": Preset("tools/quality_run_da.sh", "qrun_da", (32, 128), ("--da-conv", "true"),
                   120, 200, 20, (
        Stage("sun", "sun", "da"),
        Stage("gan", "gan", "da"),
        Stage("eval", "eval", "da"),
    )),
    "da64": Preset("tools/quality_run_da64.sh", "qrun_da64", (64, 256), _DA64, 60, 60, 20, (
        Stage("floor", "eval", "floor"),
        Stage("sun", "sun", "da"),
        Stage("gan", "gan", "da"),
        Stage("eval", "eval", "da"),
    )),
    # The GAN stage from da64's SUN checkpoint under bf16 moments and gradients.
    "da64_lowp": Preset("tools/quality_run_da64_lowp.sh", "qrun_da64", (64, 256), _DA64,
                        60, 60, 20, (
        Stage("gan_lowp", "gan", "da_lowp", _BF16_STATE, sun_from="da"),
        Stage("eval_lowp", "eval", "da_lowp"),
    )),
    # One knob at a time from one SUN checkpoint.
    "da64_ablate": Preset("tools/quality_run_da64_ablate.sh", "qrun_da64", (64, 256), _DA64,
                          60, 60, 60, (
        Stage("sun", "sun", "da"),
        Stage("gan_f32", "gan", "da_f32", sun_from="da"),
        Stage("eval_f32", "eval", "da_f32"),
        Stage("gan_opt", "gan", "da_opt", _BF16_STATE[:2], sun_from="da"),
        Stage("eval_opt", "eval", "da_opt"),
        Stage("gan_grad", "gan", "da_grad", _BF16_STATE[2:], sun_from="da"),
        Stage("eval_grad", "eval", "da_grad"),
    )),
}

_CLI = {"sun": "skyhdr_torch.cli.train_sun", "gan": "skyhdr_torch.cli.train",
        "eval": "skyhdr_torch.cli.evaluate"}
_CKPT = {"sun": "SUN", "gan": "SKY"}


def latest_epoch(ckpt_dir: str) -> int:
    """The newest saved epoch under a CheckpointManager directory (0: none)."""
    if not os.path.isdir(ckpt_dir):
        return 0
    steps = [int(n) for n in os.listdir(ckpt_dir) if n.isdigit()
             and os.path.isfile(os.path.join(ckpt_dir, n, "state.pt"))]
    return max(steps, default=0)


def _trained(work: str, stage: Stage) -> int:
    """The epochs a training stage's checkpoints reach."""
    return latest_epoch(os.path.join(work, stage.workdir, "checkpoints", _CKPT[stage.kind]))


def _run(cmd, log_path: str, echo) -> str:
    """Run `cmd` from the repository root with its output in `log_path`;
    the lines `echo` selects are printed. Raises on a non-zero exit, with
    the log's tail."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (ROOT, os.environ.get("PYTHONPATH")) if p))
    with open(log_path, "a") as log:
        log.write(f"$ {' '.join(cmd)}\n")
        log.flush()
        proc = subprocess.run(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        log.write(proc.stdout)
    for line in proc.stdout.splitlines():
        if echo(line):
            print(f"  {line}", flush=True)
    if proc.returncode:
        tail = "\n".join(proc.stdout.splitlines()[-30:])
        raise RuntimeError(f"{' '.join(cmd[2:4])} exited with {proc.returncode}; "
                           f"the end of {log_path}:\n{tail}")
    return proc.stdout


def _epoch_line(line: str) -> bool:
    return line.startswith(("Epoch ", "Latest ", "Pretrained ", "Saved ")) or "Error" in line


_ELAPSED = re.compile(r"^Epoch (\d+): .* elapsed=([\d.]+)s$", re.M)
_SAVED = re.compile(r"^Saved \w+ checkpoint for epoch \d+ in ([\d.]+)s$", re.M)


def stage_seconds(text: str, wall: float) -> dict:
    """A training stage's seconds from its CLI's output: its wall time, its
    epochs' `elapsed` (each holding that epoch's checkpoint save), the
    first epoch's, the median of the later ones' and the saves'."""
    epochs = [(int(e), float(t)) for e, t in _ELAPSED.findall(text)]
    later = [t for _, t in epochs[1:]]
    return {"wall": round(wall, 1), "epochs": [e for e, _ in epochs],
            "epoch_s": [t for _, t in epochs],
            "first": epochs[0][1] if epochs else None,
            "median_later": statistics.median(later) if later else None,
            "saves_s": [float(t) for t in _SAVED.findall(text)]}


# The GAN step's metrics (`train/engine.py:make_gan_train_step`), each an
# epoch's train and val scalar.
GAN_TERMS = ("adv", "b_out", "disc_generated", "disc_real", "disc_total", "dog",
             "g_out", "gen_total", "kl", "l1", "perceptual")


def write_dataset(data: str, size, n_train: int, n_test: int, log_path: str) -> bool:
    """The synthetic set at `data`, written to a sibling directory and
    renamed into place (a cut write leaves no half set); False if present."""
    if os.path.isdir(os.path.join(data, "train")):
        return False
    tmp = data + ".partial"
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    _run([sys.executable, "-m", "skyhdr_torch.tools.make_synth_dataset", "--out", tmp,
          "--n-train", str(n_train), "--n-test", str(n_test),
          "--imheight", str(size[0]), "--imwidth", str(size[1])], log_path, lambda l: True)
    os.makedirs(os.path.dirname(data) or ".", exist_ok=True)
    os.rename(tmp, data)
    return True


def run_preset(preset: Preset, work: str, *, size, n_train: int, n_test: int,
               epochs, ckpt_every: int, flags, stages=None, seed: int = 0) -> Tuple[dict, dict]:
    """Every stage of `preset` (or those named in `stages`), in order,
    each with `--seed seed`; returns ({stage: the evaluate CLI's JSON} of
    the evaluations, {stage: `stage_seconds`} of the training stages run,
    with "dataset")."""
    for stage in preset.stages:
        n = epochs.get(stage.kind)
        if n is not None and n % ckpt_every:
            raise ValueError(f"--ckpt-every {ckpt_every} does not divide stage "
                             f"{stage.name}'s {n} epochs")
    os.makedirs(work, exist_ok=True)
    data = os.path.join(work, f"dataset_{size[1]}_{size[0]}", "tfrecord")
    seconds = {}
    t0 = time.perf_counter()
    if write_dataset(data, size, n_train, n_test, os.path.join(work, "dataset.log")):
        seconds["dataset"] = round(time.perf_counter() - t0, 1)
        print(f"[quality_run] dataset written in {seconds['dataset']:.1f} s: {data}",
              flush=True)
    common = [*flags, "--imheight", str(size[0]), "--imwidth", str(size[1]),
              "--seed", str(seed)]
    results = {}
    for stage in preset.stages:
        if stages is not None and stage.name not in stages:
            continue
        wd = os.path.join(work, stage.workdir)
        log = os.path.join(work, f"{stage.name}.log")
        cmd = [sys.executable, "-m", _CLI[stage.kind], *common, "--workdir", wd,
               *stage.flags]
        resume = ""
        if stage.kind == "eval":
            trained = [t for t in preset.stages if t.kind != "eval" and t.workdir == stage.workdir]
            short = [t.name for t in trained if _trained(work, t) < epochs[t.kind]]
            if short:
                raise RuntimeError(f"stage {stage.name} evaluates {wd}, whose stages {short} "
                                   "have not reached their epochs")
            ckpts = {_CKPT[t.kind]: _trained(work, t) for t in trained}
            out = os.path.join(work, f"{stage.name}.eval.json")
            if os.path.isfile(out):
                with open(out) as f:
                    kept = json.load(f)
                if kept.get("checkpoints") == ckpts:
                    results[stage.name] = kept
                    print(f"[quality_run] {stage.name}: done before, {kept}", flush=True)
                    continue
            cmd += ["--dir", os.path.join(data, "test")]
        else:
            n = epochs[stage.kind]
            done = _trained(work, stage)
            if done >= n:
                print(f"[quality_run] {stage.name}: done before ({done} of {n} epochs)",
                      flush=True)
                continue
            cmd += ["--dir", data, "--epochs", str(n), "--ckpt-every", str(ckpt_every)]
            resume = f" (from epoch {done})" if done else ""
            if stage.kind == "sun":
                cmd += ["--train", "true", "--outputimg-every", "0"]
            if stage.sun_from is not None:
                sun = os.path.join(work, stage.sun_from, "checkpoints", "SUN")
                if latest_epoch(sun) < epochs["sun"]:
                    raise RuntimeError(f"stage {stage.name} needs the SUN checkpoint of "
                                       f"{epochs['sun']} epochs under {sun}")
                cmd += ["--sun", sun]
        print(f"[quality_run] {stage.name}: {' '.join(cmd[2:])}{resume}", flush=True)
        t = time.perf_counter()
        text = _run(cmd, log, _epoch_line)
        if stage.kind == "eval":
            results[stage.name] = dict(json.loads(text.strip().splitlines()[-1]),
                                       checkpoints=ckpts)
            with open(out, "w") as f:
                json.dump(results[stage.name], f)
            print(f"  {results[stage.name]}", flush=True)
        wall = time.perf_counter() - t
        print(f"[quality_run] {stage.name}: {wall:.1f} s", flush=True)
        if stage.kind == "eval":
            seconds[stage.name] = round(wall, 1)
        else:
            sec = seconds[stage.name] = stage_seconds(text, wall)
            print(f"[quality_run] {stage.name}: {len(sec['epochs'])} epochs, first "
                  f"{sec['first']} s, median of the later {sec['median_later']} s, "
                  f"saves {sum(sec['saves_s']):.1f} s", flush=True)
    return results, seconds


def _training_workdirs(preset: Preset, work: str):
    return sorted({os.path.join(work, s.workdir) for s in preset.stages if s.kind != "eval"})


def health(preset: Preset, work: str) -> dict:
    """The loss trajectories' health in each training workdir, from its
    TensorBoard files: {"ok", "faults": [...], workdir: {SUN / SKY epochs
    and the SUN val KL's first and last}}. A fault is a GAN term missing
    or not finite in an epoch's train or val scalars, any metric NaN, or a
    SUN val KL whose last epoch is not below its first (of two or more)."""
    faults, rows = [], {}
    for wd in _training_workdirs(preset, work):
        curves = load_scalars(wd)
        row = rows[os.path.basename(wd)] = {}
        for (stage, split), tags in sorted(curves.items()):
            steps = sorted({s for c in tags.values() for s in c})
            row[f"{stage}/{split}"] = len(steps)
            for tag, curve in tags.items():
                bad = [s for s, v in curve.items() if math.isnan(v)]
                if bad:
                    faults.append(f"{wd} {stage}/{split} {tag} NaN at epochs {bad[:5]}")
            if stage == "SKY":
                for tag in GAN_TERMS:
                    curve = tags.get(tag, {})
                    bad = [s for s in steps if not math.isfinite(curve.get(s, math.nan))]
                    if bad:
                        faults.append(f"{wd} SKY/{split} {tag} missing or not finite at "
                                      f"epochs {bad[:5]}")
        kl = curves.get(("SUN", "val"), {}).get("kl")
        if kl:
            first, last = kl[min(kl)], kl[max(kl)]
            row["SUN/val kl"] = [first, last]
            if len(kl) > 1 and not last < first:
                faults.append(f"{wd} SUN/val kl did not fall: {first} -> {last}")
    return {"ok": not faults, "faults": faults, **rows}


def report(preset: Preset, work: str) -> Optional[str]:
    """`tools/quality_report.py` over the preset's training workdirs, into
    <work>/report.md; None where the repository's tools/ is absent."""
    tool = os.path.join(ROOT, "tools", "quality_report.py")
    if not os.path.isfile(tool):
        return None
    wds = [wd for wd in _training_workdirs(preset, work)
           if os.path.isdir(os.path.join(wd, "tensorboard"))]
    text = subprocess.run([sys.executable, tool, *wds], check=True, capture_output=True,
                          text=True).stdout
    path = os.path.join(work, "report.md")
    with open(path, "w") as f:
        f.write(text)
    return path


def main(argv=None):
    ap = argparse.ArgumentParser(description="a quality run of the port (see module doc)")
    ap.add_argument("--preset", required=True, choices=sorted(PRESETS))
    ap.add_argument("--work", default=None,
                    help="run directory (default: <tmp>/qrun, qrun_da or qrun_da64, "
                         "as the scripts)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--stages", default=None,
                    help="comma-separated stages to run (default: all of the preset's)")
    ap.add_argument("--imheight", type=int, default=None)
    ap.add_argument("--imwidth", type=int, default=None)
    ap.add_argument("--batchsize", type=int, default=None)
    ap.add_argument("--n-train", type=int, default=2048)
    ap.add_argument("--n-test", type=int, default=256)
    ap.add_argument("--sun-epochs", type=int, default=None)
    ap.add_argument("--gan-epochs", type=int, default=None)
    ap.add_argument("--ckpt-every", type=int, default=None,
                    help="checkpoint cadence in epochs (default: the script's)")
    ap.add_argument("--seed", type=int, default=0,
                    help="every stage's --seed (weights and degradations)")
    args = ap.parse_args(argv)

    preset = PRESETS[args.preset]
    work = args.work or os.path.join(tempfile.gettempdir(), preset.work)
    size = (args.imheight or preset.size[0], args.imwidth or preset.size[1])
    flags = [*preset.flags, "--device", args.device]
    if args.batchsize is not None:
        flags += ["--batchsize", str(args.batchsize)]
    stages = None
    if args.stages:
        stages = set(args.stages.split(","))
        unknown = stages - {s.name for s in preset.stages}
        if unknown:
            ap.error(f"unknown stages {sorted(unknown)} of preset {args.preset}")
    epochs = {"sun": args.sun_epochs or preset.sun_epochs,
              "gan": args.gan_epochs or preset.gan_epochs}
    print(f"[quality_run] preset {args.preset} ({preset.script}) in {work}: {size[0]}x"
          f"{size[1]}, {args.n_train}/{args.n_test} panoramas, {epochs['sun']} SUN + "
          f"{epochs['gan']} GAN epochs, seed {args.seed}, flags {' '.join(flags)}", flush=True)
    results, seconds = run_preset(
        preset, work, size=size, n_train=args.n_train, n_test=args.n_test, epochs=epochs,
        ckpt_every=args.ckpt_every or preset.ckpt_every, flags=flags, stages=stages,
        seed=args.seed)
    path = report(preset, work)
    if path is not None:
        print(f"[quality_run] loss trajectories: {path}", flush=True)
    checked = health(preset, work)
    print(f"[quality_run] health: {'ok' if checked['ok'] else 'FAULTS'} "
          f"{checked['faults']}", flush=True)
    print(json.dumps({"preset": args.preset, "seed": args.seed, "work": work,
                      "results": results, "seconds": seconds, "health": checked}))


if __name__ == "__main__":
    main()
