"""A multi-step DA training run of the port held to `skyhdr`'s on the CPU:
8 sun-pretrain steps (Adam), the SUN -> SKY hand-off, then 8 GAN steps
(RMSprop), at 16x64 DA b2 from the harness's weights of
`init_gan_vars(cfg, 0)`, `skyhdr` on its XLA DA path
(`make_torch_golden.JaxTrajectory`). Each step has a batch of its own and
`skyhdr`'s own degraded pair of it, fed to the port through
`step.train_on`, as `tests/test_torch_train.py` does for one step.

Each of the port's steps starts from `skyhdr`'s state before that step
(its export, through `train.convert.state_from_export`): parameters,
BatchNorm statistics, RMSprop's and Adam's moments and Adam's count as 8
steps of training left them. That holds what one or two steps from the
seeded weights cannot show (Adam's bias corrections past the first count,
RMSprop's decay acting on a nonzero moment, the running statistics carried
from step to step, the hand-off) at the train golden's tolerances. Two
free runs cannot be held that close: `skyhdr`'s own run with its weights
times (1 + 2e-7 N(0, 1)) drifts from its unperturbed run by up to 2.6e-4
of a sun metric and 0.149 of a GAN metric by the 8th step of each stage,
and the port's free run by 4.1e-4 and 0.190
(`make_torch_golden.trajectory_spread`, three draws; the GAN's RMSprop
maps a gradient's last bits to updates of either sign).

Tolerances, those of the train golden (`compare_train_golden`), each step:
  - the metrics within 1e-3 (atol 1e-6);
  - per leaf, the sum and the sum of |.| of the step's update within 2e-2
    of `skyhdr`'s sum of |.|; the bias of a conv that feeds an
    InstanceNorm has exactly zero gradient, moves by float noise in both
    packages and is held to the optimizers' bound of 3.17 lr instead
    (`make_torch_golden.in_fed_biases`: by structure, as ROADMAP's
    lessons for goldens ask; the one-step golden's size rule, max |g| at
    most 1e-5 of the tree's, misses `gen/conv1_d/bias` in the first GAN
    step here);
  - the BatchNorm statistics' sums after the step within 1e-4, relative
    to 1e-2 of the leaf's sum of |.| at least; Adam's count equal.

Three planted faults must fail it (`FAULTS`): Adam's count not advanced,
RMSprop's decay changed, the BatchNorm running statistics not updated."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from skyhdr_torch.data.degradation import make_banks
from skyhdr_torch.models import layers
from skyhdr_torch.models.vgg16 import random_vgg16_weights
from skyhdr_torch.train import optim
from skyhdr_torch.train.convert import export_from_state, state_from_export
from skyhdr_torch.train.engine import (make_gan_train_step, make_sun_train_step,
                                       replace_sun_params)
from skyhdr_torch.utils.io import get_exposure_lists, make_synthetic_dorf
from skyhdr_torch.utils.transplant import export_model_vars

# The suite runs in several worker processes that share the CPU; torch's
# default of one thread per core in each of them oversubscribes it.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
METRIC_RTOL, UPDATE_RTOL, STAT_RTOL = 1e-3, 2e-2, 1e-4


def _golden_module():
    spec = importlib.util.spec_from_file_location(
        "make_torch_golden", os.path.join(ROOT, "tools", "make_torch_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


G = _golden_module()
CFG = G.golden_config()
LR = CFG.train.learning_rate
STEPS = G.TRAJ_STEPS


@pytest.fixture(scope="module")
def traj():
    return G.JaxTrajectory(0)


@pytest.fixture(scope="module")
def steps():
    """The port's sun and GAN train steps on the CPU."""
    banks = make_banks(make_synthetic_dorf(175, 1024), get_exposure_lists()[0], device="cpu")
    return {"sun": make_sun_train_step(CFG, banks),
            "gan": make_gan_train_step(CFG, banks, random_vgg16_weights())}


def _params(state):
    return {n: export_model_vars(m, collections=("params",))["params"]
            for n, m in state.modules().items()}


def _sun_params(state):
    return _params(state)["sun"]


def _update_fails(what, got, rec):
    """The step's update digests (paths, [n, 3]) against `skyhdr`'s."""
    paths, got = got
    want_paths, want = rec["digests"]
    assert list(paths) == list(want_paths)
    fails = []
    for path, g, w, is_noise in zip(paths, got, want, G.in_fed_biases(paths)):
        if is_noise:
            if not g[2] <= 3.17 * LR:
                fails.append(f"{what} update {path}: noise leaf moved {g[2]}")
        elif not np.max(np.abs(g[:2] - w[:2])) <= UPDATE_RTOL * w[1]:
            fails.append(f"{what} update {path}: digests {g[:2]} vs {w[:2]}")
    return fails


def port_step(rec, steps):
    """The port's step from `skyhdr`'s state before `rec`'s step, on its
    inputs, held to it: (failures, the port's metrics)."""
    stage = rec["stage"]
    what = f"{stage} step {rec['step']}"
    state = state_from_export(rec["before"], CFG, "cpu")
    reduce = _sun_params if stage == "sun" else _params
    old = reduce(state)
    state, metrics = steps[stage].train_on(state, *(torch.from_numpy(np.array(t))
                                                    for t in rec["inputs"]))
    metrics = {k: float(v) for k, v in metrics.items()}
    want = rec["metrics"]
    assert sorted(metrics) == sorted(want)
    fails = [f"{what} metric {k}: {metrics[k]} vs {want[k]}" for k in sorted(want)
             if not abs(metrics[k] - want[k]) <= METRIC_RTOL * abs(want[k]) + 1e-6]
    fails += _update_fails(what, G.update_digests(reduce(state), old), rec)
    if stage == "sun":
        if state.opt.count != rec["count"]:
            fails.append(f"{what} Adam count {state.opt.count} vs {rec['count']}")
    else:
        stats = {n: export_model_vars(m, collections=("batch_stats",))["batch_stats"]
                 for n, m in (("gen", state.gen), ("disc", state.disc))}
        paths, got = G.stat_digests(stats)
        want_paths, sums = rec["stats"]
        assert list(paths) == list(want_paths)
        scale = np.maximum(np.abs(sums), 1e-2 * rec["stat_abs"])
        fails += [f"{what} batch_stats {p}: {a} vs {b}" for p, a, b, s
                  in zip(paths, got, sums, scale) if not abs(a - b) <= STAT_RTOL * s]
    return fails, metrics


@pytest.fixture(scope="module")
def held(traj, steps):
    """Every step of the trajectory held: {"sun": [(failures, metrics,
    record)], "gan": [...], "handoff": the hand-off's failures}. The
    records keep their metrics, digests and counts, not the states."""
    out, sun_export = {"sun": [], "gan": []}, None
    for rec in traj.run():
        if rec["stage"] == "handoff":
            sun_export = rec["sun"]
            continue
        if sun_export is not None:
            out["handoff"], sun_export = handoff_fails(sun_export, rec), None
        fails, metrics = port_step(rec, steps)
        out[rec["stage"]].append((fails, metrics, {k: rec[k] for k in
                                                   ("step", "metrics", "count") if k in rec}))
    return out


def handoff_fails(sun_export, rec):
    """The port's hand-off (`replace_sun_params` of `skyhdr`'s last SUN
    state into the seeded GAN state) against the state `skyhdr`'s first
    GAN step starts from: every leaf equal."""
    sun = state_from_export(sun_export, CFG, "cpu")
    state = replace_sun_params(CFG, G.harness_gan_state(CFG, 0, "cpu"), sun.sun.state_dict())
    got, want = export_from_state(state)[1], rec["before"][1]
    assert sorted(got) == sorted(want)
    return [f"hand-off {p}" for p in sorted(want)
            if not np.array_equal(np.asarray(got[p]), np.asarray(want[p]))]


def test_sun_steps_match_skyhdr(held):
    assert [r["step"] for _, _, r in held["sun"]] == list(range(1, STEPS + 1))
    assert [r["count"] for _, _, r in held["sun"]] == list(range(1, STEPS + 1))
    assert [f for fails, _, _ in held["sun"] for f in fails] == []
    # A trajectory, not one step repeated: the loss moves.
    assert held["sun"][-1][1]["kl"] != held["sun"][0][1]["kl"]


def test_handoff_matches_skyhdr(held):
    assert held["handoff"] == []


def test_gan_steps_match_skyhdr(held):
    assert [r["step"] for _, _, r in held["gan"]] == list(range(1, STEPS + 1))
    assert [f for fails, _, _ in held["gan"] for f in fails] == []
    assert held["gan"][-1][1]["gen_total"] != held["gan"][0][1]["gen_total"]


def _freeze_adam_count(monkeypatch):
    begin = optim.Adam._begin

    def frozen(self):
        self.count = 0
        begin(self)

    monkeypatch.setattr(optim.Adam, "_begin", frozen)


def _change_rmsprop_decay(monkeypatch):
    monkeypatch.setattr(optim.RMSprop, "_decay_order", lambda self, name: (0.95, 2))


def _freeze_batch_stats(monkeypatch):
    forward = layers.BatchNorm.forward

    def frozen(self, x, train=False):
        kept = self.mean.clone(), self.var.clone()
        y = forward(self, x, train)
        with torch.no_grad():
            self.mean.copy_(kept[0])
            self.var.copy_(kept[1])
        return y

    monkeypatch.setattr(layers.BatchNorm, "forward", frozen)


# fault -> (how to plant it, the stage it shows in, the failure that reports it)
FAULTS = {
    "adam_count_not_advanced": (_freeze_adam_count, "sun", " update "),
    "rmsprop_decay_changed": (_change_rmsprop_decay, "gan", " update "),
    "batch_stats_not_updated": (_freeze_batch_stats, "gan", " batch_stats "),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_fails_the_trajectory(fault, traj, steps, monkeypatch):
    """The port's steps under the fault, up to the first step it fails."""
    plant, stage, reported = FAULTS[fault]
    plant(monkeypatch)
    fails = []
    for rec in traj.run():
        if rec["stage"] == stage:
            fails = port_step(rec, steps)[0]
            if fails:
                break
    assert any(reported in f for f in fails), (fault, fails[:5])
