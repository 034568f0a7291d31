"""Every `skyhdr` CLI's command line parses through its port counterpart to
the same values, and what the port does not run raises NotImplementedError
(a storage-dtype knob other than float32, more than one step per
dispatch), not an argparse exit. Also `StepTimer`'s stats keys."""

import argparse
import importlib

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


@pytest.mark.parametrize("knob", ["--opt-state-dtype", "--grad-dtype", "--param-dtype"])
@pytest.mark.parametrize("cli", ["inference", "train", "train_sun", "evaluate"])
def test_bf16_knob_raises(cli, knob, tmp_path):
    with pytest.raises(NotImplementedError, match="only float32"):
        _main(cli)(["--indir", str(tmp_path)] * (cli == "inference")
                   + ["--device", "cpu", knob, "bfloat16"])


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
