"""The port's counterparts of `skyhdr`'s tools, each run as `python -m
skyhdr_torch.tools.<name> [flags]`.

The DA-conv probe tools on the card: `exp_daconv` (the k=3 DA forward in
design variants, K10), `exp_pack` (sample packing, K11) and `exp_mmshape`
(what a dot of a given shape costs inside a kernel, K12); on the card by
default (`--device cuda`) and on the CPU with `--device cpu` (the kernels'
plain versions; host-clock times, not device times). The helpers below
serve them.

The quality tools: `make_synth_dataset` (the synthetic sky set) and
`quality_run` (`skyhdr`'s tools/quality_run*.sh as presets)."""

from __future__ import annotations

import statistics
import time

import torch


def device_of(name: str) -> torch.device:
    """The tool's device; `cuda` without a card raises (no fallback)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device available (pass --device cpu for the plain versions)")
    return dev


def describe(dev: torch.device) -> str:
    """The header line of a tool's output: what ran and how it was timed."""
    if dev.type == "cuda":
        return (f"# device: {torch.cuda.get_device_name(dev)}; times: CUDA events, "
                f"median over distinct inputs after a warm-up")
    return "# device: cpu (plain versions); times: host clock, not device times"


def time_inputs(fn, inputs) -> float:
    """Median seconds of fn(x) over the distinct inputs, after one warm-up
    call: CUDA events around each call on the card, the host clock on the
    CPU."""
    fn(inputs[0])
    if inputs[0].is_cuda:
        pairs = []
        for x in inputs:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn(x)
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return statistics.median(a.elapsed_time(b) for a, b in pairs) / 1e3
    times = []
    for x in inputs:
        t0 = time.perf_counter()
        fn(x)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)
