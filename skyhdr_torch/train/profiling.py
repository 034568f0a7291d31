"""Tracing and step timing (`skyhdr.train.profiling`).

  * trace(logdir)  — context manager around `torch.profiler`: host and,
    with a card, device activity of the wrapped steps, written to `logdir`
    as a trace TensorBoard's profiler plugin (and Perfetto) opens.
  * StepTimer      — per-step wall-clock stats, synchronising the device
    of the given output before each stop.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


def _sync(out) -> None:
    """Wait for the device work behind every tensor in `out` (a tensor or a
    nest of dicts, lists and tuples of them)."""
    if isinstance(out, torch.Tensor):
        if out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _sync(v)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _sync(v)


class StepTimer:
    """Accumulates per-step durations (waiting for the given output)."""

    def __init__(self):
        self._durations: List[float] = []
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, sync=None):
        if sync is not None:
            _sync(sync)
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() without start()")
        self._durations.append(time.perf_counter() - self._t0)
        self._t0 = None

    def stats(self) -> Dict[str, float]:
        if not self._durations:
            return {}
        d = sorted(self._durations)
        n = len(d)
        return {
            "steps": n,
            "mean_ms": 1e3 * sum(d) / n,
            "p50_ms": 1e3 * d[n // 2],
            "p90_ms": 1e3 * d[int(n * 0.9)],
            "min_ms": 1e3 * d[0],
            "max_ms": 1e3 * d[-1],
        }

    def reset(self):
        self._durations.clear()
