"""Mean metric accumulators + TensorBoard scalar event writer
(`skyhdr.train.metrics`).

  * MeanMetrics  — the per-epoch running means of each loss term.
  * EventWriter  — a TensorBoard-compatible scalar writer on the port's own
    TFRecord framing (TB event files are TFRecord streams of Event protos);
    no TensorFlow needed, readable by stock TensorBoard.
  * read_scalars / load_scalars — the scalars of such files read back
    (what `tools/quality_report.py` reads, in the port's own code).
"""

from __future__ import annotations

import glob
import os
import socket
import struct
import time
from collections import defaultdict
from typing import Dict

import torch

from skyhdr_torch.data.records import (_frame_record, _len_delim, _read_varint, _tag,
                                       _varint, iter_tfrecord)


class MeanMetrics:
    """Per-key running means, reset per epoch.

    `update` never waits for the device: each value (a 0-d tensor, on the
    card during training, or a number) is added to a float64 running sum
    on its own device. `result` copies the sums to the host once and
    returns the means in key order, as the JAX package's."""

    def __init__(self):
        self._sums: Dict[str, torch.Tensor] = {}
        self._counts: Dict[str, int] = {}

    def update(self, values) -> None:
        for k, v in values.items():
            v = torch.as_tensor(v).detach().to(torch.float64)
            self._sums[k] = self._sums[k] + v if k in self._sums else v
            self._counts[k] = self._counts.get(k, 0) + 1

    def result(self) -> Dict[str, float]:
        if not self._sums:
            return {}
        keys = sorted(self._sums)
        host = torch.stack([self._sums[k].reshape(()) for k in keys]).cpu().tolist()
        return {k: s / self._counts[k] for k, s in zip(keys, host)}

    def reset(self) -> None:
        self._sums.clear()
        self._counts.clear()


def _encode_event(wall_time: float, step: int, tag: str = None,
                  value: float = None, file_version: str = None) -> bytes:
    """Event proto: wall_time(double,1), step(int64,2),
    file_version(string,3) | summary(Summary,5) with
    Summary.value {tag(string,1), simple_value(float,2)}."""
    out = bytearray()
    out += _tag(1, 1) + struct.pack("<d", wall_time)
    if step:
        out += _tag(2, 0) + _varint(step)
    if file_version is not None:
        out += _len_delim(3, file_version.encode())
    if tag is not None:
        sval = _len_delim(1, tag.encode()) + _tag(2, 5) + struct.pack("<f", value)
        summary = _len_delim(1, sval)
        out += _len_delim(5, summary)
    return bytes(out)


class EventWriter:
    """Append-only TensorBoard scalar event file."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        fname = "events.out.tfevents.{:d}.{}.v2".format(
            int(time.time()), socket.gethostname()
        )
        self._path = os.path.join(logdir, fname)
        self._f = open(self._path, "ab")
        self._f.write(_frame_record(
            _encode_event(time.time(), 0, file_version="brain.Event:2")
        ))
        self._f.flush()

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(_frame_record(
            _encode_event(time.time(), step, tag=tag, value=float(value))
        ))

    def scalars(self, values: Dict[str, float], step: int) -> None:
        for k, v in values.items():
            self.scalar(k, v, step)
        self.flush()

    def flush(self) -> None:
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def _fields(buf: bytes):
    """(field, value) over a proto message: an int for a varint, bytes for
    the other wire types (fixed64, length-delimited, fixed32)."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _read_varint(buf, pos)
        elif wire == 2:
            n, pos = _read_varint(buf, pos)
            value, pos = buf[pos:pos + n], pos + n
        elif wire in (1, 5):
            n = 8 if wire == 1 else 4
            value, pos = buf[pos:pos + n], pos + n
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, value


def read_scalars(path: str):
    """[(step, tag, value)] of one event file, in file order."""
    out = []
    for record in iter_tfrecord(path, compression=None):
        step, summary = 0, None
        for field, value in _fields(record):
            if field == 2:
                step = value
            elif field == 5:
                summary = value
        for field, sval in _fields(summary or b""):
            if field == 1:
                parts = dict(_fields(sval))
                if 1 in parts and 2 in parts:
                    out.append((step, parts[1].decode(), struct.unpack("<f", parts[2])[0]))
    return out


def load_scalars(workdir: str):
    """{(stage, split): {tag: {step: value}}} over every event file under
    workdir/tensorboard/<stage>/<run>/<split>/ (a later run's value of a
    step wins, as on a resume)."""
    curves = defaultdict(lambda: defaultdict(dict))
    for path in sorted(glob.glob(os.path.join(workdir, "tensorboard", "*", "*", "*",
                                              "events*"))):
        stage, _, split = path.split(os.sep)[-4:-1]
        for step, tag, value in read_scalars(path):
            curves[stage, split][tag][step] = value
    return curves
