"""TF-free TFRecord + tf.train.Example codec (a copy of
`skyhdr.data.records`, which the port cannot import).

The reference's datasets are GZIP TFRecord files each holding one Example
with features {image: float32 raw bytes, azimuth: float, elevation: float}
(reference DataGeneration/makeTFRecord.py:24-31,58-62; parsed at
train.py:96-117). This module reads and writes that exact format without
TensorFlow: the TFRecord framing (length + masked crc32c) and the protobuf
wire encoding of Example/Features/Feature are implemented directly. The CRC
runs through the native C helper (skyhdr_torch.native) when available.

`tests/test_torch_loop.py` holds the bytes this module writes equal to
those `skyhdr.data.records` writes, and each package's files readable by
the other.
"""

from __future__ import annotations

import glob
import gzip
import os
import struct
from typing import Dict, Iterator, List, Tuple, Union

from skyhdr_torch.native import masked_crc32c

FeatureValue = Union[bytes, float, int, List[float], List[int], List[bytes]]


# ---------------------------------------------------------------------------
# Protobuf wire helpers (just what tf.train.Example needs)
# ---------------------------------------------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _encode_feature(value: FeatureValue) -> bytes:
    """Feature{ bytes_list=1 | float_list=2 | int64_list=3 }."""
    if isinstance(value, bytes):
        value = [value]
    if isinstance(value, (float, int)) and not isinstance(value, bool):
        value = [value]
    if not (isinstance(value, (list, tuple)) and value):
        raise TypeError(f"a feature is bytes, a number or a non-empty list, got {value!r}")
    first = value[0]
    if isinstance(first, bytes):
        inner = b"".join(_len_delim(1, v) for v in value)
        return _len_delim(1, inner)
    if isinstance(first, float):
        packed = struct.pack(f"<{len(value)}f", *value)
        inner = _len_delim(1, packed)  # packed repeated float
        return _len_delim(2, inner)
    if isinstance(first, int):
        inner = b"".join(_tag(1, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF) for v in value)
        return _len_delim(3, inner)
    raise TypeError(type(first))


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
    """Serialize an Example proto (map<string, Feature> under Features)."""
    entries = []
    for name, value in sorted(features.items()):
        entry = _len_delim(1, name.encode()) + _len_delim(2, _encode_feature(value))
        entries.append(_len_delim(1, entry))  # map entry == Features.feature
    features_msg = b"".join(entries)
    return _len_delim(1, features_msg)  # Example.features == field 1


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def decode_example(buf: bytes) -> Dict[str, FeatureValue]:
    """Parse an Example proto to {name: bytes | [float] | [int]}."""
    out: Dict[str, FeatureValue] = {}
    pos = 0
    # Example -> field 1 (Features)
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire != 2:
            raise ValueError(f"not an Example: field {field} has wire type {wire}")
        ln, pos = _read_varint(buf, pos)
        payload = buf[pos:pos + ln]
        pos += ln
        if field == 1:
            _decode_features(payload, out)
    return out


def _decode_features(buf: bytes, out: Dict[str, FeatureValue]) -> None:
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        ln, pos = _read_varint(buf, pos)
        entry = buf[pos:pos + ln]
        pos += ln
        name, feature = _decode_map_entry(entry)
        out[name] = feature


def _decode_map_entry(buf: bytes):
    pos = 0
    name = None
    feature = None
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field = key >> 3
        ln, pos = _read_varint(buf, pos)
        payload = buf[pos:pos + ln]
        pos += ln
        if field == 1:
            name = payload.decode()
        else:
            feature = _decode_feature(payload)
    return name, feature


def _decode_feature(buf: bytes):
    pos = 0
    key, pos = _read_varint(buf, pos)
    kind = key >> 3
    ln, pos = _read_varint(buf, pos)
    inner = buf[pos:pos + ln]
    if kind == 1:  # bytes_list
        values = []
        p = 0
        while p < len(inner):
            _, p = _read_varint(inner, p)
            n, p = _read_varint(inner, p)
            values.append(inner[p:p + n])
            p += n
        return values[0] if len(values) == 1 else values
    if kind == 2:  # float_list (packed or unpacked)
        values: List[float] = []
        p = 0
        while p < len(inner):
            tag, p = _read_varint(inner, p)
            if tag & 7 == 2:  # packed
                n, p = _read_varint(inner, p)
                values.extend(struct.unpack(f"<{n // 4}f", inner[p:p + n]))
                p += n
            else:  # single fixed32
                values.append(struct.unpack("<f", inner[p:p + 4])[0])
                p += 4
        return values
    if kind == 3:  # int64_list
        values = []
        p = 0
        while p < len(inner):
            _, p = _read_varint(inner, p)
            v, p = _read_varint(inner, p)
            values.append(v)
        return values
    raise ValueError(f"unknown Feature kind {kind}")


# ---------------------------------------------------------------------------
# TFRecord framing
# ---------------------------------------------------------------------------

def _frame_record(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (header
            + struct.pack("<I", masked_crc32c(header))
            + data
            + struct.pack("<I", masked_crc32c(data)))


def write_tfrecord(path: str, examples, compression: str = "GZIP") -> None:
    """Write serialized examples (bytes or feature dicts) to one file."""
    payload = bytearray()
    for ex in examples:
        if isinstance(ex, dict):
            ex = encode_example(ex)
        payload += _frame_record(ex)
    data = bytes(payload)
    if compression == "GZIP":
        with gzip.open(path, "wb") as f:
            f.write(data)
    else:
        with open(path, "wb") as f:
            f.write(data)


def iter_tfrecord(path: str, compression: str = "GZIP",
                  verify_crc: bool = False) -> Iterator[bytes]:
    """Yield raw serialized records from one TFRecord file."""
    opener = gzip.open if compression == "GZIP" else open
    with opener(path, "rb") as f:
        data = f.read()
    pos = 0
    n = len(data)
    while pos + 12 <= n:
        (length,) = struct.unpack_from("<Q", data, pos)
        if verify_crc:
            (hcrc,) = struct.unpack_from("<I", data, pos + 8)
            if hcrc != masked_crc32c(data[pos:pos + 8]):
                raise ValueError(f"{path}: header crc mismatch at byte {pos}")
        start = pos + 12
        record = data[start:start + length]
        if verify_crc:
            (dcrc,) = struct.unpack_from("<I", data, start + length)
            if dcrc != masked_crc32c(record):
                raise ValueError(f"{path}: data crc mismatch at byte {start}")
        yield record
        pos = start + length + 4


def read_tfrecord_examples(path_or_dir: str, compression: str = "GZIP",
                           verify_crc: bool = False) -> Iterator[Dict[str, FeatureValue]]:
    """Yield decoded Examples from a file, glob, or directory of
    .tfrecord files (reference configureDataset globs '*.tfrecord',
    train.py:122)."""
    if os.path.isdir(path_or_dir):
        paths = sorted(glob.glob(os.path.join(path_or_dir, "*.tfrecord")))
    elif any(ch in path_or_dir for ch in "*?["):
        paths = sorted(glob.glob(path_or_dir))
    else:
        paths = [path_or_dir]
    for p in paths:
        for record in iter_tfrecord(p, compression, verify_crc):
            yield decode_example(record)
