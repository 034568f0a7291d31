"""8-bit PNG codec from the standard library (`zlib`, `struct`) and NumPy.

Reading takes non-interlaced 8-bit grey, grey+alpha, RGB and RGBA images
(all five row filters); writing emits 8-bit RGB with filter 0. It lets the
inference CLI read panoramas where neither OpenCV nor Pillow is installed.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # colour type -> samples per pixel


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + length]
        pos += 12 + length


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    stride = w * bpp
    buf = np.frombuffer(raw, np.uint8)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ft = int(buf[y * (stride + 1)])
        line = buf[y * (stride + 1) + 1:(y + 1) * (stride + 1)]
        if ft == 0:
            row = line.copy()
        elif ft == 1:  # Sub: running sum over pixels, per channel, mod 256
            row = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint8).ravel()
        elif ft == 2:  # Up
            row = line + prev
        elif ft in (3, 4):  # Average, Paeth: sequential along the row
            row = line.astype(np.int64)
            up = prev.astype(np.int64)
            for i in range(stride):
                left = int(row[i - bpp]) if i >= bpp else 0
                if ft == 3:
                    row[i] = (row[i] + (left + int(up[i])) // 2) & 0xFF
                else:
                    ul = int(up[i - bpp]) if i >= bpp else 0
                    row[i] = (row[i] + _paeth(left, int(up[i]), ul)) & 0xFF
            row = row.astype(np.uint8)
        else:
            raise ValueError(f"PNG: unknown row filter {ft}")
        out[y] = row
        prev = out[y]
    return out.reshape(h, w, bpp)


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit PNG to a uint8 array [h, w, samples]."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: only non-interlaced 8-bit grey/RGB(A) PNG "
                         f"is supported (depth {depth}, colour type {ctype}, "
                         f"interlace {interlace})")
    return _unfilter(zlib.decompress(b"".join(idat)), h, w, _CHANNELS[ctype])


def write_png(path: str, rgb: np.ndarray) -> None:
    """Encode a uint8 RGB array [h, w, 3] as an 8-bit PNG (filter 0)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"write_png takes [h, w, 3], got {rgb.shape}")
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)],
                         axis=1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
