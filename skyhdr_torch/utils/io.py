"""Host I/O in NumPy, copied from `skyhdr.utils.io` so the port runs
without the JAX package: the exposure sweep and the DoRF camera-response
curves (`get_exposure_lists`, `load_dorf_curves`, `make_synthetic_dorf`,
`inverse_rf`) and the Radiance .hdr (RGBE) codec (`write_hdr`, `read_hdr`).
`tests/test_torch_slice.py` and `tests/test_torch_train_ops.py` hold the
copies equal to the originals."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def get_exposure_lists(n_train: int = 600, n_test: int = 7) -> Tuple[np.ndarray, np.ndarray]:
    """Exposure multipliers 2^linspace(-3, 3, n) for training and test."""
    make = lambda n: (2.0 ** np.linspace(-3, 3, n)).astype(np.float32)
    return make(n_train), make(n_test)


def load_dorf_curves(path: str, n_train: int = 175) -> Tuple[np.ndarray, np.ndarray]:
    """Parse dorfCurves.txt into (train_crfs, test_crfs), each [n, 1024]:
    records of 6 lines, the 6th holding the 1024 response samples."""
    with open(path, "r") as f:
        lines = [line.strip() for line in f.readlines()]
    rows = [lines[idx + 5] for idx in range(0, len(lines) - 5, 6)]
    crf = np.asarray([np.array(r.split(), dtype=np.float64) for r in rows], np.float32)
    return crf[:n_train], crf[n_train:]


def make_synthetic_dorf(n_curves: int = 201, k: int = 1024, seed: int = 0) -> np.ndarray:
    """Deterministic family of monotone CRFs (gamma + smoothstep mixtures)
    for runs without dorfCurves.txt."""
    rng = np.random.default_rng(seed)
    x = np.linspace(0.0, 1.0, k, dtype=np.float64)
    curves = []
    for _ in range(n_curves):
        g = rng.uniform(0.35, 2.8)
        a = rng.uniform(0.0, 1.0)
        s = x * x * (3 - 2 * x)
        c = (1 - a) * np.power(x, g) + a * s
        curves.append((c - c[0]) / (c[-1] - c[0]))
    return np.asarray(curves, np.float32)


def inverse_rf(rf: np.ndarray) -> np.ndarray:
    """The inverse of a monotone CRF sampled on linspace(0, 1), sampled on
    the same grid (linear interpolation)."""
    grid = np.linspace(0.0, 1.0, len(rf))
    return np.interp(grid, rf, grid).astype(np.float32)


def write_hdr(path: str, img: np.ndarray) -> None:
    """Write a float32 RGB image as Radiance .hdr with RLE scanlines."""
    img = np.asarray(img, np.float32)
    assert img.ndim == 3 and img.shape[2] == 3, img.shape
    h, w = img.shape[:2]

    rgbe = _float_to_rgbe(img)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\n")
        f.write(b"FORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        if w < 8 or w > 32767:
            f.write(rgbe.tobytes())
            return
        for y in range(h):
            f.write(bytes([2, 2, (w >> 8) & 0xFF, w & 0xFF]))
            for ch in range(4):
                f.write(_rle_encode(rgbe[y, :, ch]))


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr file to float32 RGB [h, w, 3]."""
    with open(path, "rb") as f:
        data = f.read()
    # Header ends at the first blank line; next line is the resolution.
    pos = 0
    if not data.startswith(b"#?"):
        raise ValueError("not a Radiance file")
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
    eol = data.index(b"\n", pos)
    res = data[pos:eol].decode().split()
    pos = eol + 1
    assert res[0] == "-Y" and res[2] == "+X", res
    h, w = int(res[1]), int(res[3])

    buf = np.frombuffer(data, np.uint8, offset=pos)
    rgbe = _decode_scanlines(buf, h, w)
    return _rgbe_to_float(rgbe)


def _float_to_rgbe(img: np.ndarray) -> np.ndarray:
    maxc = img.max(axis=2)
    rgbe = np.zeros((*img.shape[:2], 4), np.uint8)
    mask = maxc >= 1e-32
    # frexp: maxc = m * 2^e with m in [0.5, 1).
    m, e = np.frexp(np.where(mask, maxc, 1.0))
    scale = m * 256.0 / np.where(mask, maxc, 1.0)
    # Round to the nearest mantissa bucket (halves the truncation error of
    # the classic encoder).
    rgbe[..., 0] = np.where(mask, np.clip(img[..., 0] * scale + 0.5, 0, 255), 0).astype(np.uint8)
    rgbe[..., 1] = np.where(mask, np.clip(img[..., 1] * scale + 0.5, 0, 255), 0).astype(np.uint8)
    rgbe[..., 2] = np.where(mask, np.clip(img[..., 2] * scale + 0.5, 0, 255), 0).astype(np.uint8)
    rgbe[..., 3] = np.where(mask, e + 128, 0).astype(np.uint8)
    return rgbe


def _rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e == 0, 0.0, np.ldexp(1.0, e - 136))
    return (rgbe[..., :3].astype(np.float32) * scale[..., None]).astype(np.float32)


def _rle_encode(row: np.ndarray) -> bytes:
    """Adaptive RLE for one channel of one scanline (Radiance new format)."""
    out = bytearray()
    n = len(row)
    i = 0
    while i < n:
        # Find a run of >= 4 equal bytes.
        run_start = i
        while run_start < n:
            run_len = 1
            while (run_start + run_len < n and run_len < 127
                   and row[run_start + run_len] == row[run_start]):
                run_len += 1
            if run_len >= 4:
                break
            run_start += 1
        # Emit literals up to the run.
        lit = run_start - i
        while lit > 0:
            chunk = min(lit, 128)
            out.append(chunk)
            out.extend(row[i:i + chunk].tobytes())
            i += chunk
            lit -= chunk
        if run_start < n:
            run_len = 1
            while (run_start + run_len < n and run_len < 127
                   and row[run_start + run_len] == row[run_start]):
                run_len += 1
            out.append(128 + run_len)
            out.append(int(row[run_start]))
            i = run_start + run_len
    return bytes(out)


def _decode_scanlines(buf: np.ndarray, h: int, w: int) -> np.ndarray:
    rgbe = np.zeros((h, w, 4), np.uint8)
    pos = 0
    for y in range(h):
        if (w >= 8 and w <= 32767 and buf[pos] == 2 and buf[pos + 1] == 2
                and ((int(buf[pos + 2]) << 8) | int(buf[pos + 3])) == w):
            pos += 4
            for ch in range(4):
                x = 0
                while x < w:
                    code = int(buf[pos]); pos += 1
                    if code > 128:  # run
                        cnt = code - 128
                        rgbe[y, x:x + cnt, ch] = buf[pos]
                        pos += 1
                        x += cnt
                    else:  # literal
                        rgbe[y, x:x + code, ch] = buf[pos:pos + code]
                        pos += code
                        x += code
        else:  # flat (possibly old-style RLE not supported)
            row = buf[pos:pos + 4 * w].reshape(w, 4)
            rgbe[y] = row
            pos += 4 * w
    return rgbe
