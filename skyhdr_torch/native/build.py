"""Lazy `cc -O3 -shared` build (or gcc) + ctypes loader for the native helpers, with
a pure-Python fallback (table-driven crc32c) where no C compiler exists.

The library goes to the port's build directory, `skyhdr_torch/_build/`,
named by a hash of its source, so an edited source rebuilds. The fallback
runs the CRC a byte at a time in Python: fine for tests, far too slow for a
training loop over 200 KB records at 64x256, which takes the C helper."""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_SRC = Path(__file__).resolve().with_name("crc32c.c")
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"


@functools.lru_cache(maxsize=None)
def _lib():
    """The built helper library, or None when it cannot be built."""
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so_path = _BUILD_DIR / f"libskyhdr_native-{digest}.so"
    compiler = shutil.which("cc") or shutil.which("gcc")
    if not so_path.exists() and compiler is None:
        return None
    try:
        if not so_path.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
            os.close(fd)
            try:
                subprocess.run([compiler, "-O3", "-fPIC", "-shared", "-o", tmp, str(_SRC)],
                               check=True, capture_output=True)
                os.replace(tmp, so_path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        lib = ctypes.CDLL(str(so_path))
    except (OSError, subprocess.CalledProcessError):
        return None
    lib.skyhdr_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32]
    lib.skyhdr_crc32c.restype = ctypes.c_uint32
    return lib


@functools.lru_cache(maxsize=None)
def _py_table():
    poly = 0x82F63B78
    tbl = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        tbl.append(crc)
    return tbl


def _crc32c_py(data: bytes, seed: int = 0) -> int:
    tbl = _py_table()
    crc = ~seed & 0xFFFFFFFF
    for byte in data:
        crc = (crc >> 8) ^ tbl[(crc ^ byte) & 0xFF]
    return ~crc & 0xFFFFFFFF


def has_native() -> bool:
    return _lib() is not None


def crc32c(data: bytes, seed: int = 0) -> int:
    lib = _lib()
    if lib is not None:
        return lib.skyhdr_crc32c(data, len(data), seed)
    return _crc32c_py(data, seed)


def masked_crc32c(data: bytes) -> int:
    """TFRecord's masked CRC: rot(crc, 15) + 0xa282ead8 (mod 2^32)."""
    crc = crc32c(data)
    return ((crc >> 15) | ((crc << 17) & 0xFFFFFFFF)) + 0xA282EAD8 & 0xFFFFFFFF
