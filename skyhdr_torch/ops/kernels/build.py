"""Build and load the port's CUDA kernels.

Every `skyhdr_torch/csrc/*.cu` is compiled by its own `nvcc` process for
`sm_90a` (all started together), and the objects are linked into ONE shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds), at first use, under `skyhdr_torch/_build/`. The file name carries
a hash of the sources and the flags, so an edited source rebuilds and an
unchanged one loads the cached library.
The sources in the checkout are the only input. Loading binds the entry
points with `ctypes`, every pointer and the stream as `c_void_p`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
# Compile flags of each source; the objects are linked with `-shared`.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# name -> argtypes; every entry point returns an int (a cudaError_t, or
# for skyhdr_da_{fwd,dx}_tiles a count).
_SIGNATURES = {
    # x, gamma, beta, y, mean, rstd, B, HW, C, cluster, groups, threads, vec,
    # hold, eps, alpha, is_bf16, device, stream
    "skyhdr_in_fwd_k8": [_P] * 6 + [_I] * 8 + [_F, _F] + [_I] * 2 + [_P],
    # x, dy, gamma, beta, mean, rstd, part, counter, dgamma, dbeta, dx, B, HW,
    # C, cluster, groups, threads, vec, hold, alpha, is_bf16, device, stream
    "skyhdr_in_bwd_k9": [_P] * 11 + [_I] * 8 + [_F] + [_I] * 2 + [_P],
    # x, kern, bias, rows, taps, out, B, H, W, Cp, F, k, taps per group, span,
    # rows per block, channels per thread, is_bf16, device, stream
    "skyhdr_da_fwd": [_P] * 6 + [_I] * 12 + [_P],
    # W, F, rows, chans -> blocks per (image, row group) of K1/K5 (or < 0)
    "skyhdr_da_fwd_tiles": [_I] * 4,
    # g, kt, pint, pflt, start, strips, rows, dx, B, H, W, C, Cp, F, k, device, stream
    "skyhdr_da_dx": [_P] * 5 + [_I, _I, _P] + [_I] * 8 + [_P],
    # W, Cp, F -> blocks per (image, strip) of K2/K7 (or < 0)
    "skyhdr_da_dx_tiles": [_I] * 3,
    # W, Cp, F, k, taps per group, span, is_bf16, device, out int32[4]: K3/K6's
    # blocks per split, threads, resident blocks per SM, column chunks
    "skyhdr_da_dk_tiles": [_I] * 8 + [_P],
    # x, g, rows, taps, ws, out, nsplit, B, H, W, Cp, F, k, taps per group,
    # span, is_bf16, device, stream
    "skyhdr_da_dk": [_P] * 6 + [_I] * 11 + [_P],
    # x, kern, y0, y1, cx, wy, wx, out, is_bf16, gather, taps, dedup, mma,
    # diag, B, H, W, C, F, rblk, plan (int array), plan ints, device, stream
    "skyhdr_probe_fwd": [_P] * 8 + [_I] * 12 + [_P, _I, _I, _P],
    # is_bf16, gather, taps, dedup, mma, diag, H, W, C, F, rblk, plan, plan
    # ints, device -> K10's resident blocks per SM (or minus a CUDA error)
    "skyhdr_probe_resident": [_I] * 11 + [_P, _I, _I],
    # x, out, B, H, W, C, P, elem_bytes, device, stream
    "skyhdr_pack_samples": [_P] * 2 + [_I] * 7 + [_P],
    # lhs, rhs, out, m, k, f, ndots, steps, is_bf16, tile, device, stream
    "skyhdr_mm_shape": [_P] * 3 + [_I] * 8 + [_P],
    # adam, p, w, g, mu, nu, n, g_bf16, mu_bf16, nu_bf16, master, vec, decay_mu,
    # decay_nu, term_mu, term_nu, eps, neg_lr, inv_c1, inv_c2, device, stream
    "skyhdr_optim_k13": [_I] + [_P] * 5 + [_L] + [_I] * 5 + [_F] * 8 + [_I, _P],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def sources() -> list:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libskyhdr_kernels-{h.hexdigest()[:16]}.so"


def _compile(cmd: list):
    """Runs one nvcc; returns (its CompletedProcess, its seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    return proc, time.perf_counter() - t0


def build() -> Path:
    """Compile the sources unless the hashed library exists; returns its
    path. One nvcc per source, run in parallel, then one link. The nvcc
    logs (ptxas register and shared-memory usage) and each compile's own
    seconds are kept beside it as `.log`. Raises with nvcc's stderr when a
    compile or the link fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, src.stem + ".o") for src in sources()]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                for obj, src in zip(objs, sources())]
        with ThreadPoolExecutor(len(cmds)) as pool:
            done = list(pool.map(_compile, cmds))
        logs, failed = [], []
        for cmd, (proc, seconds) in zip(cmds, done):
            logs.append(f"{cmd[-1]}: compiled in {seconds:.3f} s\n{proc.stderr}{proc.stdout}")
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                              f"{proc.stderr}{proc.stdout}")
        if failed:
            raise RuntimeError("\n".join(failed))
        lib = os.path.join(tmpdir, "lib.so")
        cmd = [nvcc, "-shared", NVCC_FLAGS[0], NVCC_FLAGS[1], "-o", lib, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): {' '.join(cmd)}\n"
                               f"{proc.stderr}{proc.stdout}")
        out.with_suffix(".log").write_text("".join(logs))
        os.replace(lib, out)
    return out


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library with its entry points bound."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.skyhdr_cuda_error_string.argtypes = [ctypes.c_int]
    lib.skyhdr_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(code: int, what: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if code != 0:
        msg = library().skyhdr_cuda_error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")
