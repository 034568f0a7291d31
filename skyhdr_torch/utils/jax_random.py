"""JAX's default PRNG in torch: the keys, bits and samples of `jax.random`
under `jax_threefry_partitionable=True` (threefry2x32), so that `--seed`
draws what `skyhdr` draws.

A key is an int64 tensor of shape [2] on the host holding JAX's uint32
pair; `split(key, n)` gives [n, 2]. Keys are derived on the host in plain
Python (a key is two words). The samplers draw on `device`: every uint32
lives in an int64 with `& MASK`, so the same code runs on the CPU and on
CUDA, over chunks of `CHUNK` elements (a 64x256 sun-pose FC is 3.2 GB); a
draw of at most `HOST_MAX` elements is made on the host and copied.

  key(seed)                   `jax.random.PRNGKey(seed)` (64-bit ints off).
  split(key, num), fold_in(key, data)
                              the fold-like split: `split(k, n)[i]` is
                              `fold_in(k, i)`, threefry of the counter
                              pair (0, i).
  bits(key, shape)            uint32 bits: threefry of each element's
                              flat index (hi, lo), the two words XORed.
  uniform, normal, truncated_normal, randint
                              float32 / int samples as `jax.random` makes
                              them from those bits.

The integer stages are bit-equal to JAX. Uniform samples are too (the
mantissa trick and one scale and shift, each rounded as XLA rounds them;
a shift by a scale that is not a power of two may round one ulp apart
where XLA contracts it into a fused multiply-add). `normal` and
`truncated_normal` go through `erf_inv`, here XLA's float32 polynomial
(Giles' single-precision approximation) with its Horner steps fused as
XLA:CPU fuses them; its `log1p` is not XLA's, and the two differ by at
most 2 ulps (in about 1% of 2.2 million inputs on the CPU).
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
CHUNK = 1 << 24
# A draw of at most HOST_MAX elements for another device is made on the
# host and copied there: its ~200 elementwise launches cost the card more
# than its work (a degradation's per-sample draws).
HOST_MAX = 1 << 12
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_SQRT2 = float(np.float32(np.sqrt(2)))
# XLA's ErfInv32 coefficients, for w < 5 and for w >= 5.
_ERFINV_LO = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
              0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_HI = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
              0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _f32(x) -> float:
    """`x` rounded to float32, as a Python float."""
    return float(np.float32(x))


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) of the counters (x0, x1) under the key
    (k0, k1): Python ints, or int64 tensors holding uint32 values, which
    it updates in place."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 += k0
    x0 &= MASK
    x1 += k1
    x1 &= MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 += x1
            x0 &= MASK
            low = x1 >> (32 - r)
            x1 <<= r
            x1 &= MASK
            x1 |= low
            x1 ^= x0
        x0 += ks[(i + 1) % 3]
        x0 &= MASK
        x1 += ks[(i + 2) % 3] + i + 1
        x1 &= MASK
    return x0, x1


def _pair(key) -> tuple:
    return int(key[0]) & MASK, int(key[1]) & MASK


def _key(k0: int, k1: int) -> torch.Tensor:
    return torch.tensor([k0, k1], dtype=torch.int64)


def key(seed: int) -> torch.Tensor:
    """`jax.random.PRNGKey(seed)`: the seed as a 32-bit int after a zero
    word (JAX's 64-bit ints are off)."""
    return _key(0, int(seed) & MASK)


def fold_in(key, data: int) -> torch.Tensor:
    """`jax.random.fold_in(key, data)`."""
    return _key(*threefry2x32(*_pair(key), 0, int(data) & MASK))


def split(key, num: int = 2) -> torch.Tensor:
    """`jax.random.split(key, num)`: [num, 2]."""
    k0, k1 = _pair(key)
    return torch.tensor([threefry2x32(k0, k1, 0, i) for i in range(num)],
                        dtype=torch.int64).reshape(num, 2)


def _bits(k0: int, k1: int, start: int, stop: int, device) -> torch.Tensor:
    """The bits of flat indices [start, stop) under the key (k0, k1)."""
    i = torch.arange(start, stop, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(k0, k1, i >> 32, i & MASK)
    return y0.bitwise_xor_(y1)


def _on_host(shape, device) -> bool:
    return torch.device(device).type != "cpu" and math.prod(shape) <= HOST_MAX


def _sample(key, shape, dtype, device, fn) -> torch.Tensor:
    """`fn(bits)` over the chunks of the flat index, in `dtype` (on the
    host and copied to `device` when small, `_on_host`)."""
    shape = tuple(int(s) for s in shape)
    if _on_host(shape, device):
        return _sample(key, shape, dtype, "cpu", fn).to(device, non_blocking=True)
    n = math.prod(shape)
    out = torch.empty(n, dtype=dtype, device=device)
    k0, k1 = _pair(key)
    for start in range(0, n, CHUNK):
        stop = min(n, start + CHUNK)
        out[start:stop] = fn(_bits(k0, k1, start, stop, device))
    return out.reshape(shape)


def bits(key, shape, device="cpu") -> torch.Tensor:
    """`jax.random.bits(key, shape)` (uint32) as int64."""
    return _sample(key, shape, torch.int64, device, lambda b: b)


def _unit(b: torch.Tensor) -> torch.Tensor:
    """[1, 2) from the top 23 bits, minus 1: float32 in [0, 1)."""
    return ((b >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def _uniform_fn(minval: float, maxval: float):
    """u -> max(lo, u * span + lo), the scale and shift rounded once to
    float32, as XLA's fused multiply-add rounds them."""
    lo, span = _f32(minval), _f32(np.float32(maxval) - np.float32(minval))
    return lambda b: torch.clamp_min((_unit(b).double() * span + lo).float(), lo)


def uniform(key, shape, minval: float = 0.0, maxval: float = 1.0,
            device="cpu") -> torch.Tensor:
    """`jax.random.uniform(key, shape, float32, minval, maxval)`."""
    return _sample(key, shape, torch.float32, device, _uniform_fn(minval, maxval))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 erf_inv of float32 `x`: the Horner steps in float64
    rounded once to float32, as a fused multiply-add rounds them."""
    w = (-torch.log1p(-(x * x).double())).float()
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(small, _f32(_ERFINV_LO[0]), _f32(_ERFINV_HI[0]))
    for lo, hi in zip(_ERFINV_LO[1:], _ERFINV_HI[1:]):
        c = torch.where(small, _f32(lo), _f32(hi)).double()
        p = (c + p.double() * w).float()
    return torch.where(x.abs() == 1.0, x * float("inf"), p * x)


def normal(key, shape, device="cpu") -> torch.Tensor:
    """`jax.random.normal(key, shape)`: sqrt(2) erf_inv(u), u uniform on
    [nextafter(-1, 0), 1)."""
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    u = _uniform_fn(lo, 1.0)
    return _sample(key, shape, torch.float32, device, lambda b: erf_inv(u(b)) * _SQRT2)


def truncated_normal(key, lower: float, upper: float, shape, device="cpu") -> torch.Tensor:
    """`jax.random.truncated_normal(key, lower, upper, shape)`."""
    lower, upper = _f32(lower), _f32(upper)
    ends = torch.erf(torch.tensor([lower, upper]) / torch.tensor(_SQRT2))
    u = _uniform_fn(float(ends[0]), float(ends[1]))
    lo = float(np.nextafter(np.float32(lower), np.float32(np.inf)))
    hi = float(np.nextafter(np.float32(upper), np.float32(-np.inf)))
    return _sample(key, shape, torch.float32, device,
                   lambda b: torch.clamp(erf_inv(u(b)) * _SQRT2, lo, hi))


def randint(key, shape, minval: int, maxval: int, device="cpu") -> torch.Tensor:
    """`jax.random.randint(key, shape, minval, maxval)` (int32 sampling;
    the span must stay below 2**31) as int64: two words of bits a value,
    folded modulo the span in uint32 arithmetic (wrapping as JAX's)."""
    span = maxval - minval if maxval > minval else 1
    if not 0 < span < 1 << 31:
        raise ValueError(f"randint span {span} out of range")
    if _on_host(shape, device):
        return randint(key, shape, minval, maxval).to(device, non_blocking=True)
    mult = (((1 << 16) % span) ** 2 & MASK) % span  # 2**32 % span, in uint32 as JAX has it
    k_hi, k_lo = split(key)
    hi, lo = bits(k_hi, shape, device), bits(k_lo, shape, device)
    return minval + (((hi % span) * mult & MASK) + lo % span & MASK) % span


def flax_param_key(root, path, counter: int) -> torch.Tensor:
    """The key Flax's `make_rng('params')` gives the `counter`-th
    parameter (from 1, in `self.param` order) of the scope at `path`
    (module names from the root) under the init key `root`: `root`
    folded with the first 4 bytes of SHA-1 over the names and the
    counter's big-endian bytes (`flax_fix_rng_separator` off)."""
    m = hashlib.sha1()
    for name in path:
        m.update(name.encode("utf-8"))
    m.update(counter.to_bytes((counter.bit_length() + 7) // 8, byteorder="big"))
    return fold_in(root, int.from_bytes(m.digest()[:4], byteorder="big"))
