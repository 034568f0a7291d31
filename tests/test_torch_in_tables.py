"""K8/K9's launch plan (`in_tiling`) and their order of summation, on the
CPU (the kernels themselves run only on the card, `tests/test_torch_gpu.py`).

  - `in_tiling` at every InstanceNorm shape of the model (16x64, 32x128 and
    64x256; b1, b2, b32, b64; f32 and bf16; K8 and K9) and at the card
    tests' odd shapes: the plan fits shared memory, the thread and cluster
    limits, and its blocks cover every (pixel, channel) exactly once;
  - a torch emulation of the kernels' order (each thread's pixels, the
    warp butterfly and the warps of a block, the cluster's blocks in rank
    order, the batch in sample order; K8 merges each thread's two-pass
    moments by Chan's formula) against the plain versions (1e-5 of
    the max: the same formula summed in another order) and against
    `skyhdr`'s `_pallas_fwd` / `_pallas_bwd` in interpret mode (the
    tolerances of `tests/test_torch_instnorm.py`: forward 2e-6 absolute,
    mean / rstd 1e-6, gradients rtol 2e-4 / atol 2e-5);
  - the bfloat16 slope, rounded in plain Python, against the tensor
    rounding the wrapper used before (`torch.tensor(alpha, bfloat16)`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyhdr.ops.pallas import instnorm as jin
from skyhdr_torch.ops.kernels import instnorm as tin

# The suite runs in several worker processes that share the CPU; torch's
# default of one thread per core in each of them oversubscribes it.
torch.set_num_threads(1)

SMS = 132  # the H100's SMs
# (h, w, c) of the model's InstanceNorm inputs at 32x128; x0.5 and x2 give
# 16x64 and 64x256.
IN_SHAPES = [(32, 128, 32), (16, 64, 64), (8, 32, 128)]
MODEL_CASES = [((h * s // 2, w * s // 2, c), b) for s in (1, 2, 4) for h, w, c in IN_SHAPES
               for b in (1, 2, 32, 64)]
# The card tests' shapes (tests/test_torch_gpu.py), and one too large to hold.
ODD_CASES = [((3, 5, 7), 1), ((16, 64, 32), 2), ((8, 32, 64), 3), ((4, 16, 128), 2),
             ((32, 128, 32), 2), ((1, 2, 64), 1), ((512, 256, 8), 1)]


def _check_plan(p, b, hw, c, elem, tensors):
    cg = c // p.groups
    lanes = cg // p.vec
    assert p.cluster in tin.IN_CLUSTERS and c % p.groups == 0 and cg % p.vec == 0
    assert p.vec in (1, 16 // elem)
    assert 1 <= p.threads <= (512 if p.vec > 1 else 1024) and p.threads % lanes == 0
    if 32 % lanes == 0:
        assert p.threads % 32 == 0  # the butterfly's full warps
    assert p.groups <= 65535  # the grid's y
    rows = p.threads // lanes
    assert p.per_thread == -(-(-(-hw // p.cluster)) // rows)
    assert p.smem == tin.in_smem_bytes(hw, c, elem, tensors, p.cluster, p.groups, p.threads,
                                       p.vec, p.holds) <= tin.IN_SMEM
    if p.holds:  # the held copies: every pixel of the largest share
        share = -(-hw // p.cluster) * cg * elem
        assert p.smem >= tensors * share


def _coverage(p, hw, c):
    """How often the plan's threads touch each (pixel, channel): the
    kernels' mapping (block rank r of the cluster takes pixels [r*hw/n,
    (r+1)*hw/n), group g channels [g*CG, (g+1)*CG); thread t of L lanes
    takes channels lane*vec .. +vec of pixels row, row + R, ...)."""
    cg = c // p.groups
    lanes = cg // p.vec
    rows = p.threads // lanes
    seen = np.zeros((hw, c), np.int32)
    t = np.arange(p.threads)
    lane, row = t % lanes, t // lanes
    k = np.arange(p.per_thread + 1)
    for rank in range(p.cluster):
        p0, p1 = rank * hw // p.cluster, (rank + 1) * hw // p.cluster
        pix = row[:, None] + k[None, :] * rows                      # [threads, k]
        ok = pix < p1 - p0
        assert (pix[:, p.per_thread] >= p1 - p0).all()              # per_thread suffices
        for g in range(p.groups):
            ch = g * cg + lane[:, None] * p.vec + np.arange(p.vec)[None, :]  # [threads, vec]
            pp = np.broadcast_to((p0 + pix)[:, :, None], ok.shape + (p.vec,))[ok]
            cc = np.broadcast_to(ch[:, None, :], ok.shape + (p.vec,))[ok]
            np.add.at(seen, (pp, cc), 1)
    return seen


@pytest.mark.parametrize("tensors", [1, 2], ids=["K8", "K9"])
@pytest.mark.parametrize("elem", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("hwc,b", MODEL_CASES + ODD_CASES,
                         ids=[f"{h}x{w}x{c}-b{b}" for (h, w, c), b in MODEL_CASES + ODD_CASES])
def test_in_tiling_fits_and_covers(hwc, b, elem, tensors):
    h, w, c = hwc
    p = tin.in_tiling(b, h * w, c, elem, SMS, tensors)
    _check_plan(p, b, h * w, c, elem, tensors)
    if hwc != (512, 256, 8):
        assert p.holds  # every shape the model runs reads its inputs once
    assert (_coverage(p, h * w, c) == 1).all()


def test_in_tiling_branches():
    """The branches the card tests reach: every cluster size, channel
    groups, one element a thread (C not a multiple of the vector, or a
    misaligned pointer), and a share too large to hold."""
    plans = [tin.in_tiling(b, h * w, c, e, SMS, t) for (h, w, c), b in MODEL_CASES
             for e in (4, 2) for t in (1, 2)]
    assert {p.cluster for p in plans} >= {8, 16}
    assert {p.groups for p in plans} >= {1, 2, 4, 8}
    assert tin.in_tiling(1, 15, 7, 4, SMS).vec == 1
    assert tin.in_tiling(2, 1024, 32, 4, SMS, 1, False).vec == 1
    big = tin.in_tiling(1, 512 * 256, 8, 4, SMS)
    assert not big.holds and big.smem < 16 * 1024
    # With the SMs filled, the fewest splits: a small b64 share in one block.
    assert tin.in_tiling(1024, 64, 32, 4, SMS).cluster == 1


# Emulation of the kernels' order of summation --------------------------------


def _block_sums(v, p, lanes):
    """v [b, P, CG] f32 -> [b, CG]: each thread's pixels in order, then the
    warp butterfly (where whole rows fit a warp) and the block's rows (warps)
    in order, as `block_sum` in csrc/instnorm.cu."""
    b, npix, cg = v.shape
    rows = p.threads // lanes
    s = torch.zeros(b, rows, cg)
    for k in range(-(-npix // rows)):
        part = v[:, k * rows:(k + 1) * rows]
        s[:, :part.shape[1]] = s[:, :part.shape[1]] + part
    if 32 % lanes == 0:
        per_warp = 32 // lanes
        s = s.reshape(b, rows // per_warp, per_warp, cg)
        idx = torch.arange(per_warp)
        off = 1
        while off < per_warp:
            s = s + s[:, :, idx ^ off]
            off *= 2
        s = s[:, :, 0]
    out = torch.zeros(b, cg)
    for r in range(s.shape[1]):
        out = out + s[:, r]
    return out


def _cluster_sums(fn, xs, p, hw):
    """fn(the block's pixels [b, P, ...]) -> [b, P, CG] values; summed per
    block, then over the cluster's blocks in rank order."""
    lanes = xs[0].shape[-1] // p.vec
    total = 0.0
    for rank in range(p.cluster):
        p0, p1 = rank * hw // p.cluster, (rank + 1) * hw // p.cluster
        total = total + _block_sums(fn(*(t[:, p0:p1] for t in xs)), p, lanes)
    return total


def _chan(a, b):
    """Chan et al.: the moments (count, mean, sum of squared deviations) of
    two sets merged, as `chan` in csrc/instnorm.cu (counts broadcast)."""
    (n, m, m2), (nb, mb, m2b) = a, b
    nab = n + nb
    fb = torch.where(nab > 0, nb / torch.where(nab > 0, nab, 1.0), 0.0)
    d = mb - m
    keep = nb == 0
    return (torch.where(keep, n, nab), torch.where(keep, m, m + d * fb),
            torch.where(keep, m2, m2 + m2b + d * d * n * fb))


def _block_moments(v, p, lanes):
    """v [b, P, CG] f32 -> (count, mean, M2) [b, CG] of a K8 block: each thread's
    pixels (their mean, then the squared deviations from it), merged by
    Chan's formula over the warp butterfly and then the rows in order, as
    `block_moments` in csrc/instnorm.cu."""
    b, npix, cg = v.shape
    rows = p.threads // lanes
    s, n = torch.zeros(b, rows, cg), torch.zeros(b, rows, 1)
    for k in range(-(-npix // rows)):
        part = v[:, k * rows:(k + 1) * rows]
        s[:, :part.shape[1]] = s[:, :part.shape[1]] + part
        n[:, :part.shape[1]] += 1
    m = torch.where(n > 0, s / n.clamp(min=1), 0.0)
    m2 = torch.zeros(b, rows, cg)
    for k in range(-(-npix // rows)):
        part = v[:, k * rows:(k + 1) * rows]
        d = part - m[:, :part.shape[1]]
        m2[:, :part.shape[1]] = m2[:, :part.shape[1]] + d * d
    mom = (n.expand(b, rows, cg).clone(), m, m2)
    if 32 % lanes == 0:
        per_warp = 32 // lanes
        mom = tuple(t.reshape(b, rows // per_warp, per_warp, cg) for t in mom)
        idx = torch.arange(per_warp)
        off = 1
        while off < per_warp:
            mom = _chan(mom, tuple(t[:, :, idx ^ off] for t in mom))
            off *= 2
        mom = tuple(t[:, :, 0] for t in mom)
    out = (torch.zeros(b, cg),) * 3
    for r in range(mom[0].shape[1]):
        out = _chan(out, tuple(t[:, r] for t in mom))
    return out


def emulate_k8(x, gamma, beta, p, eps=1e-3, alpha=1.0):
    b, h, w, c = x.shape
    hw, cg = h * w, c // p.groups
    xf = x.float().reshape(b, hw, c)
    y, mean, rstd = torch.empty(b, hw, c, dtype=x.dtype), torch.empty(b, c), torch.empty(b, c)
    a = tin._alpha_in(x.dtype, alpha)
    lanes = cg // p.vec
    for g in range(p.groups):
        sl = slice(g * cg, (g + 1) * cg)
        xs = xf[:, :, sl]
        mom = (torch.zeros(b, cg),) * 3
        for rank in range(p.cluster):  # the cluster's blocks in rank order
            p0, p1 = rank * hw // p.cluster, (rank + 1) * hw // p.cluster
            _, bm, bm2 = _block_moments(xs[:, p0:p1], p, lanes)
            mom = _chan(mom, (torch.full((b, cg), float(p1 - p0)), bm, bm2))
        m = mom[1]
        r = 1.0 / torch.sqrt(mom[2] / hw + eps)
        yf = (xs - m[:, None]) * r[:, None] * gamma[sl] + beta[sl]
        out = yf.to(x.dtype)
        if alpha != 1.0:
            out = torch.where(yf >= 0, out, (a * out.float()).to(x.dtype))
        y[:, :, sl], mean[:, sl], rstd[:, sl] = out, m, r
    return y.reshape(x.shape), mean, rstd


def emulate_k9(x, dy, gamma, beta, mean, rstd, p, alpha=1.0):
    b, h, w, c = x.shape
    hw, cg = h * w, c // p.groups
    xf, dyf = x.float().reshape(b, hw, c), dy.float().reshape(b, hw, c)
    dx, part = torch.empty(b, hw, c, dtype=x.dtype), torch.empty(b, c, 2)
    for g in range(p.groups):
        sl = slice(g * cg, (g + 1) * cg)
        m, r, ga, be = mean[:, None, sl], rstd[:, None, sl], gamma[sl], beta[sl]

        def xhat_dyf(xv, dv):
            xh = (xv - m) * r
            return xh, torch.where(xh * ga + be >= 0, dv, alpha * dv) if alpha != 1.0 else dv

        s1 = _cluster_sums(lambda xv, dv: xhat_dyf(xv, dv)[1], [xf[:, :, sl], dyf[:, :, sl]], p, hw)
        s2 = _cluster_sums(lambda xv, dv: (lambda xh, d: d * xh)(*xhat_dyf(xv, dv)),
                           [xf[:, :, sl], dyf[:, :, sl]], p, hw)
        part[:, sl, 0], part[:, sl, 1] = s1, s2
        xh, d = xhat_dyf(xf[:, :, sl], dyf[:, :, sl])
        m1, m2 = (ga * s1 / hw)[:, None], (ga * s2 / hw)[:, None]
        dx[:, :, sl] = (r * (d * ga - m1 - xh * m2)).to(x.dtype)
    dbeta, dgamma = torch.zeros(c), torch.zeros(c)
    for i in range(b):  # the batch in sample order
        dbeta, dgamma = dbeta + part[i, :, 0], dgamma + part[i, :, 1]
    return dx.reshape(x.shape), dgamma, dbeta


def _inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.3).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = (rng.standard_normal(c) * 0.1).astype(np.float32)
    dy = np.sin(3.0 * rng.standard_normal(shape)).astype(np.float32)
    return x, gamma, beta, dy


def _rel(a, b):
    a, b = torch.as_tensor(np.asarray(a, np.float32)), torch.as_tensor(np.asarray(b, np.float32))
    return ((a - b).abs().max() / b.abs().max()).item()


# (shape, batch of the plan's fill) -- the plan is taken at the shape's own
# batch, and at b64 of the same slab, which splits less.
EMU_SHAPES = [(2, 16, 64, 32), (3, 8, 32, 64), (2, 4, 16, 128), (1, 3, 5, 7), (2, 32, 32, 16)]


@pytest.mark.parametrize("alpha", [1.0, 0.0, 0.1])
@pytest.mark.parametrize("shape", EMU_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_emulated_order_matches_plain(shape, alpha):
    x, gamma, beta, dy = (torch.from_numpy(a) for a in _inputs(shape))
    b, h, w, c = shape
    for plan_b in (b, 64):
        p8 = tin.in_tiling(plan_b, h * w, c, 4, SMS, 1)
        p9 = tin.in_tiling(plan_b, h * w, c, 4, SMS, 2)
        y, mean, rstd = emulate_k8(x, gamma, beta, p8, alpha=alpha)
        y_ref, mean_ref, rstd_ref = tin.instance_norm_act_ref(x, gamma, beta, alpha=alpha)
        for got, want in ((y, y_ref), (mean, mean_ref), (rstd, rstd_ref)):
            assert _rel(got, want) <= 1e-5
        got = emulate_k9(x, dy, gamma, beta, mean, rstd, p9, alpha=alpha)
        want = tin.instance_norm_act_bwd_ref(x, dy, gamma, beta, mean, rstd, alpha=alpha)
        for name, a, r in zip(("dx", "dgamma", "dbeta"), got, want):
            assert _rel(a, r) <= 1e-5, name


def test_emulated_order_keeps_a_large_mean_channel():
    """Each thread's two passes (mean, then sum (x - mean)^2) merged by
    Chan's formula keep the variance of a channel whose mean dwarfs its
    spread (`test_torch_gpu.py`'s case)."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy((1000.0 + rng.standard_normal((2, 32, 128, 32)) * 0.01)
                         .astype(np.float32))
    ones, zeros = torch.ones(32), torch.zeros(32)
    p = tin.in_tiling(2, 32 * 128, 32, 4, SMS, 1)
    _, _, rstd = emulate_k8(x, ones, zeros, p)
    _, _, rstd_ref = tin.instance_norm_act_ref(x, ones, zeros)
    assert _rel(rstd, rstd_ref) <= 1e-3


@pytest.mark.parametrize("alpha", [0.0, 0.1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 8, 16, 32), (2, 4, 8, 128)], ids=lambda s: "x".join(map(str, s)))
def test_emulated_order_matches_pallas_interpret(shape, dtype, alpha):
    x, gamma, beta, dy = _inputs(shape, seed=1)
    b, h, w, c = shape
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    elem = 4 if dtype == "float32" else 2
    want, jmean, jrstd = jin._pallas_fwd(jnp.asarray(x, jdt), gamma, beta, 1e-3, alpha,
                                         interpret=True)
    xt = torch.from_numpy(np.array(x)).to(tdt)
    gt, bt = torch.from_numpy(gamma), torch.from_numpy(beta)
    y, mean, rstd = emulate_k8(xt, gt, bt, tin.in_tiling(b, h * w, c, elem, SMS, 1), alpha=alpha)
    tol = 2e-6 if dtype == "float32" else 2e-3
    np.testing.assert_allclose(y.float().numpy(), np.asarray(want, np.float32), atol=tol)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean)[:, 0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd)[:, 0], rtol=1e-6)
    if dtype == "float32":
        jdx, jdg, jdb = jin._pallas_bwd(jnp.asarray(x), jnp.asarray(dy), gamma, beta, jmean,
                                        jrstd, alpha, interpret=True)
        got = emulate_k9(xt, torch.from_numpy(dy), gt, bt, mean, rstd,
                         tin.in_tiling(b, h * w, c, 4, SMS, 2), alpha=alpha)
        for name, a, r in zip(("dx", "dgamma", "dbeta"), got, (jdx, jdg, jdb)):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=2e-4, atol=2e-5,
                                       err_msg=name)


# The bfloat16 slope ----------------------------------------------------------

SLOPES = [1.0, 0.0, 0.1, 0.2, 0.01, 0.3]  # the model's (1, 0, 0.1) and others


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("alpha", SLOPES)
def test_alpha_rounding_matches_tensor_rounding(alpha, dtype):
    assert tin._alpha_in(dtype, alpha) == float(torch.tensor(alpha, dtype=dtype).float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_alpha_rounding_sweep(dtype):
    rng = np.random.default_rng(0)
    vals = np.concatenate([rng.standard_normal(2000), rng.uniform(0, 1, 2000),
                           np.exp(rng.uniform(-60, 60, 1000)),
                           # bf16 ties: halfway between two bf16 values
                           (np.arange(1, 500) * 2.0 ** -8 + 2.0 ** -9) * 2.0 ** -3])
    want = torch.tensor(vals, dtype=torch.float64).to(torch.float32).to(dtype).float()
    got = [tin._alpha_in(dtype, float(v)) for v in vals]
    assert got == [float(torch.tensor(float(v), dtype=dtype).float()) for v in vals]
    assert got == want.tolist()
