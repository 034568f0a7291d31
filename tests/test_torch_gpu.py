"""Tests of the port that need a CUDA card (marker `gpu`). They import no
JAX, so they also run where only the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Without a card each test skips with a reason."""

import pytest
import torch

from skyhdr_torch.ops.kernels import deform_conv as dc
from skyhdr_torch.ops.kernels import instnorm as tin
from skyhdr_torch.ops.kernels import probes as tp

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(cuda, shape, f, dtype=torch.float32, ksize=3):
    gen = torch.Generator(device=cuda).manual_seed(0)
    c = shape[-1]
    x = torch.randn(shape, device=cuda, generator=gen).to(dtype)
    k = torch.randn(ksize * ksize * c, f, device=cuda, generator=gen) * 0.05
    b = torch.randn(f, device=cuda, generator=gen)
    g = torch.randn(shape[:3] + (f,), device=cuda, generator=gen)
    return x, k, b, g


def _rel(a, b):
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


@pytest.mark.parametrize("shape,f", [((2, 16, 64, 32), 64), ((2, 8, 32, 128), 128),
                                     ((1, 32, 128, 64), 32)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_k1_matches_plain(cuda, shape, f, dtype, tol):
    x, k, b, _ = _operands(cuda, shape, f, dtype)
    n = dc.K1_LAUNCHES
    got = dc.da_conv_forward_k1(x, k, b)
    torch.cuda.synchronize()
    assert dc.K1_LAUNCHES == n + 1 and got.dtype == dtype
    assert _rel(got, dc.da_conv_forward_ref(x, k, b)) <= tol


@pytest.mark.parametrize("shape,f", [((2, 16, 64, 32), 64), ((2, 8, 32, 128), 128)])
def test_k2_matches_plain(cuda, shape, f):
    _, k, _, g = _operands(cuda, shape, f)
    n = dc.K2_LAUNCHES
    got = dc.da_conv_dx_k2(g, k, x_shape=shape)
    torch.cuda.synchronize()
    assert dc.K2_LAUNCHES == n + 1
    assert _rel(got, dc.da_conv_dx_ref(g, k, x_shape=shape)) <= 5e-4


@pytest.mark.parametrize("shape,f", [((2, 8, 32, 128), 128), ((2, 32, 128, 64), 32),
                                     ((2, 16, 64, 32), 64), ((1, 6, 24, 8), 12)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_matches_plain(cuda, shape, f, dtype):
    x, _, _, g = _operands(cuda, shape, f, dtype)
    n = dc.K3_LAUNCHES
    got = dc.da_conv_dk_k3(x, g)
    torch.cuda.synchronize()
    assert dc.K3_LAUNCHES == n + 1 and got.shape == (9 * shape[-1], f)
    assert _rel(got, dc.da_conv_dk_ref(x, g)) <= 1e-4
    assert torch.equal(got, dc.da_conv_dk_k3(x, g))  # fixed summation order


def test_autograd_function_on_cuda_takes_kernels(cuda):
    x, k, b, g = _operands(cuda, (2, 8, 32, 16), 8)
    x.requires_grad_()
    k.requires_grad_()
    b.requires_grad_()
    before = (dc.K1_LAUNCHES, dc.K2_LAUNCHES, dc.K3_LAUNCHES)
    dc.da_conv(x, k, b).backward(g)
    torch.cuda.synchronize()
    assert (dc.K1_LAUNCHES, dc.K2_LAUNCHES, dc.K3_LAUNCHES) == tuple(
        n + 1 for n in before)
    assert _rel(k.grad, dc.da_conv_dk_ref(x.detach(), g)) <= 1e-4
    assert _rel(b.grad, g.sum((0, 1, 2))) <= 1e-5
    assert _rel(x.grad, dc.da_conv_dx_ref(g, k.detach(), x_shape=x.shape)) <= 5e-4


def test_k3_kernels_at_odd_height(cuda):
    """K1-K3 take per-(row, tap) tables, so an odd row count needs no other
    kernel (the TPU package sends odd heights to its generic kernel)."""
    x, k, b, g = _operands(cuda, (2, 9, 32, 16), 8)
    assert _rel(dc.da_conv_forward_k1(x, k, b), dc.da_conv_forward_ref(x, k, b)) <= 1e-4
    assert _rel(dc.da_conv_dx_k2(g, k, x_shape=x.shape),
                dc.da_conv_dx_ref(g, k, x_shape=x.shape)) <= 5e-4
    assert _rel(dc.da_conv_dk_k3(x, g), dc.da_conv_dk_ref(x, g)) <= 1e-4


def _dx_pair(ksize):
    """(kernel, plain version) of the input gradient at kernel size k."""
    if ksize == 3:
        return dc.da_conv_dx_k2, dc.da_conv_dx_ref
    kw = dict(kernel_size=ksize)
    return (lambda g, k, **a: dc.da_conv_dx_k7(g, k, **kw, **a),
            lambda g, k, **a: dc.da_conv_dx_ref_generic(g, k, **kw, **a))


# K2 and K7 are one kernel over the strip pair tables (`dx_strip_rows`
# input rows a block): at other strip heights, the odd height at full
# width, an F that is no multiple of 4 (padded), and two launches bitwise
# equal.
@pytest.mark.parametrize("ksize", [3, 5, 7])
@pytest.mark.parametrize("rows", [1, 2, 3, 8])
@pytest.mark.parametrize("skydome,dilation", [(True, 1), (False, 2)])
def test_dx_at_other_strip_heights(cuda, monkeypatch, ksize, rows, skydome, dilation):
    monkeypatch.setattr(dc, "dx_strip_rows", lambda *_: rows)
    shape, f = (2, 9, 40, 16), 24
    _, k, _, g = _operands(cuda, shape, f, ksize=ksize)
    run, plain = _dx_pair(ksize)
    geom = dict(x_shape=shape, skydome=skydome, dilation_rate=dilation)
    assert _rel(run(g, k, **geom), plain(g, k, **geom)) <= 5e-4


@pytest.mark.parametrize("ksize", [3, 5])
def test_dx_at_odd_height(cuda, ksize):
    shape, f = (32, 9, 32, 128), 128
    _, k, _, g = _operands(cuda, shape, f, ksize=ksize)
    run, plain = _dx_pair(ksize)
    assert _rel(run(g, k, x_shape=shape), plain(g, k, x_shape=shape)) <= 5e-4


@pytest.mark.parametrize("ksize,shape", [(3, (2, 8, 32, 8)), (5, (2, 8, 32, 8)),
                                         (7, (2, 16, 64, 3))])
def test_dx_pads_f(cuda, ksize, shape):
    _, k, _, g = _operands(cuda, shape, 6, ksize=ksize)
    run, plain = _dx_pair(ksize)
    got = run(g, k, x_shape=shape)
    assert got.shape == shape
    assert _rel(got, plain(g, k, x_shape=shape)) <= 5e-4


@pytest.mark.parametrize("ksize,shape,f", [(3, (8, 64, 256, 64), 32),
                                           (5, (8, 16, 64, 128), 128)])
def test_dx_is_bitwise_repeatable(cuda, ksize, shape, f):
    _, k, _, g = _operands(cuda, shape, f, ksize=ksize)
    run, _ = _dx_pair(ksize)
    assert torch.equal(run(g, k, x_shape=shape), run(g, k, x_shape=shape))


def _fwd_pair(ksize):
    """(kernel, plain version) of the forward at kernel size k."""
    if ksize == 3:
        return dc.da_conv_forward_k1, dc.da_conv_forward_ref
    kw = dict(kernel_size=ksize)
    return (lambda x, k, b, **a: dc.da_conv_forward_k5(x, k, b, **kw, **a),
            lambda x, k, b, **a: dc.da_conv_forward_ref(x, k, b, **kw, **a))


# K1 and K5 are one kernel over the window tables (`fwd_tiling` picks the
# output rows of a block and the channels of a thread's tile): the shapes
# where its tiling could break — F = 32 at 64x256 (conv2_f/u, one
# 128-column row a block), C = 3 at k = 7 (padded to 4), the odd height,
# b1 (one row a block), bf16 — each against the plain version and twice
# bitwise equal.
FWD_CASES = [(3, (2, 64, 256, 64), 32), (7, (2, 64, 256, 3), 32), (3, (4, 9, 32, 128), 128),
             (5, (4, 9, 32, 128), 128), (3, (1, 8, 32, 128), 128), (5, (1, 16, 64, 128), 128),
             (7, (1, 16, 64, 128), 128), (3, (2, 32, 128, 32), 64), (3, (32, 16, 64, 128), 128)]


@pytest.mark.parametrize("ksize,shape,f", FWD_CASES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_fwd_tilings_match_plain_and_repeat(cuda, ksize, shape, f, dtype, tol):
    x, k, b, _ = _operands(cuda, shape, f, dtype, ksize)
    run, plain = _fwd_pair(ksize)
    got = run(x, k, b)
    assert got.dtype == dtype and _rel(got, plain(x, k, b)) <= tol
    assert torch.equal(got, run(x, k, b))


# Other tilings, both geometries, and the per-tap window tables (one group
# a tap, span 0) that a shape whose kernel rows read different source rows
# would be given. (rows, chans, W, F): every row count of 4-channel tiles,
# and 8-channel tiles of 8 rows x 16 and 2 rows x 64 columns.
@pytest.mark.parametrize("ksize", [3, 5, 7])
@pytest.mark.parametrize("rows,chans,w,f", [(1, 4, 16, 24), (2, 4, 16, 24), (4, 4, 16, 24),
                                            (8, 4, 16, 24), (8, 8, 16, 128), (2, 8, 64, 128)])
@pytest.mark.parametrize("skydome,dilation,dedup", [(True, 1, True), (False, 2, True),
                                                    (True, 1, False)])
def test_fwd_at_other_tilings_and_tables(cuda, monkeypatch, ksize, rows, chans, w, f, skydome,
                                         dilation, dedup):
    from skyhdr_torch.ops.distortion import window_tables_on

    monkeypatch.setattr(dc, "fwd_launch_tiling", lambda *_: (rows, chans))
    monkeypatch.setattr(dc, "window_tables_on",
                        lambda *a: window_tables_on(*a, dedup=dedup))
    x, k, b, _ = _operands(cuda, (2, 9, w, 16), f, ksize=ksize)
    run, plain = _fwd_pair(ksize)
    geom = dict(skydome=skydome, dilation_rate=dilation)
    assert _rel(run(x, k, b, **geom), plain(x, k, b, **geom)) <= 1e-4


def test_fwd_tiles_are_the_documented_ones(cuda):
    """The kernel library's tiling agrees with the table the CPU test of
    `fwd_tiling` (tests/test_torch_fwd_tables.py) is written from."""
    from skyhdr_torch.ops.kernels.build import library

    lib = library()
    for (w, f), want in FWD_TILES.items():
        got = {(r, n): lib.skyhdr_da_fwd_tiles(w, f, r, n)
               for n in dc.FWD_CHANS for r in dc.FWD_ROWS}
        assert got == want, (w, f)


# Blocks per (image, row group) of K1/K5 at the model's (W, F), by (rows,
# chans); -1 where that does not tile. The same table is in
# tests/test_torch_fwd_tables.py.
FWD_TILES = {
    (64, 128): {(8, 8): -1, (4, 8): -1, (2, 8): 1, (1, 8): -1,
                (8, 4): -1, (4, 4): -1, (2, 4): -1, (1, 4): 1},
    (32, 128): {(8, 8): -1, (4, 8): 1, (2, 8): -1, (1, 8): -1,
                (8, 4): -1, (4, 4): -1, (2, 4): 1, (1, 4): 1},
    (128, 64): {(8, 8): -1, (4, 8): -1, (2, 8): -1, (1, 8): -1,
                (8, 4): -1, (4, 4): -1, (2, 4): -1, (1, 4): 1},
    (256, 32): {(8, 8): -1, (4, 8): -1, (2, 8): -1, (1, 8): -1,
                (8, 4): -1, (4, 4): -1, (2, 4): -1, (1, 4): 2},
}


def test_k2_refuses_channels_it_does_not_tile(cuda):
    _, k, _, g = _operands(cuda, (1, 8, 32, 6), 8)
    with pytest.raises(ValueError, match="K2"):
        dc.da_conv_dx_k2(g, k, x_shape=(1, 8, 32, 6))


# (x shape, F) at k = 5 and 7: the trunk, the k = 7 sun-pose stage 1 (C = 3
# and C = 32) at a narrow size, and an odd height.
ODD_K_SHAPES = [((2, 8, 32, 128), 128), ((2, 16, 64, 3), 32), ((2, 16, 64, 32), 32),
                ((1, 9, 24, 8), 16)]


@pytest.mark.parametrize("ksize", [5, 7])
@pytest.mark.parametrize("shape,f", ODD_K_SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_k5_matches_plain(cuda, ksize, shape, f, dtype, tol):
    x, k, b, _ = _operands(cuda, shape, f, dtype, ksize)
    n = dc.K5_LAUNCHES
    got = dc.da_conv_forward_k5(x, k, b, kernel_size=ksize)
    torch.cuda.synchronize()
    assert dc.K5_LAUNCHES == n + 1 and got.dtype == dtype
    assert _rel(got, dc.da_conv_forward_ref(x, k, b, kernel_size=ksize)) <= tol


@pytest.mark.parametrize("ksize", [5, 7])
@pytest.mark.parametrize("shape,f", ODD_K_SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-4), (torch.bfloat16, 2e-2)])
def test_k7_matches_plain(cuda, ksize, shape, f, dtype, tol):
    """g in the working dtype, as autograd hands it; dx cast back to it."""
    _, k, _, g = _operands(cuda, shape, f, ksize=ksize)
    g = g.to(dtype)
    n = dc.K7_LAUNCHES
    got = dc.da_conv_dx_k7(g, k, x_shape=shape, kernel_size=ksize).to(dtype)
    torch.cuda.synchronize()
    assert dc.K7_LAUNCHES == n + 1 and got.shape == shape
    want = dc.da_conv_dx_ref_generic(g, k, x_shape=shape, kernel_size=ksize).to(dtype)
    assert _rel(got, want) <= tol


@pytest.mark.parametrize("ksize", [5, 7])
@pytest.mark.parametrize("shape,f", ODD_K_SHAPES + [((1, 6, 24, 8), 12)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k6_matches_plain(cuda, ksize, shape, f, dtype):
    x, _, _, g = _operands(cuda, shape, f, dtype, ksize)
    n = dc.K6_LAUNCHES
    got = dc.da_conv_dk_k6(x, g, kernel_size=ksize)
    torch.cuda.synchronize()
    assert dc.K6_LAUNCHES == n + 1 and got.shape == (ksize * ksize * shape[-1], f)
    assert _rel(got, dc.da_conv_dk_ref(x, g, kernel_size=ksize)) <= 1e-4
    assert torch.equal(got, dc.da_conv_dk_k6(x, g, kernel_size=ksize))  # fixed order


def test_autograd_function_odd_k_on_cuda_takes_kernels(cuda):
    x, k, b, g = _operands(cuda, (2, 8, 32, 16), 8, ksize=5)
    for t in (x, k, b):
        t.requires_grad_()
    names = ("K1", "K2", "K3", "K5", "K6", "K7")
    before = [getattr(dc, f"{n}_LAUNCHES") for n in names]
    dc.da_conv(x, k, b, kernel_size=5).backward(g)
    torch.cuda.synchronize()
    after = [getattr(dc, f"{n}_LAUNCHES") for n in names]
    assert [a - c for a, c in zip(after, before)] == [0, 0, 0, 1, 1, 1]
    assert _rel(k.grad, dc.da_conv_dk_ref(x.detach(), g, kernel_size=5)) <= 1e-4
    assert _rel(b.grad, g.sum((0, 1, 2))) <= 1e-5
    want = dc.da_conv_dx_ref_generic(g, k.detach(), x_shape=x.shape, kernel_size=5)
    assert _rel(x.grad, want) <= 5e-4


def _dk_pair(ksize):
    """(kernel, plain version) of the weight gradient at kernel size k."""
    if ksize == 3:
        return dc.da_conv_dk_k3, dc.da_conv_dk_ref
    kw = dict(kernel_size=ksize)
    return (lambda x, g, **a: dc.da_conv_dk_k6(x, g, **kw, **a),
            lambda x, g, **a: dc.da_conv_dk_ref(x, g, **kw, **a))


# K3 and K6 are one kernel over the window tables (`skyhdr_da_dk_tiles`
# plans the tile, `dk_tiling` the splits): the shapes where its tiling could
# break — F = 32 at 64x256 (eight column chunks a row), C = 3 at k = 7
# (padded to 4; eight slices of a 32-row tile), F = 64 at C = 32 (two
# slices), the odd height, k = 5 and 7 at the trunk, b1 — each against the
# plain version and twice bitwise equal.
DK_CASES = [(3, (2, 64, 256, 64), 32), (7, (2, 64, 256, 3), 32), (3, (2, 32, 128, 32), 64),
            (3, (4, 9, 32, 128), 128), (5, (4, 9, 32, 128), 128), (5, (2, 16, 64, 128), 128),
            (7, (2, 16, 64, 128), 128), (3, (1, 8, 32, 128), 128), (7, (2, 32, 128, 32), 32)]


@pytest.mark.parametrize("ksize,shape,f", DK_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dk_tilings_match_plain_and_repeat(cuda, ksize, shape, f, dtype):
    x, _, _, g = _operands(cuda, shape, f, dtype, ksize)
    run, plain = _dk_pair(ksize)
    got = run(x, g)
    assert got.shape == (ksize * ksize * shape[-1], f)
    assert _rel(got, plain(x, g)) <= 1e-4
    assert torch.equal(got, run(x, g))


# Other splits (one, a few, more than the stages: some left empty), both
# geometries, and the per-tap
# window tables (one group a tap) that a shape whose kernel rows read
# different source rows would be given.
@pytest.mark.parametrize("ksize", [3, 5, 7])
@pytest.mark.parametrize("splits", [1, 5, 10_000])
@pytest.mark.parametrize("skydome,dilation,dedup", [(True, 1, True), (False, 2, True),
                                                    (True, 1, False)])
def test_dk_at_other_splits_and_tables(cuda, monkeypatch, ksize, splits, skydome, dilation,
                                       dedup):
    from skyhdr_torch.ops.distortion import window_tables_on

    launch_tiling = dc.dk_launch_tiling
    monkeypatch.setattr(dc, "dk_launch_tiling", lambda b, h, *a: (
        min(splits, b * h * 4), *launch_tiling(b, h, *a)[1:]))
    monkeypatch.setattr(dc, "window_tables_on",
                        lambda *a: window_tables_on(*a, dedup=dedup))
    x, _, _, g = _operands(cuda, (2, 9, 40, 16), 24, ksize=ksize)
    run, plain = _dk_pair(ksize)
    geom = dict(skydome=skydome, dilation_rate=dilation)
    assert _rel(run(x, g, **geom), plain(x, g, **geom)) <= 1e-4


def test_dk_tiles_are_the_documented_ones(cuda):
    """The kernel library's plan agrees with the table the CPU test of
    `dk_tiling` (tests/test_torch_dk_tables.py) is written from; every plan
    has a block resident on an SM."""
    import ctypes

    from skyhdr_torch.ops.distortion import window_tables
    from skyhdr_torch.ops.kernels.build import library

    lib = library()
    for (h, w, cp, f, k), want in DK_TILES.items():
        wt = window_tables(h, w, k)
        for bf16 in (0, 1):
            out = (ctypes.c_int * 4)()
            assert lib.skyhdr_da_dk_tiles(w, cp, f, k, wt.taps, wt.span, bf16, 0,
                                          ctypes.addressof(out)) == 0
            tiles, threads, resident, chunks = out
            assert (tiles, threads, chunks) == want and resident >= 1, (h, w, cp, f, k, bf16)


# (h, w, C padded to 4, F, k) -> (blocks per split, threads, column chunks)
# of K3/K6 at every launch shape chip_smoke.py drives or times. The same
# table is in tests/test_torch_dk_tables.py.
DK_TILES = {
    (32, 128, 32, 64, 3): (3, 192, 4),
    (32, 128, 64, 64, 3): (3, 192, 4),
    (16, 64, 64, 128, 3): (6, 192, 2),
    (16, 64, 128, 128, 3): (12, 192, 2),
    (32, 128, 128, 64, 3): (6, 192, 4),
    (64, 256, 64, 32, 3): (3, 192, 8),
    (16, 64, 32, 64, 3): (3, 192, 2),
    (16, 64, 64, 64, 3): (3, 192, 2),
    (8, 32, 64, 128, 3): (6, 192, 1),
    (8, 32, 128, 128, 3): (12, 192, 1),
    (16, 64, 128, 64, 3): (6, 192, 2),
    (32, 128, 64, 32, 3): (3, 192, 4),
    (9, 32, 128, 128, 3): (12, 192, 1),
    (16, 64, 128, 128, 5): (40, 160, 2),
    (16, 64, 128, 128, 7): (112, 224, 2),
    (64, 256, 4, 32, 7): (7, 256, 4),
    (64, 256, 32, 32, 7): (7, 224, 8),
}


def test_odd_k_wrappers_refuse_k3(cuda):
    x, k, b, g = _operands(cuda, (1, 8, 32, 16), 8)
    with pytest.raises(ValueError, match="K5"):
        dc.da_conv_forward_k5(x, k, b, kernel_size=3)
    with pytest.raises(ValueError, match="K6"):
        dc.da_conv_dk_k6(x, g, kernel_size=3)
    with pytest.raises(ValueError, match="K7"):
        dc.da_conv_dx_k7(g, k, x_shape=x.shape, kernel_size=3)


def test_unsupported_width_raises(cuda):
    x, k, b, _ = _operands(cuda, (1, 8, 32, 16), 6)
    with pytest.raises(RuntimeError, match="K1"):
        dc.da_conv_forward_k1(x, k, b)


def _in_operands(cuda, shape, dtype):
    gen = torch.Generator(device=cuda).manual_seed(1)
    c = shape[-1]
    x = (torch.randn(shape, device=cuda, generator=gen) * 2 + 0.3).to(dtype)
    gamma = torch.rand(c, device=cuda, generator=gen) + 0.5
    beta = torch.randn(c, device=cuda, generator=gen) * 0.1
    dy = torch.sin(3 * torch.randn(shape, device=cuda, generator=gen)).to(dtype)
    return x, gamma, beta, dy


@pytest.mark.parametrize("shape", [(2, 16, 64, 32), (3, 8, 32, 64), (2, 4, 16, 128),
                                   (1, 3, 5, 7)])
@pytest.mark.parametrize("alpha", [1.0, 0.0, 0.1])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_k8_k9_match_plain(cuda, shape, alpha, dtype, tol):
    x, gamma, beta, dy = _in_operands(cuda, shape, dtype)
    n8, n9 = tin.K8_LAUNCHES, tin.K9_LAUNCHES
    y, mean, rstd = tin.instance_norm_act_k8(x, gamma, beta, alpha=alpha)
    got = tin.instance_norm_act_bwd_k9(x, dy, gamma, beta, mean, rstd, alpha=alpha)
    again = tin.instance_norm_act_bwd_k9(x, dy, gamma, beta, mean, rstd, alpha=alpha)
    torch.cuda.synchronize()
    assert (tin.K8_LAUNCHES, tin.K9_LAUNCHES) == (n8 + 1, n9 + 2)
    y_ref, mean_ref, rstd_ref = tin.instance_norm_act_ref(x, gamma, beta, alpha=alpha)
    assert y.dtype == dtype and _rel(y, y_ref) <= tol
    assert _rel(mean, mean_ref) <= 1e-5 and _rel(rstd, rstd_ref) <= 1e-5
    want = tin.instance_norm_act_bwd_ref(x, dy, gamma, beta, mean, rstd, alpha=alpha)
    for name, a, b in zip(("dx", "dgamma", "dbeta"), got, want):
        assert _rel(a, b) <= tol, name
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # fixed summation order


def test_k8_variance_of_a_large_mean_channel(cuda):
    """Chan's merge keeps the variance of a channel whose mean dwarfs its
    spread, where E[x^2] - E[x]^2 in float32 would cancel."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = 1000.0 + torch.randn(2, 32, 128, 32, device=cuda, generator=gen) * 0.01
    ones, zeros = torch.ones(32, device=cuda), torch.zeros(32, device=cuda)
    _, _, rstd = tin.instance_norm_act_k8(x, ones, zeros)
    _, _, rstd_ref = tin.instance_norm_act_ref(x, ones, zeros)  # two-pass
    assert _rel(rstd, rstd_ref) <= 1e-3


def test_k9_takes_the_plain_slope_at_a_rounding_tie(cuda):
    """Where xhat*gamma + beta is 0 once the product is rounded but negative
    exactly (a fused multiply-add sees the sign), K9 takes the slope its
    plain version takes: the slope's jump would reach dx, dgamma, dbeta."""
    import numpy as np

    rng = np.random.default_rng(0)
    xs = (1 + rng.integers(1, 2 ** 12, 4096) * 2.0 ** -20).astype(np.float32)
    gs = (1 + rng.integers(1, 2 ** 12, 4096) * 2.0 ** -20).astype(np.float32)
    rounded = xs * gs  # float32 products, rounded to nearest
    up = np.flatnonzero(rounded.astype(np.float64) > xs.astype(np.float64) * gs)[:64]
    assert len(up) == 64
    dev = dict(device=cuda)
    x = torch.tensor(xs[up], **dev).expand(1, 1, 2, 64).contiguous()
    gamma, beta = torch.tensor(gs[up], **dev), torch.tensor(-rounded[up], **dev)
    mean, rstd = torch.zeros(1, 64, **dev), torch.ones(1, 64, **dev)
    dy = torch.ones_like(x)
    got = tin.instance_norm_act_bwd_k9(x, dy, gamma, beta, mean, rstd, alpha=0.1)
    want = tin.instance_norm_act_bwd_ref(x, dy, gamma, beta, mean, rstd, alpha=0.1)
    for a, b in zip(got, want):
        assert _rel(a, b) <= 1e-5


def test_in_function_on_cuda_takes_kernels(cuda):
    x, gamma, beta, dy = _in_operands(cuda, (2, 8, 32, 64), torch.float32)
    for t in (x, gamma, beta):
        t.requires_grad_()
    before = (tin.K8_LAUNCHES, tin.K9_LAUNCHES)
    tin.instance_norm_act(x, gamma, beta, alpha=0.1).backward(dy)
    torch.cuda.synchronize()
    assert (tin.K8_LAUNCHES, tin.K9_LAUNCHES) == (before[0] + 1, before[1] + 1)
    _, mean, rstd = tin.instance_norm_act_ref(x.detach(), gamma.detach(), beta.detach())
    want = tin.instance_norm_act_bwd_ref(x.detach(), dy, gamma.detach(), beta.detach(),
                                         mean, rstd, alpha=0.1)
    for a, b in zip((x.grad, gamma.grad, beta.grad), want):
        assert _rel(a, b) <= 1e-5


def _in_check(x, dy, gamma, beta, alpha, tol):
    """K8 then K9 on (x, dy) against their plain versions; K8 and K9 twice
    give the same bits."""
    y, mean, rstd = tin.instance_norm_act_k8(x, gamma, beta, alpha=alpha)
    fwd_again = tin.instance_norm_act_k8(x, gamma, beta, alpha=alpha)
    got = tin.instance_norm_act_bwd_k9(x, dy, gamma, beta, mean, rstd, alpha=alpha)
    again = tin.instance_norm_act_bwd_k9(x, dy, gamma, beta, mean, rstd, alpha=alpha)
    torch.cuda.synchronize()
    y_ref, mean_ref, rstd_ref = tin.instance_norm_act_ref(x, gamma, beta, alpha=alpha)
    assert y.dtype == x.dtype and _rel(y, y_ref) <= tol
    assert _rel(mean, mean_ref) <= 1e-5 and _rel(rstd, rstd_ref) <= 1e-5
    want = tin.instance_norm_act_bwd_ref(x, dy, gamma, beta, mean, rstd, alpha=alpha)
    for name, a, b in zip(("dx", "dgamma", "dbeta"), got, want):
        assert _rel(a, b) <= tol, name
    assert all(torch.equal(a, b) for a, b in zip((y, mean, rstd), fwd_again))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def _in_plan(b, hw, c, elem, tensors, cluster, groups, holds=True, vec=None):
    """An `in_tiling` plan with the split given (vec: 16 bytes unless 1),
    held where its share fits."""
    vec = vec or 16 // elem
    threads = tin._threads(-(-hw // cluster), c // groups // vec, vec, tensors)
    rows = threads // (c // groups // vec)

    def smem(h):
        return tin.in_smem_bytes(hw, c, elem, tensors, cluster, groups, threads, vec, h)

    holds = holds and smem(True) <= tin.IN_SMEM
    return tin.InTiling(cluster, groups, threads, -(-(-(-hw // cluster)) // rows), holds, vec,
                        smem(holds))


# K8/K9 at every cluster size and channel-group split `in_tiling` can pick,
# held and read again, with 16-byte vectors and one element a thread.
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("groups,holds,vec", [(1, True, None), (2, True, None),
                                              (4, True, None), (1, False, None),
                                              (2, True, 1)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_k8_k9_at_each_plan(cuda, monkeypatch, cluster, groups, holds, vec, dtype, tol):
    shape = (3, 16, 64, 32)
    if dtype == torch.bfloat16 and groups == 4:
        groups = 2  # a bf16 group of 8 channels would be a 16-byte run
    x, gamma, beta, dy = _in_operands(cuda, shape, dtype)
    elem = x.element_size()
    monkeypatch.setattr(tin, "in_tiling", lambda b, hw, c, e, sms, tensors=1, aligned=True:
                        _in_plan(b, hw, c, elem, tensors, cluster, groups, holds, vec))
    _in_check(x, dy, gamma, beta, 0.1, tol)


# The plans `in_tiling` picks at the model's shapes and batches (b64: the
# fewest splits; b1, b2: the most) and at shapes off the model: one element
# a thread (C = 3, 7, 1021, or a pointer off 16 bytes), C = 1024, a batch of
# many clusters (the ticket counter), and a share too large to hold.
@pytest.mark.parametrize("shape", [(64, 16, 64, 128), (64, 32, 128, 64), (2, 64, 256, 32),
                                   (1, 8, 32, 128), (1, 5, 7, 3), (2, 3, 4, 1021),
                                   (2, 2, 3, 1024), (300, 4, 8, 16), (1, 512, 256, 8),
                                   (2, 3, 5, 7)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_k8_k9_at_picked_plans(cuda, shape, dtype, tol):
    x, gamma, beta, dy = _in_operands(cuda, shape, dtype)
    b, h, w, c = shape
    plan = tin.in_tiling(b, h * w, c, x.element_size(), tin._sm_count(x.device.index), 1)
    if shape == (1, 512, 256, 8) and dtype == torch.float32:
        assert not plan.holds
    _in_check(x, dy, gamma, beta, 0.1, tol)


def test_k8_k9_misaligned_rows(cuda):
    """x and dy 4 bytes off a 16-byte boundary: the plan takes one element
    a thread."""
    x, gamma, beta, dy = _in_operands(cuda, (2, 8, 32, 64), torch.float32)
    xs = torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape)
    dys = torch.empty(dy.numel() + 1, device=cuda)[1:].view(dy.shape)
    xs.copy_(x)
    dys.copy_(dy)
    assert xs.data_ptr() % 16 and xs.is_contiguous()
    _in_check(xs, dys, gamma, beta, 0.0, 1e-5)


# K10 shapes: (x shape, F, rblk, mblk); the sum modes need C >= F.
PROBE_SHAPES = [((2, 8, 32, 64), 64, 2, 1), ((2, 4, 16, 128), 128, 4, 1),
                ((1, 8, 40, 32), 32, 8, 1)]


@pytest.mark.parametrize("name", sorted(tp.PROBES))
@pytest.mark.parametrize("shape,f,rblk,mblk", PROBE_SHAPES)
def test_k10_matches_plain(cuda, name, shape, f, rblk, mblk):
    p = tp.PROBES[name]
    x, k, _, _ = _operands(cuda, shape, f)
    if p.dedup:
        mblk = rblk
    n = tp.K10_LAUNCHES
    got = tp.da_probe_k10(x, k, name, rblk=rblk, mblk=mblk)
    torch.cuda.synchronize()
    assert tp.K10_LAUNCHES == n + 1 and got.dtype == torch.float32
    # f32 FMA and bf16 storage: the same sums in another order; tensor
    # cores: another accumulation order, and bf16 ties of the samples.
    assert _rel(got, tp.da_probe_ref(x, k, name)) <= (2e-3 if p.mma else 1e-4)


# More K10 shapes: every rblk of 1, 2, 4, 8, 16 with the ones above, C/F
# 32/32, 64/64 and 128/128, and widths that leave a ragged column tile (36:
# a direct block of 32 columns and 4; 38: 2 of a lane's 4 columns; 200: a
# staged tile of 128 and 72; 44).
K10_CASES = [((1, 16, 36, 32), 32, 1), ((1, 16, 38, 64), 64, 16),
             ((1, 8, 200, 128), 128, 8), ((2, 8, 44, 64), 64, 4)]


@pytest.mark.parametrize("name", sorted(tp.PROBES))
@pytest.mark.parametrize("shape,f,rblk", K10_CASES)
def test_k10_tiles_rows_and_ragged_columns(cuda, name, shape, f, rblk):
    p = tp.PROBES[name]
    x, k, _, _ = _operands(cuda, shape, f)
    n = tp.K10_LAUNCHES
    got = tp.da_probe_k10(x, k, name, rblk=rblk, mblk=rblk if p.dedup else 1)
    torch.cuda.synchronize()
    assert tp.K10_LAUNCHES == n + 1 and got.shape == shape[:3] + (f,)
    assert _rel(got, tp.da_probe_ref(x, k, name)) <= (2e-3 if p.mma else 1e-4)


@pytest.mark.parametrize("name", sorted(tp.PROBES))
def test_k10_is_bitwise_repeatable_and_one_kernel(cuda, name):
    """Two calls give the same bits, and a call on x in the probe's storage
    type runs one device kernel (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    p = tp.PROBES[name]
    x, k, _, _ = _operands(cuda, (2, 8, 44, 64), 64)
    x = x.to(p.store)
    a = tp.da_probe_k10(x, k, name, rblk=4, mblk=4 if p.dedup else 1)
    b = tp.da_probe_k10(x, k, name, rblk=4, mblk=4 if p.dedup else 1)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        tp.da_probe_k10(x, k, name, rblk=4, mblk=4 if p.dedup else 1)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
               and getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)) > 0]
    assert sum(e.count for e in kernels) == 1, [(e.key, e.count) for e in kernels]


def test_k10_refuses_what_it_does_not_tile(cuda):
    x, k, _, _ = _operands(cuda, (2, 8, 32, 16), 32)
    with pytest.raises(ValueError):
        tp.da_probe_k10(x, k, "c", rblk=3)
    with pytest.raises(ValueError):
        tp.da_probe_k10(x, k, "nomm")  # the sum modes need C >= F


@pytest.mark.parametrize("shape,p", [((4, 8, 32, 16), 2), ((8, 4, 16, 32), 4),
                                     ((2, 16, 64, 64), 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k11_matches_plain_bitwise(cuda, shape, p, dtype):
    x = torch.randn(shape, device=cuda).to(dtype)
    n = tp.K11_LAUNCHES
    got = tp.pack_samples_k11(x, p)
    torch.cuda.synchronize()
    assert tp.K11_LAUNCHES == n + 1
    assert torch.equal(got, tp.pack_samples_ref(x, p))


@pytest.mark.parametrize("cfg", ["a18", "b9", "c3", "d2", "t18", "tb9"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k12_matches_plain(cuda, cfg, dtype):
    from skyhdr_torch.tools.exp_mmshape import CFGS

    m, k, f, ndots, _ = CFGS[cfg]
    x = torch.randn(600, 600, device=cuda)
    lhs, rhs = x[:m, :k].to(dtype).contiguous(), x[:k, :f].to(dtype).contiguous()
    n = tp.K12_LAUNCHES
    got = tp.mm_shape_k12(lhs, rhs, ndots=ndots, steps=4)
    torch.cuda.synchronize()
    assert tp.K12_LAUNCHES == n + 1
    assert _rel(got, tp.mm_shape_ref(lhs, rhs, ndots=ndots, steps=1)) <= 1e-5


def test_k12_pads_an_odd_shape(cuda):
    x = torch.randn(40, 40, device=cuda)
    for dtype in (torch.float32, torch.bfloat16):
        lhs, rhs = x[:13, :7].to(dtype), x[:7, :5].to(dtype)
        got = tp.mm_shape_k12(lhs, rhs, ndots=3, steps=2)
        torch.cuda.synchronize()
        assert _rel(got, tp.mm_shape_ref(lhs, rhs, ndots=3, steps=1)) <= 1e-5


# Shapes `mm_tiling` pads, one block tile of each kind and several output
# tiles a block (300 x 70: 3 of 128 x 128; 40 x 300: 2 of 64 x 256), with
# one dot and with three.
@pytest.mark.parametrize("m,k,f", [(13, 7, 5), (300, 100, 70), (40, 600, 300), (256, 64, 64)])
@pytest.mark.parametrize("ndots", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k12_pads_and_takes_one_dot(cuda, m, k, f, ndots, dtype):
    x = torch.randn(600, 600, device=cuda)
    lhs, rhs = x[:m, :k].to(dtype), x[:k, :f].to(dtype)
    got = tp.mm_shape_k12(lhs, rhs, ndots=ndots, steps=3)
    torch.cuda.synchronize()
    assert got.shape == (m, f)
    assert _rel(got, tp.mm_shape_ref(lhs, rhs, ndots=ndots, steps=1)) <= 1e-5


# --- K13: the optimizer update as one pass -----------------------------------

K13_SHAPES = [(7,), (3, 5), (64, 33), (128, 3, 3, 64), (1000003,), (1,)]
# (opt_state_dtype, grad dtype, param_dtype, moments loaded as float32)
K13_CASES = {
    "f32": ("float32", "float32", "float32", False),
    "bf16_moments": ("bfloat16", "float32", "float32", False),
    "bf16_grads": ("float32", "bfloat16", "float32", False),
    "bf16_moments_grads": ("bfloat16", "bfloat16", "float32", False),
    "master": ("float32", "float32", "bfloat16", False),
    "bf16_everything": ("bfloat16", "bfloat16", "bfloat16", False),
    "f32_moments_into_bf16": ("bfloat16", "float32", "float32", True),
}


def _k13_pair(cuda, kind, case, unaligned=False):
    """Two optimizers of `kind` on the card in the same state under `case`
    (moments drawn 10^U(-3, 3)); `unaligned`: every parameter a view one
    element into a larger buffer (K13's one-element path)."""
    from skyhdr_torch.train import optim

    opt_dtype, _, param_dtype, loaded = K13_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(4)
    p32 = [torch.randn(s, device=cuda, generator=gen) for s in K13_SHAPES]
    cls = optim.Adam if kind == "adam" else optim.RMSprop
    held = {n: [10.0 ** (torch.rand(s, device=cuda, generator=gen) * 6 - 3)
                * (torch.randn(s, device=cuda, generator=gen) if n == "mu" else 1.0)
                for s in K13_SHAPES] for n in cls.MOMENTS}
    saved = torch.float32 if loaded else optim.storage_dtype(opt_dtype)
    opts = []
    for _ in range(2):
        params = []
        for p in p32:
            p = p.to(optim.storage_dtype(param_dtype))
            if unaligned:
                buf = torch.empty(p.numel() + 1, dtype=p.dtype, device=cuda)
                buf[1:].copy_(p.view(-1))
                p = buf[1:].view(p.shape)
            params.append(p)
        opt = cls(params, 2e-4, opt_state_dtype=opt_dtype, param_dtype=param_dtype)
        state = {n: [t.to(saved) for t in held[n]] for n in cls.MOMENTS}
        if opt.master is not None:
            state["master"] = [p.clone() for p in p32]
        opt.load_moments({**state, "count": 2} if kind == "adam" else state)
        opts.append(opt)
    return opts


def _k13_grads(cuda, seed, dtype):
    gen = torch.Generator(device=cuda).manual_seed(seed)
    out = []
    for s in K13_SHAPES:
        g = torch.randn(s, device=cuda, generator=gen)
        g = g * 10.0 ** (torch.rand(s, device=cuda, generator=gen) * 6 - 4)
        out.append(g.masked_fill(torch.rand(s, device=cuda, generator=gen) < 0.05, 0.0)
                   .to(getattr(torch, dtype)))
    return out


def _k13_gaps(a, b):
    """Per member the number of elements whose bits differ."""
    out = {}
    names = ("params", *a.MOMENTS) + (("master",) if a.master is not None else ())
    for name in names:
        for x, y in zip(getattr(a, name), getattr(b, name)):
            assert x.dtype == y.dtype, name
            ints = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
            out[name] = out.get(name, 0) + int((x.contiguous().view(ints)
                                                != y.contiguous().view(ints)).sum())
    return out


@pytest.mark.parametrize("unaligned", [False, True])
@pytest.mark.parametrize("case", sorted(K13_CASES))
@pytest.mark.parametrize("kind", ["rmsprop", "adam"])
def test_k13_is_the_eager_chain_bit_for_bit(cuda, kind, case, unaligned):
    """Three steps of K13 (`step`) and of the eager chain (`step_plain`) on
    the card from the same state: the same bits in every parameter, moment
    and master; one launch a leaf."""
    from skyhdr_torch.ops.kernels import optim as ok

    kernel, chain = _k13_pair(cuda, kind, case, unaligned)
    n = ok.K13_LAUNCHES
    for step in range(3):
        grads = _k13_grads(cuda, 10 + step, K13_CASES[case][1])
        kernel.step(grads)
        chain.step_plain(grads)
        torch.cuda.synchronize()
        gaps = _k13_gaps(kernel, chain)
        assert not any(gaps.values()), (step, gaps)
    assert ok.K13_LAUNCHES == n + 3 * len(K13_SHAPES)


@pytest.mark.parametrize("case", ["f32", "bf16_moments_grads", "master"])
@pytest.mark.parametrize("kind", ["rmsprop", "adam"])
def test_k13_is_its_formula_bit_for_bit(cuda, kind, case):
    """K13 against `optim_step_ref` (its per-element formula in torch) on
    the card, one step."""
    from skyhdr_torch.ops.kernels import optim as ok

    kernel, ref = _k13_pair(cuda, kind, case)
    grads = _k13_grads(cuda, 20, K13_CASES[case][1])
    kernel.step(grads)
    ref._begin()
    for i, (p, g) in enumerate(zip(ref.params, grads)):
        master = None if ref.master is None else ref.master[i].view(-1)
        mu = ref.mu[i].view(-1) if kind == "adam" else None
        ok.optim_step_ref(kind == "adam", p.view(-1), g.reshape(-1), mu, ref.nu[i].view(-1),
                          master, ref._consts(g.dtype if master is None else torch.float32))
    torch.cuda.synchronize()
    gaps = _k13_gaps(kernel, ref)
    assert not any(gaps.values()), gaps


def test_k13_refuses_a_non_contiguous_leaf(cuda):
    from skyhdr_torch.train import optim

    opt = optim.Adam([torch.zeros(4, 6, device=cuda)], 2e-4)
    opt.nu[0] = torch.zeros(6, 4, device=cuda).t()
    with pytest.raises(ValueError, match="contiguous"):
        opt.step([torch.ones(4, 6, device=cuda)])
