"""The host side of the DA forward kernels K1/K5: the grouped window
tables (`ops/distortion.py:window_tables`) are held to `gather_tables` and
to `skyhdr`'s own dedup check; the kernels' order of work, emulated in
torch (one y-interpolated window per output row and group, each tap
x-interpolated from it, per block of rows and tile of columns), to the
plain forward (1e-5 of its max: the same f32 sums in another order) and
to `skyhdr.ops.distortion.deformable_conv2d` (1e-4); and the rule that
picks a block's output rows fills the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import skyhdr.ops.distortion as jdist
import skyhdr_torch.ops.distortion as tdist
from skyhdr.ops.pallas.deform_conv import _dedup_valid
from skyhdr_torch.ops.kernels import deform_conv as dc

# The suite runs in several worker processes that share the CPU; torch's
# default of one thread per core in each of them oversubscribes it.
torch.set_num_threads(1)

GEOMETRY = [(True, 1), (False, 2)]  # (skydome, dilation)


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("h,w", [(8, 32), (9, 32), (16, 64), (64, 256)])
@pytest.mark.parametrize("skydome,dilation", GEOMETRY)
def test_window_rows_are_the_gather_rows(k, h, w, skydome, dilation):
    """Each kernel row's taps read one pair of source rows with one weight
    (as `skyhdr`'s `_dedup_valid` says at k=3), so the tables hold one group
    per kernel row: the kx = 0 columns of `gather_tables`."""
    gt = tdist.gather_tables(h, w, k, 1, dilation, skydome)
    wt = tdist.window_tables(h, w, k, dilation, skydome)
    if k == 3:
        assert _dedup_valid(jdist.gather_tables(h, w, 3, 1, dilation, skydome))
    assert wt.taps == k and wt.pad == gt.pad
    for got, full in ((wt.y0, gt.y0), (wt.y1, gt.y1), (wt.wy, gt.wy)):
        rows = full.reshape(h, k, k)
        assert got.dtype == full.dtype and np.array_equal(got, rows[:, :, 0])
        assert np.array_equal(rows, np.broadcast_to(got[:, :, None], rows.shape))
    assert np.array_equal(wt.wx, gt.wx)


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("h,w", [(9, 32), (16, 64), (64, 256)])
@pytest.mark.parametrize("skydome,dilation", GEOMETRY)
@pytest.mark.parametrize("dedup", [True, False])
def test_window_span_covers_every_tap(k, h, w, skydome, dilation, dedup):
    """Every tap's column shift is its group's window start plus its
    offset, the offset within [0, span], span the widest group; per-tap
    groups have span 0."""
    gt = tdist.gather_tables(h, w, k, 1, dilation, skydome)
    wt = tdist.window_tables(h, w, k, dilation, skydome, dedup)
    n = wt.taps
    assert n == (k if dedup else 1) and wt.base.shape == (h, k * k // n)
    assert wt.d.min() >= 0 and wt.d.max() == wt.span <= tdist.WINDOW_SPAN_MAX
    assert np.array_equal((np.repeat(wt.base, n, axis=1) + wt.d) % w, gt.cx0)
    if not dedup:
        assert wt.span == 0
        assert np.array_equal(wt.y0, gt.y0) and np.array_equal(wt.wy, gt.wy)


def test_window_wider_than_the_cap_takes_one_group_a_tap(monkeypatch):
    """A kernel row whose taps span more than WINDOW_SPAN_MAX columns would
    widen every window of the shape: the tables fall back to one group a
    tap (the same kernel, other tables)."""
    monkeypatch.setattr(tdist, "WINDOW_SPAN_MAX", 4)
    wt = tdist.window_tables.__wrapped__(16, 64, 3)  # spans up to 5 there
    assert wt.taps == 1 and wt.span == 0
    assert np.array_equal(wt.base, tdist.gather_tables(16, 64, 3).cx0)


def test_window_tables_on_device_pack_the_tables():
    wt = tdist.window_tables(9, 32, 5)
    rows, taps, n, span = tdist.window_tables_on(torch.device("cpu"), 9, 32, 5)
    assert (n, span) == (wt.taps, wt.span) and rows.dtype == taps.dtype == torch.int32
    rows, taps = rows.numpy(), taps.numpy()
    assert np.array_equal(rows[..., 0], wt.y0 - wt.pad)
    assert np.array_equal(rows[..., 1], wt.y1 - wt.pad)
    assert np.array_equal(rows[..., 2], wt.base)
    assert np.array_equal(rows[..., 3].view(np.float32), wt.wy)
    assert np.array_equal(taps[..., 0], wt.d)
    assert np.array_equal(taps[..., 1].view(np.float32), wt.wx)


def _window_emulation(x, kernel, bias, k, rows, tw, dilation, skydome, dedup):
    """K1/K5's order of work in torch: per block of `rows` output rows and
    tile of tw columns, per output row and group, the window of
    tw + span + 1 columns y-interpolated once (rows outside [0, h) read
    zero), then each tap of the group x-interpolated from it at its
    offset and multiplied by K_t."""
    b, h, w, c = x.shape
    wt = tdist.window_tables(h, w, k, dilation, skydome, dedup)
    n, wn = wt.taps, tw + wt.span + 1
    kt = kernel.reshape(k * k, c, -1)
    out = torch.full((b, h, w, kt.shape[-1]), float("nan"))

    def source(row, cols):
        row = int(row) - wt.pad
        return x[:, row, cols] if 0 <= row < h else torch.zeros(b, len(cols), c)

    for i0 in range(0, h, rows):
        for j0 in range(0, w, tw):
            for i in range(i0, min(i0 + rows, h)):
                acc = torch.zeros(b, tw, kt.shape[-1])
                for g in range(k * k // n):
                    cols = (j0 + int(wt.base[i, g]) + torch.arange(wn)) % w
                    wy = float(wt.wy[i, g])
                    win = (1 - wy) * source(wt.y0[i, g], cols) + wy * source(wt.y1[i, g], cols)
                    for t in range(g * n, g * n + n):
                        d, wx = int(wt.d[i, t]), float(wt.wx[i, t])
                        sample = (1 - wx) * win[:, d:d + tw] + wx * win[:, d + 1:d + tw + 1]
                        acc = acc + sample @ kt[t]
                out[:, i, j0:j0 + tw] = (acc + bias)[:, :w - j0]
    return out


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("rows,tw", [(1, 16), (2, 8), (3, 16)])
@pytest.mark.parametrize("skydome,dilation", GEOMETRY)
@pytest.mark.parametrize("dedup", [True, False])
def test_window_algorithm_matches_the_reference_forward(k, rows, tw, skydome, dilation,
                                                       dedup):
    """The emulated kernel order at an odd height and a width that is no
    multiple of the column tile gives the plain forward to 1e-5 of its max
    and `skyhdr`'s XLA gather form to 1e-4."""
    shape, f = (2, 9, 24, 5), 6
    rng = np.random.default_rng(k * 100 + rows * 10 + dedup)
    x = rng.normal(size=shape).astype(np.float32)
    kernel = (rng.normal(size=(k * k * shape[-1], f)) * 0.1).astype(np.float32)
    bias = rng.normal(size=(f,)).astype(np.float32)
    geom = dict(dilation_rate=dilation, skydome=skydome)
    got = _window_emulation(torch.from_numpy(x), torch.from_numpy(kernel),
                            torch.from_numpy(bias), k, rows, tw, dilation, skydome, dedup)
    assert not torch.isnan(got).any()
    want = dc.da_conv_forward_ref(torch.from_numpy(x), torch.from_numpy(kernel),
                                  torch.from_numpy(bias), kernel_size=k, **geom)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    oracle = np.asarray(jdist.deformable_conv2d(jnp.asarray(x), jnp.asarray(kernel),
                                                jnp.asarray(bias), kernel_size=k, **geom))
    assert np.abs(got.numpy() - oracle).max() <= 1e-4 * np.abs(oracle).max()


# Blocks per (image, row group) of K1/K5 at the model's (W, F), by (rows,
# chans), as the kernel library's `skyhdr_da_fwd_tiles` gives them (a card
# test in tests/test_torch_gpu.py holds it to the same table); -1 where
# that does not tile: 8-channel tiles only for full 256-thread blocks of
# 128 outputs x 128 channels, 4-channel tiles up to 128 outputs.
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


@pytest.mark.parametrize("b,h,wf,want", [
    (64, 16, (64, 128), (2, 8)),   # 64x256 b64 trunk: 512 blocks of 8x8 tiles
    (32, 16, (64, 128), (2, 8)),   # 64x256 b32 trunk: 256
    (32, 8, (32, 128), (1, 4)),    # 32x128 b32 trunk: 8x8 tiles give 64, 4x4 256
    (32, 32, (128, 64), (1, 4)),   # conv3_f/u at 64x256: one 128-column row
    (32, 64, (256, 32), (1, 4)),   # conv2_f/u: 4,096
    (1, 8, (32, 128), (1, 4)),     # b1: nothing fills, one row of 4-channel tiles
])
def test_fwd_tiling_fills_the_card(b, h, wf, want):
    """K1/K5 take the widest register tile, then the most output rows a
    block holds, whose grid still gives 132 SMs 1.5 blocks each, and one
    row of 4-channel tiles when nothing fills."""
    assert dc.fwd_tiling(b, h, FWD_TILES[wf], 132) == want
