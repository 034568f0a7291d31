"""The host side of the DA weight-gradient kernels K3/K6: the tiling every
layer shape the model drives is given (a full block; `dk_tiling`'s splits
fill the card), and the kernels' order of work, emulated in torch (per
window group and chunk of channels, one y-interpolated window per (b, i)
row and column chunk, each tap x-interpolated from it, the chunk's columns
split over slices summed in slice order, the stages split over splits
summed in split order), against the plain weight gradient (1e-5 of its max:
the same f32 sums in another order)."""

import numpy as np
import pytest
import torch

import skyhdr_torch.ops.distortion as tdist
from skyhdr_torch.ops.kernels import deform_conv as dc

# The suite runs in several worker processes that share the CPU; torch's
# default of one thread per core in each of them oversubscribes it.
torch.set_num_threads(1)

GEOMETRY = [(True, 1), (False, 2)]  # (skydome, dilation)


def plan_dk(w, cp, f, k, taps, span, elem=4):
    """csrc/deform_conv.cu:plan_dk in Python: (blocks per split, threads a
    block, column chunks a row). The kernel library is the one the wrappers
    ask (`skyhdr_da_dk_tiles`); a card test holds it to DK_TILES below."""
    def r8(n):
        return -(-n // 8) * 8

    ft = 128
    while f % ft:
        ft //= 2

    def tile(chans, limit):
        cols = ft // chans
        cc = 128
        while cc >= 4 and (cp % cc or r8(taps * cc) // 8 * cols > limit):
            cc //= 2
        mp = r8(taps * cc)
        slices = 8
        while slices > 1 and mp // 8 * cols * slices > limit:
            slices //= 2
        return cc, mp, cols, slices

    # 8 x 8 tiles in blocks of at most 192 threads (K3) or 160 (K6) where
    # that gives at least 160 threads, else 8 x 4 tiles in up to 256.
    cc, mp, cols, slices = tile(8, 192 if k == 3 else 160)
    if ft < 64 or mp // 8 * cols * slices < 160:
        cc, mp, cols, slices = tile(4, 256)

    def smem(tw):
        wn = tw + span + 1
        stage = 4 * 2 * wn * cc + 4 * tw * mp + -(-elem * 2 * wn * cc // 16) * 16 + 4 * 2 * tw * ft
        return max(stage, 4 * (slices - 1) * mp * ft)

    tw = min(64, r8(w))
    if tw > 32 and smem(tw) > 64 * 1024:
        tw = 32
    return (k * k // taps) * (cp // cc) * (f // ft), mp // 8 * cols * slices, -(-w // tw)


# Every K3/K6 launch shape that chip_smoke.py drives or times, (b, h, w, c,
# f, k): the GAN step's k=3 layers at 64x256 b64 and at 32x128 b32, the sun
# step's at 64x256 b32, the odd height, the k=5 trunk, and the k=7 layers
# (sunlayer1.conv1 with C=3).
K3_LAYERS = [((32, 128, 32), 64), ((32, 128, 64), 64), ((16, 64, 64), 128),
             ((16, 64, 128), 128), ((32, 128, 128), 64), ((64, 256, 64), 32)]
DRIVEN = ([(64, h, w, c, f, 3) for (h, w, c), f in K3_LAYERS]
          + [(32, h // 2, w // 2, c, f, 3) for (h, w, c), f in K3_LAYERS]
          + [(32, h, w, c, f, 3) for (h, w, c), f in K3_LAYERS[:4]]
          + [(32, 9, 32, 128, 128, 3), (64, 16, 64, 128, 128, 5),
             (32, 16, 64, 128, 128, 7), (32, 64, 256, 3, 32, 7), (32, 64, 256, 32, 32, 7)])

# (h, w, C padded to 4, F, k) -> (blocks per split, threads, column chunks)
# of the kernel library's plan at the window tables' span; the same table
# is in tests/test_torch_gpu.py.
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


def _key(h, w, c, f, k):
    return h, w, -(-c // 4) * 4, f, k


def test_the_table_is_the_plan_at_every_driven_shape():
    assert {_key(*s[1:]) for s in DRIVEN} == set(DK_TILES)
    for (h, w, cp, f, k), want in DK_TILES.items():
        wt = tdist.window_tables(h, w, k)
        assert plan_dk(w, cp, f, k, wt.taps, wt.span) == want, (h, w, cp, f, k)


@pytest.mark.parametrize("b,h,w,c,f,k", DRIVEN)
@pytest.mark.parametrize("resident", [1, 2, 3])
def test_dk_tiling_gives_full_blocks_that_fill_the_card(b, h, w, c, f, k, resident):
    """Every driven shape gets a block of at least 160 threads (5 warps;
    the first kernel gave 8 threads at C=3, k=7), and splits whose grid
    fills 95% of the waves of `resident` blocks on 132 SMs it takes, with
    no split left empty."""
    tiles, threads, chunks = DK_TILES[_key(h, w, c, f, k)]
    assert 160 <= threads <= 256
    stages = b * h * chunks
    n = dc.dk_tiling(stages, tiles, resident, 132)
    slots = 132 * resident
    blocks = tiles * n
    assert 1 <= n <= stages
    assert blocks / (-(-blocks // slots) * slots) >= dc.DK_FILL


def test_dk_tiling_takes_the_fewest_splits():
    assert dc.dk_tiling(2048, 12, 2, 132) == 21        # 252 blocks of 264 slots
    assert dc.dk_tiling(2048, 12, 1, 132) == 11        # all 132
    assert dc.dk_tiling(2048, 56, 2, 132) == 9         # 504 of 528 (2 waves)
    assert dc.dk_tiling(10_000, 600, 2, 132) == 3      # 1800 of 1848 (7 waves)
    assert dc.dk_tiling(3, 12, 2, 132) == 3            # no more splits than stages


def _dk_emulation(x, g, k, dilation, skydome, dedup, cc, tw, slices, nsplit):
    """K3/K6's order of work in torch: per split (a run of the
    b*h*chunks stages), per window group and chunk of cc channels, per
    stage ((b, i) row, tw columns) the group's window of tw + span + 1
    columns y-interpolated once (rows outside [0, h) read zero), each tap's
    samples x-interpolated from it at its offset, and their outer products
    with the stage's cotangents (zero past w) summed by slices of the
    columns; slices summed in slice order, splits in split order."""
    b, h, w, c = x.shape
    f = g.shape[-1]
    wt = tdist.window_tables(h, w, k, dilation, skydome, dedup)
    n, wn, chunks = wt.taps, tw + wt.span + 1, -(-w // tw)
    total, sw = b * h * chunks, tw // slices

    def source(bi, row, cols, c0):
        row = int(row) - wt.pad
        return x[bi, row, cols, c0:c0 + cc] if 0 <= row < h else torch.zeros(wn, cc)

    out = None
    for split in range(nsplit):
        part = torch.zeros(k * k, c, f)
        for grp in range(k * k // n):
            for c0 in range(0, c, cc):
                acc = [torch.zeros(n * cc, f) for _ in range(slices)]
                for s in range(split * total // nsplit, (split + 1) * total // nsplit):
                    r, j0 = s // chunks, s % chunks * tw
                    bi, i = divmod(r, h)
                    cols = (j0 + int(wt.base[i, grp]) + torch.arange(wn)) % w
                    wy = float(wt.wy[i, grp])
                    win = ((1 - wy) * source(bi, wt.y0[i, grp], cols, c0)
                           + wy * source(bi, wt.y1[i, grp], cols, c0))
                    taps = []
                    for t in range(grp * n, grp * n + n):
                        d, wx = int(wt.d[i, t]), float(wt.wx[i, t])
                        taps.append((1 - wx) * win[d:d + tw] + wx * win[d + 1:d + tw + 1])
                    stile = torch.cat(taps, 1)  # [tw, n * cc]
                    gt = torch.zeros(tw, f)
                    gt[:min(tw, w - j0)] = g[bi, i, j0:j0 + tw]
                    for sl in range(slices):
                        cols_ = slice(sl * sw, sl * sw + sw)
                        acc[sl] = acc[sl] + stile[cols_].T @ gt[cols_]
                tile = acc[0]
                for a in acc[1:]:
                    tile = tile + a
                part[grp * n:grp * n + n, c0:c0 + cc] = tile.reshape(n, cc, f)
        out = part if out is None else out + part
    return out.reshape(k * k * c, f)


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("cc,tw,slices,nsplit", [(4, 8, 2, 3), (8, 16, 1, 1)])
@pytest.mark.parametrize("skydome,dilation", GEOMETRY)
@pytest.mark.parametrize("dedup", [True, False])
def test_window_algorithm_matches_the_reference_dk(k, cc, tw, slices, nsplit, skydome,
                                                    dilation, dedup):
    """The emulated kernel order at an odd height and a width that is no
    multiple of the column chunk gives the plain weight gradient to 1e-5
    of its max, with the rows shared by a kernel row's taps (dedup) and
    with one group a tap."""
    shape, f = (2, 9, 24, 8), 6
    rng = np.random.default_rng(k * 100 + tw * 10 + dedup)
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    g = torch.from_numpy(rng.normal(size=shape[:3] + (f,)).astype(np.float32))
    got = _dk_emulation(x, g, k, dilation, skydome, dedup, cc, tw, slices, nsplit)
    want = dc.da_conv_dk_ref(x, g, kernel_size=k, dilation_rate=dilation, skydome=skydome)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
