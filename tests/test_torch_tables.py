"""The port's copies of NumPy-only code equal the originals: the DA table
functions and the configuration tree. The port's own strip tables (the pair
lists of the input-gradient kernels K2/K7) are held to the scatter
references and slots, and the kernels' walk over them, emulated in torch,
to the plain dx (1e-5 of its max: the same sums in another order)."""

import dataclasses

import numpy as np
import pytest
import torch

import skyhdr.config as jcfg
import skyhdr.ops.distortion as jdist
import skyhdr_torch.config as tcfg
import skyhdr_torch.ops.distortion as tdist

SHAPES = [(8, 32), (16, 64), (32, 128)]


def _assert_tuple_equal(got, want):
    assert type(got).__name__ == type(want).__name__
    assert got._fields == want._fields
    for name, a, b in zip(want._fields, got, want):
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype, name
            assert np.array_equal(a, b), name
        else:
            assert a == b, name


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("dilation,skydome", [(1, True), (2, False)])
def test_distortion_offsets_equal(h, w, dilation, skydome):
    got = tdist.distortion_offsets(h, w, 3, dilation, skydome)
    want = jdist.distortion_offsets(h, w, 3, dilation, skydome)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("k", [3, 5])
def test_gather_tables_equal(h, w, k):
    _assert_tuple_equal(tdist.gather_tables(h, w, k),
                        jdist.gather_tables(h, w, k))


@pytest.mark.parametrize("h,w", SHAPES)
def test_scatter_tables_k3_equal(h, w):
    _assert_tuple_equal(tdist.scatter_tables_k3(h, w),
                        jdist.scatter_tables_k3(h, w))


def test_device_tables_match_numpy():
    t = tdist.gather_tables(16, 64)
    got = tdist.gather_tables_on(torch.device("cpu"), 16, 64)
    for a, b in zip(got, (t.y0, t.y1, t.cx0, t.wy, t.wx)):
        assert np.array_equal(a.numpy(), b)
    st = tdist.scatter_tables_k3(16, 64)
    got, nslots = tdist.scatter_tables_k3_on(torch.device("cpu"), 16, 64)
    assert nslots == st.nslots
    for a, b in zip(got, (st.si, st.sw, st.sky, st.scx, st.swx)):
        assert np.array_equal(a.numpy(), b)
    st = tdist.strip_tables(16, 64, 5, 4)
    got = tdist.strip_tables_on(torch.device("cpu"), 16, 64, 5, 4)
    for a, b in zip(got, (st.pint, st.pflt, st.start)):
        assert a.dtype == torch.from_numpy(b).dtype and np.array_equal(a.numpy(), b)


def _fields(cls):
    out = {}
    for f in dataclasses.fields(cls):
        default = (f.default_factory() if f.default is dataclasses.MISSING
                   else f.default)
        out[f.name] = (str(f.type), default if not dataclasses.is_dataclass(
            default) else type(default).__name__)
    return out


@pytest.mark.parametrize("name", ["ModelConfig", "DataConfig", "TrainConfig",
                                  "MeshConfig", "Config"])
def test_config_copy_equals_original(name):
    assert _fields(getattr(tcfg, name)) == _fields(getattr(jcfg, name))


def test_config_properties_equal():
    for kw in ({}, {"im_height": 64, "im_width": 256}):
        a, b = tcfg.ModelConfig(**kw), jcfg.ModelConfig(**kw)
        assert (a.imshape, a.num_bins) == (b.imshape, b.num_bins)


# --- the strip pair tables of the input-gradient kernels K2/K7 ---------------

STRIP_GEOMETRY = [(True, 1), (False, 2), (True, 2)]  # (skydome, dilation)


def _dense_strip_weights(st, h, k2):
    """[y, i, tap] summed strip-pair weights; also checks each strip's
    order and that each pair appears at most once in it."""
    dense = np.zeros((h, h, k2))
    for s in range(len(st.start) - 1):
        lo = s * st.rows
        pint = st.pint[st.start[s]:st.start[s + 1]]
        pflt = st.pflt[st.start[s]:st.start[s + 1]]
        r = pint[:, 3]
        assert np.all(np.diff(r) >= 0) and r.min(initial=0) >= -1 and r.max(initial=0) < st.rows
        assert len({(i, t) for i, t in pint[:, :2]}) == len(pint)
        for (i, t, _, rr), (_, w0, w1, zero) in zip(pint, pflt):
            assert zero == 0 and (w0 != 0 or w1 != 0)
            for y, wgt in ((lo + rr, w0), (lo + rr + 1, w1)):
                if wgt != 0:
                    assert lo <= y < min(lo + st.rows, h)
                    dense[y, i, t] += wgt
    return dense


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("h", [9, 16])
@pytest.mark.parametrize("skydome,dilation", STRIP_GEOMETRY)
@pytest.mark.parametrize("rows", [1, 2, 4, 8])
def test_strip_tables_carry_the_scatter_weights(k, h, skydome, dilation, rows):
    """Summed per (input row, output row, tap), the strip pairs' weights are
    the `scatter_tables` references' (and at k=3 the slots'); each pair
    carries its tap's column shift and fraction; a strip walks at most
    (R + 1) / R times the forward's (row, tap) pairs."""
    w, k2 = 32, k * k
    st = tdist.strip_tables(h, w, k, rows, dilation, skydome)
    gt = tdist.gather_tables(h, w, k, 1, dilation, skydome)
    assert len(st.start) == -(-h // rows) + 1 and st.start[0] == 0
    assert st.start[-1] == len(st.pint) == len(st.pflt)
    i, t = st.pint[:, 0], st.pint[:, 1]
    assert np.array_equal(st.pint[:, 2], gt.cx0[i, t])
    assert np.array_equal(st.pflt[:, 0], gt.wx[i, t])
    got = _dense_strip_weights(st, h, k2)

    sc = tdist.scatter_tables(h, w, k, 1, dilation, skydome)
    want = np.zeros((h, h, k2))
    for y in range(h):
        for ri, rt, rw in zip(sc.ri[y], sc.rt[y], sc.rw[y]):
            if rw != 0:
                want[y, ri, rt] += rw
    assert np.array_equal(got, want)
    if k == 3:
        sl = tdist.scatter_tables_k3(h, w, 1, dilation, skydome)
        slots = np.zeros((h, h, k2))
        for y in range(h):
            for si, sw, ky in zip(sl.si[y], sl.sw[y], sl.sky[y]):
                if sw != 0:
                    slots[y, si, 3 * ky:3 * ky + 3] += sw
        assert np.array_equal(got, slots)
    if rows >= 2:
        assert len(st.pint) <= (rows + 1) / rows * h * k2


def _strip_emulation(g, kernel, x_shape, k, rows, tw, dilation, skydome):
    """K2/K7's algorithm in torch: per strip and tile of tw columns, each
    pair's P = U @ K_t^T from the window of tw + 1 cotangent columns, added
    into two row accumulators that are stored as the walk passes a row."""
    b, h, w, c = x_shape
    st = tdist.strip_tables(h, w, k, rows, dilation, skydome)
    kt = kernel.reshape(k * k, c, -1).transpose(1, 2)  # [k2, f, c]
    dx = torch.full((b, h, w, c), float("nan"))
    for s in range(len(st.start) - 1):
        for j0 in range(0, w, tw):
            acc = torch.zeros(b, tw, c)
            nxt = torch.zeros(b, tw, c)
            r_cur = -1

            def advance():
                nonlocal acc, nxt, r_cur
                y = s * rows + r_cur
                if r_cur >= 0 and y < h:
                    dx[:, y, j0:j0 + tw] = acc[:, :w - j0]
                acc, nxt, r_cur = nxt, torch.zeros(b, tw, c), r_cur + 1

            for n in range(st.start[s], st.start[s + 1]):
                i, t, cx, r = (int(v) for v in st.pint[n])
                wx, w0, w1, _ = (float(v) for v in st.pflt[n])
                win = g[:, i, (j0 - cx - 1 + torch.arange(tw + 1)) % w]  # [b, tw+1, f]
                p = ((1 - wx) * win[:, 1:] + wx * win[:, :-1]) @ kt[t]
                while r_cur < r:
                    advance()
                acc = acc + w0 * p
                nxt = nxt + w1 * p
            while r_cur < rows:
                advance()
    return dx


@pytest.mark.parametrize("k", [3, 5, 7])
@pytest.mark.parametrize("rows", [1, 2, 4, 8])
@pytest.mark.parametrize("skydome,dilation", [(True, 1), (False, 2)])
def test_strip_algorithm_matches_the_reference_dx(k, rows, skydome, dilation):
    """The kernel's walk over the strip tables, emulated in torch at an odd
    height and a width that is no multiple of the column tile, gives the
    plain dx over the scatter references to 1e-5 of its max."""
    from skyhdr_torch.ops.kernels.deform_conv import da_conv_dx_ref_generic

    shape, f = (2, 9, 24, 5), 6
    rng = np.random.default_rng(k * 10 + rows)
    g = torch.from_numpy(rng.normal(size=(*shape[:3], f)).astype(np.float32))
    kernel = torch.from_numpy((rng.normal(size=(k * k * shape[-1], f)) * 0.1)
                              .astype(np.float32))
    got = _strip_emulation(g, kernel, shape, k, rows, 16, dilation, skydome)
    want = da_conv_dx_ref_generic(g, kernel, x_shape=shape, kernel_size=k,
                                  dilation_rate=dilation, skydome=skydome)
    assert not torch.isnan(got).any()
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_dx_strip_rows_fill_the_card():
    """K2/K7 take the tallest strip whose grid gives 132 SMs 1.5 blocks each:
    R = 8 for the 64x256 b64 trunk (64 images x 2 strips x 2 tiles), 2 for a
    16-row b32 layer of one tile, and the shortest when nothing fills."""
    from skyhdr_torch.ops.kernels.deform_conv import dx_strip_rows

    assert dx_strip_rows(64, 16, 2, 132) == 8
    assert dx_strip_rows(32, 16, 2, 132) == 4
    assert dx_strip_rows(32, 16, 1, 132) == 2
    assert dx_strip_rows(1, 8, 1, 132) == 2
