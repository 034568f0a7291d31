"""The port's copies of NumPy-only code equal the originals: the DA table
builders and the configuration tree."""

import dataclasses

import numpy as np
import pytest

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
    import torch

    t = tdist.gather_tables(16, 64)
    got = tdist.gather_tables_on(torch.device("cpu"), 16, 64)
    for a, b in zip(got, (t.y0, t.y1, t.cx0, t.wy, t.wx)):
        assert np.array_equal(a.numpy(), b)
    st = tdist.scatter_tables_k3(16, 64)
    got, nslots = tdist.scatter_tables_k3_on(torch.device("cpu"), 16, 64)
    assert nslots == st.nslots
    for a, b in zip(got, (st.si, st.sw, st.sky, st.scx, st.swx)):
        assert np.array_equal(a.numpy(), b)


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
