"""The port's numerics, layers and models against `skyhdr` on the CPU, with
the same weights (`init_model_vars`) and numpy inputs, float32, within 1e-4
unless stated."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from skyhdr.config import Config, DataConfig, ModelConfig
from skyhdr.models import layers as jl
from skyhdr.models.generator import Generator as JGenerator
from skyhdr.models.gradcam import sunpose_with_cams as j_cams
from skyhdr.models.sunpose import SunPoseNet as JSunPoseNet
from skyhdr.models.sunrad import SunRadNet as JSunRadNet
from skyhdr.ops.hdr import hdr_log_compression, hdr_log_decompression
from skyhdr.ops.resize import resize_bilinear as j_resize
from skyhdr.train.engine import create_gan_state
from skyhdr_torch.models import layers as tl
from skyhdr_torch.models.gradcam import sunpose_with_cams as t_cams
from skyhdr_torch.models.sunrad import SunRadNet as TSunRadNet
from skyhdr_torch.ops import hdr as thdr
from skyhdr_torch.ops.resize import resize_bilinear as t_resize
from skyhdr_torch.train.engine import build_models
from skyhdr_torch.utils.params import cast_model_vars
from skyhdr_torch.utils.transplant import (init_model_vars, init_tree,
                                           load_model_vars)

# The suite runs in several worker processes that share the CPU; torch's
# default of one thread per core in each of them oversubscribes it.
torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def _cfg(da: bool, **kw):
    return Config(model=ModelConfig(im_height=16, im_width=64, use_da_conv=da,
                                    da_backend="xla", **kw),
                  data=DataConfig(batch_size=2))


@pytest.fixture(scope="module", params=[True, False], ids=["da", "plain"])
def models(request):
    """(cfg, gen_vars, sun_vars, port Generator, port SunPoseNet)."""
    cfg = _cfg(request.param)
    gv, sv = init_model_vars(cfg, 0)
    gen, sun = build_models(cfg, "cpu")
    load_model_vars(gen, gv)
    load_model_vars(sun, sv)
    return cfg, gv, sv, gen, sun


def _np(t):
    return t.detach().float().numpy()


# --- numerics -------------------------------------------------------------

@pytest.mark.parametrize("shape,size", [
    ((2, 4, 16, 8), (8, 32)),      # c >= 8: the dilated-conv form
    ((2, 4, 16, 128), (8, 32)),
    ((2, 4, 16, 1), (16, 64)),     # c = 1 (the 4x CAM upsample): interleave
    ((2, 8, 32, 1), (16, 64)),
    ((2, 6, 20, 3), (16, 48)),     # non-integer ratio: the matmul form
    ((1, 16, 64, 8), (6, 20)),     # downscale
])
def test_resize_matches(rng, shape, size):
    x = rng.normal(size=shape).astype(np.float32)
    got = _np(t_resize(torch.from_numpy(x), size))
    np.testing.assert_allclose(got, np.asarray(j_resize(x, size)), rtol=1e-5,
                               atol=1e-5)


def test_hdr_log_roundtrip_matches(rng):
    x = rng.uniform(0, 50, size=(3, 7)).astype(np.float32)
    np.testing.assert_allclose(_np(thdr.hdr_log_compression(torch.from_numpy(x))),
                               np.asarray(hdr_log_compression(x)), rtol=1e-6)
    np.testing.assert_allclose(_np(thdr.hdr_log_decompression(torch.from_numpy(x))),
                               np.asarray(hdr_log_decompression(x)), rtol=1e-5)


# --- layers ---------------------------------------------------------------

@pytest.mark.parametrize("n,k,s,pads", [(16, 3, 2, (0, 1)), (16, 4, 1, (1, 2)),
                                        (16, 4, 2, (1, 1)), (15, 3, 2, (1, 1)),
                                        (16, 7, 1, (3, 3))])
def test_same_pads(n, k, s, pads):
    assert tl.same_pads(n, k, s) == pads


def _init_flax(module, x, **kw):
    """A writable numpy copy of a Flax module's initial variables."""
    return jax.tree_util.tree_map(
        np.array, module.init(jax.random.PRNGKey(0), x, **kw))


@pytest.mark.parametrize("k,s,features", [(3, 2, 16), (4, 1, 16), (4, 2, 16),
                                          (7, 1, 3), (3, 1, 8)])
def test_conv_matches(rng, k, s, features):
    x = rng.normal(size=(2, 8, 16, 5)).astype(np.float32)
    vars_ = _init_flax(jl.conv(features, k, s), x)
    vars_["params"]["bias"] = rng.normal(size=(features,)).astype(np.float32)
    want = np.asarray(jl.conv(features, k, s).apply(vars_, x))
    mod = tl.Conv2D(5, features, k, s)
    load_model_vars(mod, vars_)
    np.testing.assert_allclose(_np(mod(torch.from_numpy(x))), want, **TOL)


@pytest.mark.parametrize("act", ["none", "relu", "lrelu01"])
def test_instance_norm_matches(rng, act):
    x = (rng.normal(size=(2, 4, 8, 6)) * 3 + 1).astype(np.float32)
    vars_ = {"params": {"scale": rng.normal(size=(6,)).astype(np.float32),
                        "bias": rng.normal(size=(6,)).astype(np.float32)}}
    want = np.asarray(jl.InstanceNorm().apply(vars_, x, act=act))
    mod = tl.InstanceNorm(6)
    load_model_vars(mod, vars_)
    np.testing.assert_allclose(_np(mod(torch.from_numpy(x), act=act)), want, **TOL)


@pytest.mark.parametrize("k,s,norm", [(4, 2, False), (4, 2, True), (4, 1, True)])
def test_downsampling_matches(rng, k, s, norm):
    x = rng.normal(size=(2, 8, 16, 6)).astype(np.float32)
    jmod = jl.Downsampling(12, k, s, apply_norm=norm)
    vars_ = _init_flax(jmod, x, train=False)
    if norm:  # non-trivial running statistics
        vars_["batch_stats"]["bn"]["mean"] = rng.normal(size=(12,)).astype(np.float32)
        vars_["batch_stats"]["bn"]["var"] = rng.uniform(0.5, 2, size=(12,)).astype(np.float32)
        vars_["params"]["bn"]["scale"] = rng.normal(size=(12,)).astype(np.float32)
    want = np.asarray(jmod.apply(vars_, x, train=False))
    mod = tl.Downsampling(6, 12, k, s, apply_norm=norm)
    load_model_vars(mod, vars_)
    np.testing.assert_allclose(_np(mod(torch.from_numpy(x))), want, **TOL)


@pytest.mark.parametrize("shape", [(2, 8, 16, 3), (1, 7, 9, 2)])
def test_maxpool_matches(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    np.testing.assert_array_equal(_np(tl.maxpool2(torch.from_numpy(x))),
                                  np.asarray(jl.maxpool2(x)))


def test_resize_deconv_matches(rng):
    x = rng.normal(size=(2, 4, 16, 8)).astype(np.float32)
    jmod = jl.ResizeDeconv(6, (8, 32))
    vars_ = _init_flax(jmod, x)
    want = np.asarray(jmod.apply(vars_, x))
    mod = tl.ResizeDeconv(8, 6, (8, 32))
    load_model_vars(mod, vars_)
    np.testing.assert_allclose(_np(mod(torch.from_numpy(x))), want, **TOL)


# --- models ---------------------------------------------------------------

def _ldr(rng, b=2, h=16, w=64):
    return rng.uniform(0, 1, size=(b, h, w, 3)).astype(np.float32)


def test_sunpose_and_cams_match(rng, models):
    cfg, _, sv, _, sun = models
    x = _ldr(rng)
    jsun = JSunPoseNet(cfg.model)
    sm_j, cams_j = jax.jit(lambda v, xx: j_cams(
        lambda vv, x2, e: jsun.apply(vv, x2, e), v, xx))(sv, jnp.asarray(x))
    sm_t, cams_t = t_cams(sun, torch.from_numpy(x), torch.float32)
    sm_j = np.asarray(sm_j)
    # The CAM seed is argmax(sm): check the chosen bin first, and that the
    # input's top-2 gap is clear of roundoff.
    assert np.array_equal(sm_j.argmax(-1), _np(sm_t).argmax(-1))
    top2 = np.sort(sm_j, -1)[:, -2:]
    assert np.all(top2[:, 1] - top2[:, 0] > 1e-3 * top2[:, 1])
    np.testing.assert_allclose(_np(sm_t), sm_j, rtol=1e-4, atol=1e-7)
    for i, (a, e) in enumerate(zip(cams_t, cams_j)):
        e = np.asarray(e)
        assert a.shape == e.shape, i
        np.testing.assert_allclose(_np(a), e, rtol=1e-3,
                                   atol=1e-4 * np.abs(e).max(), err_msg=f"cam{i + 1}")


def test_sunrad_matches(rng):
    x = rng.uniform(0, 1, size=(2, 16, 64, 1)).astype(np.float32)
    feats = rng.normal(size=(2, 16, 64, 6)).astype(np.float32)
    jmod = JSunRadNet()
    tmod = TSunRadNet(16, 64)
    vars_ = init_tree(tmod, np.random.default_rng(3))  # Flax layout, numpy
    want = [np.asarray(a) for a in jmod.apply(vars_, x, feats, train=False)]
    load_model_vars(tmod, vars_)
    got = [_np(a) for a in tmod(torch.from_numpy(x), torch.from_numpy(feats))]
    for name, a, e in zip(("rad", "gamma", "beta"), got, want):
        np.testing.assert_allclose(a, e, rtol=1e-4, atol=1e-6, err_msg=name)


def test_generator_methods_match(rng, models):
    cfg, gv, _, gen, _ = models
    jgen = JGenerator(cfg.model)
    ap = lambda *a, method: np.asarray(
        jax.jit(lambda *b: jgen.apply(gv, *b, method=method))(*a))
    x = _ldr(rng)
    xt = torch.from_numpy(x)

    res_j = ap(x, method=JGenerator.encode)
    res_t = gen.encode(xt)
    np.testing.assert_allclose(_np(res_t), res_j, **TOL)

    np.testing.assert_allclose(_np(gen.sky_decode(res_t, xt)),
                               ap(res_j, x, method=JGenerator.sky_decode), **TOL)

    rad = rng.uniform(0, 2, size=(2, 16, 64, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(gen.sun_decode(res_t, torch.from_numpy(rad))),
                               ap(res_j, rad, method=JGenerator.sun_decode), **TOL)

    cams = [rng.uniform(0, 1, size=(2, 16 // s, 64 // s, 1)).astype(np.float32)
            for s in (1, 2, 4)]
    pose = rng.uniform(0, 1e-3, size=(2, 16, 64, 1)).astype(np.float32)
    want = jax.jit(lambda *a: jgen.apply(
        gv, *a, False, method=JGenerator.sun_rad_estimation))(x, *cams, pose)
    got = gen.sun_rad_estimation(xt, *map(torch.from_numpy, cams),
                                 torch.from_numpy(pose))
    for a, e in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(e), rtol=1e-4, atol=1e-3)

    np.testing.assert_allclose(_np(gen.blending(xt, torch.from_numpy(rad))),
                               ap(x, rad, method=JGenerator.blending), rtol=0, atol=0)


# --- weights --------------------------------------------------------------

@pytest.mark.parametrize("da", [True, False])
def test_init_tree_matches_flax_state(da):
    cfg = _cfg(da)
    state = jax.eval_shape(lambda k: create_gan_state(cfg, k),
                           jax.random.PRNGKey(0))
    ours = init_model_vars(cfg, 0)
    for want, got in zip((state.gen_vars, state.sun_vars), ours):
        flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
        flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
        assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
        for (path, w), (_, g) in zip(flat_w, flat_g):
            assert (tuple(w.shape), w.dtype) == (g.shape, g.dtype), path


def test_initializer_distributions():
    cfg = _cfg(True)
    gv, sv = init_model_vars(cfg, 0)
    k = gv["params"]["res0"]["conv1"]["kernel"]  # glorot_uniform [1152, 128]
    assert np.abs(k).max() <= np.sqrt(6 / (1152 + 128)) and k.std() > 0
    fc = sv["params"]["fc1"]["kernel"]  # lecun_normal, truncated at 2 std
    std = np.sqrt(1 / fc.shape[0]) / 0.87962566103423978
    assert np.abs(fc).max() <= 2 * std + 1e-7
    assert abs(fc.std() / np.sqrt(1 / fc.shape[0]) - 1) < 0.05
    d1 = gv["params"]["sun"]["d1"]["conv"]["kernel"]  # normal(0.02)
    assert abs(d1.std() - 0.02) < 0.002
    assert np.all(gv["batch_stats"]["sun"]["d2"]["bn"]["var"] == 1)
    again = init_model_vars(cfg, 0)[0]["params"]["res0"]["conv1"]["kernel"]
    assert np.array_equal(k, again)


def test_load_rejects_wrong_shape():
    mod = tl.Conv2D(4, 8, 3)
    tree = {"params": {"kernel": np.zeros((3, 3, 4, 9), np.float32),
                       "bias": np.zeros((8,), np.float32)}}
    with pytest.raises(ValueError, match="kernel"):
        load_model_vars(mod, tree)


def test_cast_model_vars_keeps_buffers():
    cfg = _cfg(True)
    gen, _ = build_models(cfg, "cpu")
    cast_model_vars(gen, "bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in gen.parameters())
    assert all(b.dtype == torch.float32 for b in gen.buffers())


def _rel(got, want):
    want = np.asarray(want).astype(np.float32)
    return np.abs(_np(got) - want).max() / np.abs(want).max()


@pytest.mark.parametrize("da", [True, False], ids=["da", "plain"])
def test_bf16_compute_matches(rng, da):
    """compute_dtype=bfloat16: both packages round at the same layers; the
    port and JAX differ by bf16 roundoff accumulated over the stack (2^-8
    per rounding), so the bound is 3e-2 of the output's range. The alpha
    blend's 1/0.12 threshold slope amplifies that roundoff, so the check
    stops before it, at the decoders and the sun-pose softmax."""
    cfg = _cfg(da, compute_dtype="bfloat16")
    gv, sv = init_model_vars(cfg, 0)
    gen, sun = build_models(cfg, "cpu")
    load_model_vars(gen, gv)
    load_model_vars(sun, sv)
    jgen, jsun = JGenerator(cfg.model), JSunPoseNet(cfg.model)
    x = _ldr(rng)
    xt = torch.from_numpy(x)
    res_j = jax.jit(lambda v, a: jgen.apply(v, a, method=JGenerator.encode))(gv, x)
    sky_j = jax.jit(lambda v, r, a: jgen.apply(v, r, a, method=JGenerator.sky_decode))(
        gv, res_j, x)
    res_t = gen.encode(xt)
    assert _rel(res_t, res_j) <= 3e-2
    assert _rel(gen.sky_decode(res_t, xt), sky_j) <= 3e-2
    sm_j, _ = jax.jit(lambda v, a: j_cams(
        lambda vv, x2, e: jsun.apply(vv, x2, e), v, a))(sv, jnp.asarray(x))
    sm_t, cams_t = t_cams(sun, xt, torch.bfloat16)
    assert np.array_equal(np.asarray(sm_j).argmax(-1), _np(sm_t).argmax(-1))
    assert _rel(sm_t, sm_j) <= 3e-2
    assert all(c.dtype == torch.bfloat16 for c in cams_t)
