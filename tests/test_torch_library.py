"""The op-library helpers of `skyhdr` that no step calls, held to their
port counterparts on the CPU: the same NumPy inputs from a seed, values and
gradients (`jax.vjp` against autograd with the same cotangents).

Tolerances: `inverse_rf` and the channel flips bit-equal; `rgb2gray`,
`positional_encoding` and `avgpool2` 1e-6 of the max; the Gaussian / DoG
forms, `conv`, `instance_moments` and `FC2D` / `DFC2D` 1e-5 of the max;
gradients rtol 1e-4, atol 1e-7 (as `tests/test_dog_fused.py`); the bf16
`dog_l1_loss_conv` 2e-2."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyhdr.models import layers as jlayers
from skyhdr.ops import distortion as jdist
from skyhdr.ops import dog as jdog
from skyhdr.ops import geometry as jgeo
from skyhdr.ops import hdr as jhdr
from skyhdr.utils import io as jio
from skyhdr.utils import params as jparams
from skyhdr_torch.models import layers
from skyhdr_torch.ops import dog, geometry, hdr
from skyhdr_torch.ops.distortion import STRIDE_DEFECT, DAConv, DADeconv, deformable_conv2d
from skyhdr_torch.utils import io, params, transplant

# The suite runs in several worker processes that share the CPU.
torch.set_num_threads(1)

GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7


def _max_rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def held(jfn, tfn, arrays, rtol, grad=True, seed=1, mean_cotangents=False):
    """jfn on jnp arrays and tfn on torch tensors of the same `arrays`:
    every output within `rtol` of its max; with `grad`, the vjp of the same
    random cotangents within GRAD_RTOL / GRAD_ATOL elementwise. With
    `mean_cotangents` each cotangent is divided by its output's size, the
    scale of a mean loss's, for which GRAD_ATOL was set."""
    jin = [jnp.asarray(a) for a in arrays]
    jout, vjp = jax.vjp(lambda *xs: jfn(*xs), *jin)
    tin = [torch.from_numpy(a.copy()).requires_grad_(grad) for a in arrays]
    tout = tfn(*tin)
    jouts = jout if isinstance(jout, (tuple, list)) else (jout,)
    touts = tout if isinstance(tout, (tuple, list)) else (tout,)
    assert len(jouts) == len(touts)
    for j, t in zip(jouts, touts):
        assert tuple(j.shape) == tuple(t.shape)
        assert _max_rel(t.detach().float().numpy(), j) <= rtol
    if not grad:
        return
    rng = np.random.default_rng(seed)
    cts = [(rng.standard_normal(np.shape(j)) / (np.size(j) if mean_cotangents else 1)
            ).astype(np.float32) for j in jouts]
    jgrads = vjp(tuple(jnp.asarray(c) for c in cts) if isinstance(jout, (tuple, list))
                 else jnp.asarray(cts[0]))
    tgrads = torch.autograd.grad(touts, tin, [torch.from_numpy(c) for c in cts])
    for jg, tg in zip(jgrads, tgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.fixture
def img():
    return np.random.default_rng(0).uniform(0, 2, (2, 16, 32, 3)).astype(np.float32)


# --- ops/hdr.py ---------------------------------------------------------------

def test_rgb2gray(img):
    held(jhdr.rgb2gray, hdr.rgb2gray, [img], 1e-6)
    assert hdr.rgb2gray(torch.from_numpy(img)).shape == (2, 16, 32, 1)


@pytest.mark.parametrize("name", ["rgb2bgr", "bgr2rgb"])
def test_channel_flips_bit_equal(img, name):
    got = getattr(hdr, name)(torch.from_numpy(img)).numpy()
    assert np.array_equal(got, np.asarray(getattr(jhdr, name)(jnp.asarray(img))))
    held(getattr(jhdr, name), getattr(hdr, name), [img], 0.0)


# --- utils/io.py, utils/params.py -----------------------------------------------

def test_inverse_rf_bit_equal():
    for crf in io.make_synthetic_dorf(16, 1024, seed=3):
        got, want = io.inverse_rf(crf), jio.inverse_rf(crf)
        assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_cast_floating_matches_skyhdr(dtype):
    rng = np.random.default_rng(2)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    tree = {"w": torch.from_numpy(w), "step": torch.tensor(7, dtype=torch.int32),
            "mask": torch.tensor([True, False]),
            "nested": {"b": [torch.zeros(2), (torch.ones(3, dtype=torch.float64),)]}}
    out = params.cast_floating(tree, dtype)
    want = jparams.cast_floating({"w": jnp.asarray(w)}, getattr(jnp, dtype))["w"]
    assert out["w"].dtype == getattr(torch, dtype)
    assert np.array_equal(out["w"].float().numpy(), np.asarray(want.astype(jnp.float32)))
    assert out["nested"]["b"][0].dtype == out["nested"]["b"][1][0].dtype == getattr(torch, dtype)
    assert isinstance(out["nested"]["b"], list) and isinstance(out["nested"]["b"][1], tuple)
    assert out["step"].dtype == torch.int32 and out["mask"].dtype == torch.bool
    assert tree["w"].dtype == torch.float32  # a copy, the input untouched


def test_cast_floating_numpy_leaves():
    tree = {"a": np.ones(3, np.float32), "i": np.arange(3), "s": 1.5}
    out = params.cast_floating(tree, np.float16)
    assert out["a"].dtype == np.float16 and out["i"].dtype == tree["i"].dtype
    assert out["s"] == 1.5
    with pytest.raises(TypeError, match="bfloat16"):
        params.cast_floating(tree, "bfloat16")


# --- ops/geometry.py --------------------------------------------------------------

@pytest.mark.parametrize("with_r", [False, True])
def test_positional_encoding(with_r):
    x = np.random.default_rng(4).standard_normal((2, 8, 16, 3)).astype(np.float32)
    held(lambda a: jgeo.positional_encoding(a, with_r=with_r),
         lambda a: geometry.positional_encoding(a, with_r=with_r), [x], 1e-6)


def test_vmf_pdf_takes_a_precomputed_table():
    h, w = 16, 64
    y = np.random.default_rng(5).uniform(2, 13, 4).astype(np.float32)
    bins = jgeo.sunpose_bins(h, w)
    want = np.asarray(jgeo.vmf_pdf(w * 0.5 - 1, jnp.asarray(y), h, w, bins=bins))
    yt = torch.from_numpy(y)
    got = geometry.vmf_pdf(w * 0.5 - 1, yt, h, w, bins=bins)
    assert _max_rel(got.numpy(), want) <= 1e-5
    for table in (bins, torch.from_numpy(geometry.sunpose_bins(h, w))):
        assert torch.equal(geometry.vmf_pdf(w * 0.5 - 1, yt, h, w, bins=table),
                           geometry.vmf_pdf(w * 0.5 - 1, yt, h, w))


# --- ops/dog.py -------------------------------------------------------------------

@pytest.mark.parametrize("padding", ["REFLECT", "SYMMETRIC", "CONSTANT"])
@pytest.mark.parametrize("ksize,sigma", [(3, 1.2489996), (5, 2.0)])
def test_gaussian_filter2d(img, padding, ksize, sigma):
    held(lambda a: jdog.gaussian_filter2d(a, ksize, sigma, padding),
         lambda a: dog.gaussian_filter2d(a, ksize, sigma, padding), [img], 1e-5)


def test_dog_pyramid(img):
    """A band is the difference of two blurs of the upsampled image, some
    hundred times smaller than either: a rounding of the blurs (held to 1e-5
    of their max above) is 4e-5 of the band's own max. So each band is held
    to 1e-5 of the image's max, which bounds the blurs' (the upsample and
    the blurs average), and its vjp with a mean loss's cotangents."""
    bands = dog.dog_pyramid(torch.from_numpy(img))
    want = jdog.dog_pyramid(jnp.asarray(img))
    for got, ref in zip(bands, want):
        assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-5 * np.abs(img).max()
    held(jdog.dog_pyramid, dog.dog_pyramid, [img], np.inf, mean_cotangents=True)


def assert_l1_grads_close(got, want, pred, target):
    """Gradients of a DoG L1 loss: within GRAD_RTOL / GRAD_ATOL, except on
    the inputs under a band element at |.|'s kink. There |d| is within a
    few roundings of the blurs (1e-6 of the image's max; the two packages'
    band differences differ by up to 3e-7 of it) of 0, so the two
    computations may round it to opposite signs and take opposite
    subgradients; each such element moves its inputs' gradient by at most
    2/N (N: the elements a band's mean runs over). Such elements must be
    rare (at most 1% of a band's)."""
    x = torch.from_numpy(pred - target).requires_grad_()
    bands = dog.dog_pyramid(x)
    scale = max(np.abs(pred).max(), np.abs(target).max())
    kinks = [(b.detach().abs() <= 1e-6 * scale).float() for b in bands]
    n_kinks, n = sum(int(k.sum()) for k in kinks), bands[0].numel()
    assert n_kinks <= 1e-2 * n
    under, = torch.autograd.grad(bands, x, kinks)
    under = under.abs().numpy() > 0
    close = np.isclose(got, want, rtol=GRAD_RTOL, atol=GRAD_ATOL)
    assert (close | under).all()
    assert np.abs(got - want)[~close].max(initial=0.0) <= 2 * n_kinks / n


@pytest.mark.parametrize("shape", [(2, 16, 32, 3), (2, 8, 16, 1)])
def test_dog_l1_loss_conv(shape):
    rng = np.random.default_rng(6)
    pred, target = (rng.uniform(0, 2, shape).astype(np.float32) for _ in range(2))
    held(jdog.dog_l1_loss_conv, dog.dog_l1_loss_conv, [pred, target], 1e-5, grad=False)
    p, t = torch.from_numpy(pred).requires_grad_(), torch.from_numpy(target)
    conv, mm = dog.dog_l1_loss_conv(p, t), dog.dog_l1_loss(p, t)
    g_conv, = torch.autograd.grad(conv, p)
    g_jax = jax.grad(jdog.dog_l1_loss_conv)(jnp.asarray(pred), jnp.asarray(target))
    assert_l1_grads_close(g_conv.numpy(), np.asarray(g_jax), pred, target)
    # The port's two forms of the loss agree as `skyhdr`'s do.
    np.testing.assert_allclose(conv.item(), mm.item(), rtol=1e-5, atol=1e-8)
    g_mm, = torch.autograd.grad(mm, p)
    assert_l1_grads_close(g_conv.numpy(), g_mm.numpy(), pred, target)


def test_dog_l1_loss_conv_bf16(img):
    target = np.random.default_rng(7).uniform(0, 2, img.shape).astype(np.float32)
    want = float(jdog.dog_l1_loss_conv(jnp.asarray(img, jnp.bfloat16),
                                       jnp.asarray(target, jnp.bfloat16)))
    got = dog.dog_l1_loss_conv(torch.from_numpy(img).bfloat16(),
                               torch.from_numpy(target).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().item(), want, rtol=2e-2)


# --- models/layers.py -------------------------------------------------------------

def test_instance_moments():
    x = np.random.default_rng(8).standard_normal((2, 8, 16, 5)).astype(np.float32)
    held(jlayers.instance_moments, layers.instance_moments, [x], 1e-5)


def _flax_vars(module, tree):
    return {coll: jax.tree_util.tree_map(jnp.asarray, sub) for coll, sub in tree.items()}


@pytest.mark.parametrize("ci,co,k,s", [(5, 16, 3, 1), (5, 3, 3, 1), (6, 8, 4, 2), (4, 12, 3, 2)],
                         ids=["k3", "k3-folded", "k4s2", "k3s2"])
def test_conv(ci, co, k, s):
    """`conv` against `skyhdr`'s (which folds co <= 8 at stride 1), the
    port's seeded tree carried into Flax."""
    x = np.random.default_rng(9).standard_normal((2, 8, 16, ci)).astype(np.float32)
    mod = layers.conv(ci, co, k, s)
    tree = transplant.init_tree(mod, np.random.default_rng(10))
    transplant.load_model_vars(mod, tree)
    jmod = jlayers.conv(co, k, s)
    held(lambda a: jmod.apply(_flax_vars(jmod, tree), a), mod, [x], 1e-5)
    assert isinstance(mod, layers.Conv2D)


@pytest.mark.parametrize("shape,kernel", [((2, 8, 16, 3), 2), ((2, 7, 15, 3), 2),
                                          ((1, 9, 10, 2), 3)],
                         ids=["even", "odd", "k3"])
def test_avgpool2(shape, kernel):
    x = np.random.default_rng(11).standard_normal(shape).astype(np.float32)
    held(lambda a: jlayers.avgpool2(a, kernel), lambda a: layers.avgpool2(a, kernel), [x], 1e-6)


def _flat(tree, prefix=""):
    if not isinstance(tree, dict):
        return {prefix: np.asarray(tree)}
    out = {}
    for k in sorted(tree):
        out.update(_flat(tree[k], f"{prefix}/{k}"))
    return out


@pytest.mark.parametrize("which", ["FC2D", "DFC2D"])
def test_fc_layers_carry_weights_both_ways(which):
    """Flax's own init loaded into the port, exported back equal, and the
    two forwards (and vjps) agree; then the port's seeded tree into Flax."""
    rng = np.random.default_rng(12)
    if which == "FC2D":
        x = rng.standard_normal((2, 4, 8, 3)).astype(np.float32)
        jmod, mod = jlayers.FC2D(16), layers.FC2D(4 * 8 * 3, 16)
    else:
        x = rng.standard_normal((2, 1, 1, 16)).astype(np.float32)
        jmod, mod = jlayers.DFC2D(4, 8, 3), layers.DFC2D(16, 4, 8, 3)
    jvars = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    jtree = jax.tree_util.tree_map(np.asarray, jax.device_get(dict(jvars)))
    transplant.load_model_vars(mod, jtree)
    back = _flat(transplant.export_model_vars(mod))
    assert back.keys() == _flat(jtree).keys()
    assert all(np.array_equal(back[k], v) for k, v in _flat(jtree).items())
    held(lambda a: jmod.apply(jvars, a), mod, [x], 1e-5)

    tree = transplant.init_tree(mod, np.random.default_rng(13))
    transplant.load_model_vars(mod, tree)
    held(lambda a: jmod.apply(_flax_vars(jmod, tree), a), mod, [x], 1e-5)


# --- ops/distortion.py: the stride ------------------------------------------------

def test_da_conv_stride_other_than_one_raises():
    x = torch.zeros(1, 8, 16, 2)
    with pytest.raises(ValueError, match="stride 2") as err:
        DAConv(2, 3, strides=2)
    assert "skyhdr/ops/distortion.py" in str(err.value) and STRIDE_DEFECT in str(err.value)
    with pytest.raises(ValueError, match="stride 2"):
        deformable_conv2d(x, torch.zeros(18, 3), torch.zeros(3), stride=2)


def test_da_conv_stride_one_is_the_plain_form():
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.standard_normal((2, 8, 16, 4)).astype(np.float32))
    for mod in (DAConv(4, 6, strides=1), DAConv(4, 6, kernel_size=5)):
        transplant.load_model_vars(mod, transplant.init_tree(mod, rng))
        assert torch.equal(mod(x), deformable_conv2d(x, mod.kernel, mod.bias,
                                                     kernel_size=mod.kernel_size))
    up = DADeconv(4, 6, (16, 32))
    assert up.kernel.shape == (36, 6) and up.out_hw == (16, 32)


def test_skyhdr_strided_da_conv_is_the_defect_the_port_refuses():
    """What `STRIDE_DEFECT` says of the reference: at stride 2 the output
    keeps the input's width, and the roll and column-restricted forms of
    the same call disagree. Should `skyhdr` repair it, this fails, and the
    port's stride can be ported."""
    rng = np.random.default_rng(15)
    x = jnp.asarray(rng.standard_normal((1, 8, 16, 2)).astype(np.float32))
    kern = jnp.asarray(rng.standard_normal((18, 3)).astype(np.float32))
    bias = jnp.zeros(3)
    roll = jdist.deformable_conv2d(x, kern, bias, stride=2)
    cols = jdist.deformable_conv2d(x, kern, bias, stride=2, col_start=0, out_cols=16)
    assert roll.shape == (1, 4, 16, 3)
    assert float(jnp.abs(roll - cols).max()) > 1.0
