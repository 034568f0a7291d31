"""The port's training ops on the CPU against `skyhdr`: the host-side
copies (exposures, DoRF curves), the sun-pose ground truth, the losses,
the DoG loss, the frozen VGG16, the CRFs, the JPEG model, the degradation
fed JAX's draws, BatchNorm in training mode and the discriminator.

Tolerances: float32 ops computed in the same order agree to 1e-6; those
with sums in another order (convs, einsums, softmax) to 1e-5 relative, or
1e-4 through the VGG16 stack. The JPEG model is held per pixel to three
8-bit steps and 99% of the pixels to equality (see
`test_jpeg_simulate_matches_skyhdr`)."""

import gzip
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from skyhdr.config import ModelConfig as JModelConfig
from skyhdr.data import degradation as jdeg
from skyhdr.models import vgg16 as jvgg
from skyhdr.models.discriminator import Discriminator as JDiscriminator
from skyhdr.ops import crf as jcrf
from skyhdr.ops import dog as jdog
from skyhdr.ops import geometry as jgeo
from skyhdr.ops import jpeg as jjpeg
from skyhdr.train import engine as jengine
from skyhdr.train import losses as jlosses
from skyhdr.utils import io as jio
from skyhdr_torch.config import ModelConfig
from skyhdr_torch.data import degradation as tdeg
from skyhdr_torch.models import vgg16 as tvgg
from skyhdr_torch.models.discriminator import Discriminator
from skyhdr_torch.models.layers import BatchNorm
from skyhdr_torch.ops import crf as tcrf
from skyhdr_torch.ops import dog as tdog
from skyhdr_torch.ops import geometry as tgeo
from skyhdr_torch.ops import jpeg as tjpeg
from skyhdr_torch.train import losses as tlosses
from skyhdr_torch.utils import io as tio
from skyhdr_torch.utils import jax_random
from skyhdr_torch.utils.transplant import export_model_vars, load_model_vars

# The suite runs in several worker processes that share the CPU; torch's
# default of one thread per core in each of them oversubscribes it.
torch.set_num_threads(1)

H, W, B = 16, 64, 2


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(got.detach().numpy() if torch.is_tensor(got) else got,
                               np.asarray(want), rtol=rtol, atol=atol, err_msg=msg)


def _images(rng, lo=0.0, hi=1.0, shape=(B, H, W, 3)):
    return rng.uniform(lo, hi, shape).astype(np.float32)


# --- host copies --------------------------------------------------------------

def test_exposure_and_synthetic_dorf_copies_equal():
    for got, want in zip(tio.get_exposure_lists(), jio.get_exposure_lists()):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tio.make_synthetic_dorf(175, 1024),
                                  jio.make_synthetic_dorf(175, 1024))


def test_load_dorf_curves_copy_equal(tmp_path):
    import os

    src = os.path.join(os.path.dirname(__file__), "fixtures", "dorfCurves.txt.gz")
    path = tmp_path / "dorfCurves.txt"
    with gzip.open(src, "rb") as f, open(path, "wb") as out:
        shutil.copyfileobj(f, out)
    for got, want in zip(tio.load_dorf_curves(str(path)), jio.load_dorf_curves(str(path))):
        np.testing.assert_array_equal(got, want)


# --- geometry -------------------------------------------------------------------

def test_sunpose_bins_and_sphere2world_equal(rng):
    np.testing.assert_array_equal(tgeo.sunpose_bins(H, W), jgeo.sunpose_bins(H, W))
    x, y = rng.uniform(0, W, 5).astype(np.float32), rng.uniform(0, H, 5).astype(np.float32)
    for skydome in (True, False):
        _close(tgeo.sphere2world(_t(x), _t(y), H, W, skydome),
               jgeo.sphere2world(x, y, H, W, skydome), atol=1e-6)


@pytest.mark.parametrize("h,w", [(16, 64), (32, 128)])
def test_sunpose_ground_truth_matches(h, w):
    elevation = np.linspace(4, 28, 3).astype(np.float32)
    jcfg = jengine.Config(model=JModelConfig(im_height=h, im_width=w))
    want = jengine._sunpose_gt_from_elevation(jcfg, jnp.asarray(elevation))
    got = tgeo.sunpose_gt_from_elevation(ModelConfig(im_height=h, im_width=w), _t(elevation))
    assert got.shape == (3, h * w)
    _close(got, want, rtol=1e-4, atol=1e-7)
    _close(tgeo.vmf_pdf(_t([3.5]), _t([2.0]), h, w, kappa=40.0),
           jgeo.vmf_pdf(np.float32([3.5]), np.float32([2.0]), h, w, kappa=40.0),
           rtol=1e-4, atol=1e-7)


# --- losses --------------------------------------------------------------------------

def test_losses_match(rng):
    t = rng.dirichlet(np.ones(64), size=3).astype(np.float32)
    p = rng.dirichlet(np.ones(64), size=3).astype(np.float32)
    t[0, :5] = 0.0  # the clip to [1e-7, 1] matters here
    p[1, :5] = 0.0
    _close(tlosses.kl_divergence(_t(t), _t(p)), jlosses.kl_divergence(t, p))
    d_real, d_gen = rng.normal(size=(2, 4, 1)).astype(np.float32), rng.normal(size=(2, 4, 1)).astype(np.float32)
    _close(tlosses.lsgan_gen_loss(_t(d_gen)), jlosses.lsgan_gen_loss(d_gen))
    for got, want in zip(tlosses.lsgan_disc_loss(_t(d_real), _t(d_gen)),
                         jlosses.lsgan_disc_loss(d_real, d_gen)):
        _close(got, want)
    _close(tlosses.l1_loss(_t(t), _t(p)), jlosses.l1_loss(t, p))


# --- DoG ------------------------------------------------------------------------------

@pytest.mark.parametrize("n", [16, 64, 7])
def test_dog_operators_equal(n):
    for got, want in zip(tdog.dog_axis_operators(n, 3), jdog._dog_axis_operators(n, 3)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(B, H, W, 3), (B, H, W, 1)])
def test_dog_l1_loss_matches(rng, shape):
    pred, target = _images(rng, 0, 4, shape), _images(rng, 0, 4, shape)
    _close(tdog.dog_l1_loss(_t(pred), _t(target)), jdog.dog_l1_loss(pred, target))


# --- VGG16 -----------------------------------------------------------------------------

def test_random_vgg16_weights_bit_equal():
    got, want = tvgg.random_vgg16_weights(), jvgg.random_vgg16_weights()
    assert list(got) == list(want)
    for name in want:
        for a, b in zip(got[name], want[name]):
            np.testing.assert_array_equal(a, b)


def test_load_vgg16_npy_copy_equal(tmp_path, rng):
    raw = {name: [rng.normal(size=(3, 3, ci, co)).astype(np.float32),
                  rng.normal(size=(co,)).astype(np.float32)]
           for name, ci, co in tvgg._LAYERS}
    path = str(tmp_path / "vgg16.npy")
    np.save(path, raw, allow_pickle=True)
    got, want = tvgg.load_vgg16_npy(path), jvgg.load_vgg16_npy(path)
    np.testing.assert_array_equal(got["conv1_1"][0], raw["conv1_1"][0][:, :, ::-1])
    for name in want:
        for a, b in zip(got[name], want[name]):
            np.testing.assert_array_equal(a, b)


def test_vgg16_features_and_perceptual_match(rng):
    weights = jvgg.random_vgg16_weights()
    consts = tvgg.vgg_constants(weights, "cpu")
    pred, target = _images(rng), _images(rng)
    for got, want in zip(tvgg.vgg16_features(consts, _t(pred)),
                         jvgg.vgg16_features(weights, pred)):
        scale = float(np.abs(np.asarray(want)).max())
        _close(got, want, rtol=1e-4, atol=1e-4 * scale)
    _close(tvgg.perceptual_l1(consts, _t(pred), _t(target)),
           jvgg.perceptual_l1(weights, pred, target), rtol=1e-4)


# --- CRF, JPEG, degradation ------------------------------------------------------------

def test_crf_chebyshev_and_exact_match(rng):
    curves = jio.make_synthetic_dorf(6, 1024)
    coeffs = tcrf.chebyshev_fit(curves)
    np.testing.assert_allclose(coeffs, jcrf.chebyshev_fit(curves), rtol=1e-6, atol=1e-7)
    x = _images(rng, shape=(6, 8, 16, 3))
    _close(tcrf.apply_rf_chebyshev(_t(x), _t(coeffs)), jcrf.apply_rf_chebyshev(x, coeffs),
           atol=2e-6)
    _close(tcrf.apply_rf(_t(x), _t(curves)), jcrf.apply_rf(x, curves), atol=1e-6)
    # The Chebyshev form stays within one 8-bit step of the exact LUT.
    cheb = tcrf.apply_rf_chebyshev(_t(x), _t(coeffs))
    assert float((cheb - tcrf.apply_rf(_t(x), _t(curves))).abs().max()) < 1 / 255


@pytest.mark.parametrize("subsample", [True, False])
def test_jpeg_simulate_matches_skyhdr(rng, subsample):
    """Outputs are multiples of 1/255. A DCT coefficient that lies on a .5
    quantisation tie can round the other way when the DCT is summed in
    another order, which moves a block's pixels by a few 8-bit steps; so
    every pixel is held to 3/255 and at least 99% of them to equality."""
    img = _images(rng, shape=(4, 16, 64, 3))
    quality = np.float32([90, 93, 97, 100])
    got = tjpeg.jpeg_simulate(_t(img), _t(quality), chroma_subsample=subsample).numpy()
    want = np.asarray(jjpeg.jpeg_simulate(img, quality, chroma_subsample=subsample))
    diff = np.abs(got - want)
    assert diff.max() <= 3 / 255 + 1e-6
    assert np.mean(diff < 1e-6) >= 0.99
    np.testing.assert_array_equal(tjpeg.quant_table(_t(quality), tjpeg._const("luma", "cpu")),
                                  jjpeg.quant_table(quality, jjpeg._Q_LUMA))


def test_jpeg_quality_ramp_equal():
    for b in (1, 2, 7):
        np.testing.assert_array_equal(tdeg.jpeg_quality_ramp(b), jdeg.jpeg_quality_ramp(b))


@pytest.fixture(scope="module")
def banks():
    curves, exposures = jio.make_synthetic_dorf(175, 1024), jio.get_exposure_lists()[0]
    return (jdeg.make_banks(curves, exposures),
            tdeg.make_banks(curves, exposures, device="cpu"))


@pytest.mark.parametrize("chebyshev", [True, False])
def test_degrade_with_jax_draws(rng, chebyshev):
    """`degrade_with` fed the draws `skyhdr.data.degradation.degrade_batch`
    takes from its key (same split and order) gives JAX's (hdr_t, ldr).
    hdr_t to 1e-6; ldr through the JPEG model as in its test."""
    curves, exposures = jio.make_synthetic_dorf(175, 1024), jio.get_exposure_lists()[0]
    jb = jdeg.make_banks(curves, exposures, fit_chebyshev=chebyshev)
    tb = tdeg.make_banks(curves, exposures, fit_chebyshev=chebyshev, device="cpu")
    hdr = _images(rng, 0, 2)
    key = jax.random.PRNGKey(3)
    want_t, want_ldr = jdeg.degrade_batch(key, hdr, jb)
    k_crf, k_t, k_ss, k_sc, k_ns, k_nc = jax.random.split(key, 6)
    draws = tdeg.Draws(
        t_idx=_t(jax.random.randint(k_t, (B,), 0, len(exposures))).long(),
        u_s=_t(jax.random.uniform(k_ss, (B, 1, 1, 3))),
        u_c=_t(jax.random.uniform(k_sc, (B, 1, 1, 3))),
        z_s=_t(jax.random.normal(k_ns, hdr.shape)),
        z_c=_t(jax.random.normal(k_nc, hdr.shape)),
        crf_idx=_t(jax.random.randint(k_crf, (B,), 0, len(curves))).long())
    got_t, got_ldr = tdeg.degrade_with(_t(hdr), tb, draws)
    _close(got_t, want_t, atol=1e-6)
    diff = np.abs(got_ldr.numpy() - np.asarray(want_ldr))
    assert diff.max() <= 3 / 255 + 1e-6 and np.mean(diff < 1e-6) >= 0.99


def test_degrade_batch_draws_from_generator(banks):
    """The drawing half: shapes, ranges, and the same draws from the same
    key (`utils.jax_random`), other draws from another."""
    _, tb = banks
    hdr = torch.rand(B, H, W, 3) * 2
    a = tdeg.degrade_batch(jax_random.key(5), hdr, tb)
    b = tdeg.degrade_batch(jax_random.key(5), hdr, tb)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(tdeg.degrade_batch(jax_random.key(6), hdr, tb)[0], a[0])
    hdr_t, ldr = a
    assert hdr_t.shape == ldr.shape == hdr.shape
    assert float(hdr_t.min()) >= 0 and 0 <= float(ldr.min()) and float(ldr.max()) <= 1
    d = tdeg.draw_degradation(jax_random.key(5), hdr.shape, tb)
    assert d.t_idx.max() < len(tb.exposures) and d.crf_idx.max() < len(tb.crfs)


# --- BatchNorm and the discriminator ------------------------------------------------------

def _random_stats(tree, rng):
    """Non-trivial BN running statistics, so eval mode is tested too."""
    out = jax.tree_util.tree_map(np.asarray, tree)
    for path, node in _bn_nodes(out.get("batch_stats", {})):
        node["mean"] = rng.normal(size=node["mean"].shape).astype(np.float32)
        node["var"] = rng.uniform(0.5, 2.0, node["var"].shape).astype(np.float32)
    return out


def _bn_nodes(tree, path=()):
    if "mean" in tree and "var" in tree:
        yield path, tree
        return
    for k, v in tree.items():
        yield from _bn_nodes(v, path + (k,))


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_matches_flax(rng, train):
    """Flax BatchNorm(momentum 0.99, eps 1e-3): batch mean and BIASED batch
    variance in training, the running update ra = 0.99 ra + 0.01 stat made
    once per call."""
    import flax.linen as nn

    x = (rng.normal(size=(4, 5, 6, 8)) * 3 + 1).astype(np.float32)
    jbn = nn.BatchNorm(use_running_average=not train, momentum=0.99, epsilon=1e-3)
    variables = {"params": {"scale": rng.normal(size=8).astype(np.float32),
                            "bias": rng.normal(size=8).astype(np.float32)},
                 "batch_stats": {"mean": rng.normal(size=8).astype(np.float32),
                                 "var": rng.uniform(0.5, 2, 8).astype(np.float32)}}
    want, new = jbn.apply(variables, x, mutable=["batch_stats"])
    bn = load_model_vars(BatchNorm(8), variables)
    got = bn(_t(x), train=train)
    _close(got, want, rtol=1e-5, atol=1e-5)
    stats = export_model_vars(bn, collections=("batch_stats",))["batch_stats"]
    for k in ("mean", "var"):
        _close(stats[k], new["batch_stats"][k], rtol=1e-6, atol=1e-6, msg=k)


@pytest.mark.parametrize("h,w,padding", [(16, 64, "SAME"), (32, 128, "VALID")])
@pytest.mark.parametrize("train", [True, False])
def test_discriminator_matches_flax(rng, h, w, padding, train):
    """d4 gives 2x8 at 16x64 (the output conv falls back to SAME) and 4x16
    at 32x128 (VALID, 1x13 logits); train mode refreshes the statistics."""
    ldr, hdr = _images(rng, shape=(B, h, w, 3)), _images(rng, 0, 3, shape=(B, h, w, 3))
    jd = JDiscriminator()
    variables = _random_stats(jd.init(jax.random.PRNGKey(0), ldr, hdr, train=False), rng)
    want, new = jd.apply(variables, ldr, hdr, train=train, mutable=["batch_stats"])
    disc = load_model_vars(Discriminator(3), variables)
    got = disc(_t(ldr), _t(hdr), train=train)
    out_hw = (h // 8 - (3 if padding == "VALID" else 0), w // 8 - (3 if padding == "VALID" else 0))
    assert tuple(got.shape) == (B, *out_hw, 1) == np.asarray(want).shape
    _close(got, want, rtol=1e-4, atol=1e-5)
    stats = export_model_vars(disc, collections=("batch_stats",))["batch_stats"]
    for path, node in _bn_nodes(new["batch_stats"]):
        mine = stats
        for k in path:
            mine = mine[k]
        for k in ("mean", "var"):
            _close(mine[k], node[k], rtol=1e-5, atol=1e-6, msg=f"{path} {k}")
