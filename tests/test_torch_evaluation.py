"""The port's eval metrics (`skyhdr_torch.train.evaluation`,
`skyhdr_torch.ops.emd`) against `skyhdr`'s on the same inputs, made from a
seed with NumPy.

Tolerances: rtol 1e-5, atol 1e-6 (the same float32 formulas, summed in
another order); `wasserstein_1d` against SciPy's general
`wasserstein_distance` to 1e-5 relative (float32 against float64)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyhdr.ops import emd as jemd
from skyhdr.train import evaluation as jev
from skyhdr_torch.ops import emd as temd
from skyhdr_torch.train import evaluation as tev

# The suite runs in several worker processes that share the CPU.
torch.set_num_threads(1)

SHAPES = [(1, 5, 7, 3), (2, 8, 16, 3), (3, 16, 64, 3)]
RTOL, ATOL = 1e-5, 1e-6


def _pair(shape, seed=0):
    """(pred, target): HDR-like positive values, pred with zeros and
    negatives (the clamp of si_rmse's log)."""
    rng = np.random.default_rng(seed)
    target = rng.gamma(1.0, 2.0, shape).astype(np.float32)
    pred = (target * rng.uniform(0.5, 1.5, shape) + rng.normal(0, 0.2, shape)).astype(np.float32)
    pred.reshape(-1)[::11] = 0.0
    pred.reshape(-1)[::13] = -0.5
    return pred, target


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol)


@pytest.mark.parametrize("shape", SHAPES)
def test_wasserstein_1d(shape):
    pred, target = _pair(shape)
    b = shape[0]
    x, y = pred.reshape(b, -1), target.reshape(b, -1)
    _close(temd.wasserstein_1d(torch.from_numpy(x), torch.from_numpy(y)),
           jemd.wasserstein_1d(jnp.asarray(x), jnp.asarray(y)))


@pytest.mark.parametrize("shape", SHAPES)
def test_wasserstein_1d_matches_scipy(shape):
    from scipy.stats import wasserstein_distance

    pred, target = _pair(shape, seed=1)
    b = shape[0]
    x, y = pred.reshape(b, -1), target.reshape(b, -1)
    got = temd.wasserstein_1d(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    want = [wasserstein_distance(x[i], y[i]) for i in range(b)]
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_compare_luminance(shape):
    pred, target = _pair(shape)
    got = temd.compare_luminance(torch.from_numpy(pred), torch.from_numpy(target))
    assert got.shape == (shape[0], 1, 1, 1)
    _close(got, jemd.compare_luminance(jnp.asarray(pred), jnp.asarray(target)))


@pytest.mark.parametrize("max_val", [None, 4.0])
@pytest.mark.parametrize("shape", SHAPES)
def test_psnr(shape, max_val):
    """The default max_val is the maximum of the whole target batch."""
    pred, target = _pair(shape)
    _close(tev.psnr(torch.from_numpy(pred), torch.from_numpy(target), max_val),
           jev.psnr(jnp.asarray(pred), jnp.asarray(target), max_val))


@pytest.mark.parametrize("same", [False, True], ids=["pred", "pred-is-target"])
@pytest.mark.parametrize("shape", SHAPES)
def test_si_rmse(shape, same):
    pred, target = _pair(shape)
    if same:
        pred = target.copy()
    got = tev.si_rmse(torch.from_numpy(pred), torch.from_numpy(target))
    _close(got, jev.si_rmse(jnp.asarray(pred), jnp.asarray(target)))
    if same:
        assert float(got.max()) == 0.0


@pytest.mark.parametrize("shape", SHAPES)
def test_evaluate_batch(shape):
    pred, target = _pair(shape, seed=2)
    got = tev.evaluate_batch(torch.from_numpy(pred), torch.from_numpy(target))
    want = jev.evaluate_batch(jnp.asarray(pred), jnp.asarray(target))
    assert sorted(got) == sorted(want) == ["emd", "psnr", "si_rmse"]
    for k in want:
        assert got[k].shape == (shape[0],)
        _close(got[k], want[k])


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_pred_gives_f32_metrics(shape):
    """A bf16 prediction against a float32 target: float32 metrics, in both
    packages, equal."""
    pred, target = _pair(shape, seed=3)
    got = tev.evaluate_batch(torch.from_numpy(pred).bfloat16(), torch.from_numpy(target))
    want = jev.evaluate_batch(jnp.asarray(pred).astype(jnp.bfloat16), jnp.asarray(target))
    for k in want:
        assert got[k].dtype == torch.float32 and want[k].dtype == jnp.float32, k
        _close(got[k], want[k])
