"""The fused InstanceNorm + activation of the port (K8/K9's plain versions
and `InstanceNormActFunction`) against `skyhdr.ops.pallas.instnorm` run in
interpret mode on the CPU, and the fused model configuration
(`fused_instance_norm=True`) against `skyhdr`.

Tolerances, and why:
  - forward: absolute 2e-6 in float32 and 2e-3 in bfloat16, those of
    `tests/test_instnorm_fused.py` (the same formula, summed in another
    order; bf16 output rounding);
  - mean / rstd: 1e-6 relative;
  - backward against `jax.vjp` under a sin-shaped cotangent: rtol 2e-4,
    atol 2e-5, those of `tests/test_instnorm_fused.py` for the gradients;
  - the fused serving forward: rtol / atol 1e-3, as the unfused forward in
    `tests/test_torch_slice.py`;
  - the fused GAN and sun steps against the stored JAX values of
    `tests/fixtures/torch_golden_train_16x64.npz`: metrics rtol 1e-4 and
    per-leaf update digests within 1e-2 of the leaf's summed |update|, the
    tolerances of `tests/test_torch_train.py`. On the CPU the JAX flag
    computes the XLA composition (its Pallas kernel serves the TPU only),
    which the first model test shows is the unfused function, so the
    unfused fixture is JAX's value for the fused configuration as well."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyhdr.config import Config, DataConfig, ModelConfig
from skyhdr.ops.pallas import instnorm as jin
from skyhdr.train.engine import make_inference_fn as j_make_inference_fn
from skyhdr_torch.ops.kernels import instnorm as tin
from skyhdr_torch.train.engine import build_models, make_inference_fn
from skyhdr_torch.utils.transplant import init_model_vars, load_model_vars

# The suite runs in several worker processes that share the CPU; torch's
# default of one thread per core in each of them oversubscribes it.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ALPHAS = [1.0, 0.0, 0.1]
CHANNELS = [32, 64, 128]


def _inputs(c, dtype=np.float32, shape=(2, 8, 16), seed=0):
    rng = np.random.default_rng(seed + c)
    x = (rng.standard_normal(shape + (c,)) * 2 + 0.3).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = (rng.standard_normal(c) * 0.1).astype(np.float32)
    dy = np.sin(3.0 * rng.standard_normal(shape + (c,))).astype(np.float32)
    if dtype != np.float32:
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x, gamma, beta, dy


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a)).to(dtype)


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k8_plain_matches_pallas_interpret(c, alpha, dtype):
    x, gamma, beta, _ = _inputs(c, dtype)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jin.instance_norm_act(jnp.asarray(x, jdt), gamma, beta, alpha=alpha,
                                 backend="pallas", interpret=True)
    _, jmean, jrstd = jin._pallas_fwd(jnp.asarray(x, jdt), gamma, beta, 1e-3, alpha,
                                      interpret=True)
    y, mean, rstd = tin.instance_norm_act_ref(_t(x, tdt), _t(gamma), _t(beta),
                                              alpha=alpha)
    assert y.dtype == tdt and mean.shape == rstd.shape == (2, c)
    tol = 2e-6 if dtype == "float32" else 2e-3
    np.testing.assert_allclose(y.float().numpy(), np.asarray(want, np.float32), atol=tol)
    np.testing.assert_allclose(mean.numpy(), np.asarray(jmean)[:, 0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd)[:, 0], rtol=1e-6)


def _jax_vjp(x, gamma, beta, dy, alpha):
    fn = lambda a, g, b: jin.instance_norm_act(a, g, b, alpha=alpha, backend="pallas",
                                               interpret=True)
    _, pull = jax.vjp(fn, jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta))
    return [np.asarray(v) for v in pull(jnp.asarray(dy))]


def _check_grads(got, want):
    for name, a, b in zip(("dx", "dgamma", "dbeta"), got, want):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("alpha", ALPHAS)
def test_k9_plain_matches_jax_vjp(c, alpha):
    x, gamma, beta, dy = _inputs(c)
    _, mean, rstd = tin.instance_norm_act_ref(_t(x), _t(gamma), _t(beta), alpha=alpha)
    got = tin.instance_norm_act_bwd_ref(_t(x), _t(dy), _t(gamma), _t(beta), mean, rstd,
                                        alpha=alpha)
    _check_grads([g.numpy() for g in got], _jax_vjp(x, gamma, beta, dy, alpha))


@pytest.mark.parametrize("alpha", ALPHAS)
def test_function_on_cpu_matches_pallas_interpret(alpha):
    x, gamma, beta, dy = _inputs(64)
    xt, gt, bt = (_t(a).requires_grad_() for a in (x, gamma, beta))
    y = tin.instance_norm_act(xt, gt, bt, alpha=alpha)
    want = jin.instance_norm_act(jnp.asarray(x), gamma, beta, alpha=alpha,
                                 backend="pallas", interpret=True)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want), atol=2e-6)
    y.backward(_t(dy))
    _check_grads([xt.grad.numpy(), gt.grad.numpy(), bt.grad.numpy()],
                 _jax_vjp(x, gamma, beta, dy, alpha))


def test_function_frozen_affine_returns_dx_only():
    """γ/β not requiring gradients: the backward returns dx alone, and dx is
    that of the full vjp."""
    x, gamma, beta, dy = _inputs(32)
    xt = _t(x).requires_grad_()
    gt, bt = _t(gamma), _t(beta)
    y = tin.instance_norm_act(xt, gt, bt, alpha=0.1)
    (dx,) = torch.autograd.grad(y, (xt,), _t(dy))
    assert gt.grad is None and bt.grad is None
    np.testing.assert_allclose(dx.numpy(), _jax_vjp(x, gamma, beta, dy, 0.1)[0],
                               rtol=2e-4, atol=2e-5)


def test_cuda_path_needs_the_card():
    """A CUDA tensor never takes the plain version: without a card the
    wrapper fails instead of computing something else."""
    x = torch.zeros(1, 2, 4, 8)
    with pytest.raises(ValueError, match="CUDA"):
        tin.instance_norm_act_k8(x, torch.ones(8), torch.zeros(8))


def _cfg(fused: bool):
    return Config(model=ModelConfig(im_height=16, im_width=64, use_da_conv=True,
                                    da_backend="xla", fused_instance_norm=fused),
                  data=DataConfig(batch_size=2))


@pytest.fixture(scope="module")
def serving():
    """(cfg, gen_vars, sun_vars, input, JAX outputs with the flag)."""
    cfg = _cfg(True)
    gv, sv = init_model_vars(cfg, 0)
    x = np.random.default_rng(1).uniform(0, 1, (2, 16, 64, 3)).astype(np.float32)
    want = j_make_inference_fn(cfg)(gv, sv, jnp.asarray(x))
    return cfg, gv, sv, x, {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize("act", ["none", "relu", "lrelu01"])
def test_fused_flag_is_the_same_function_in_skyhdr(act):
    """skyhdr's InstanceNorm with `fuse`, on the CPU, is the unfused
    composition bit for bit."""
    from skyhdr.models.layers import InstanceNorm as JInstanceNorm

    x = jnp.asarray(_inputs(32)[0])
    v = JInstanceNorm().init(jax.random.PRNGKey(0), x)
    np.testing.assert_array_equal(np.asarray(JInstanceNorm(fuse=True).apply(v, x, act=act)),
                                  np.asarray(JInstanceNorm().apply(v, x, act=act)))


def test_fused_serving_forward_matches_skyhdr(serving):
    cfg, gv, sv, x, want = serving
    gen, sun = build_models(cfg, "cpu")
    load_model_vars(gen, gv)
    load_model_vars(sun, sv)
    assert all(m.fuse for m in (*gen.modules(), *sun.modules())
               if type(m).__name__ == "InstanceNorm")
    got = make_inference_fn(cfg)(gen, sun, torch.from_numpy(x))
    assert np.array_equal(got["sunpose_pred"].numpy().reshape(2, -1).argmax(-1),
                          want["sunpose_pred"].reshape(2, -1).argmax(-1))
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), want[name], rtol=1e-3, atol=1e-3,
                                   err_msg=name)


def _golden_module():
    spec = importlib.util.spec_from_file_location(
        "make_torch_golden", os.path.join(ROOT, "tools", "make_torch_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fused_gan_and_sun_steps_match_skyhdr():
    G = _golden_module()
    stored = np.load(G.TRAIN_FIXTURE)
    port = G.port_train_golden(stored, "cpu", fused_instance_norm=True)
    fails, worst = G.compare_train_golden(stored, port, 1e-4, 1e-2)
    assert not fails, (fails, worst)
