"""The port's DA conv on the CPU (the kernels' plain versions and the
autograd glue) against `skyhdr`'s XLA gather path, its Pallas kernels in
interpret mode, and `jax.vjp`."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from skyhdr.ops import distortion as jdist
from skyhdr.ops.pallas.deform_conv import deformable_conv2d_pallas
from skyhdr_torch.ops import distortion as tdist
from skyhdr_torch.ops.kernels import deform_conv as dc

# The suite runs in several worker processes that share the CPU; torch's
# default of one thread per core in each of them oversubscribes it.
torch.set_num_threads(1)

# (x shape, F): the two small shapes of tests/test_pallas.py, the slice's
# SunPoseNet stage-2 and trunk widths at a narrow size, a non-power-of-two F.
SHAPES = [((2, 8, 32, 16), 8), ((1, 16, 64, 32), 16), ((2, 8, 32, 32), 64),
          ((1, 4, 16, 128), 128), ((2, 6, 24, 8), 12)]


def _operands(rng, shape, f):
    c = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    k = (rng.normal(size=(9 * c, f)) * 0.1).astype(np.float32)
    b = rng.normal(size=(f,)).astype(np.float32)
    return x, k, b


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("shape,f", SHAPES)
def test_forward_ref_matches_xla(rng, shape, f):
    x, k, b = _operands(rng, shape, f)
    want = np.asarray(jdist.deformable_conv2d(x, k, b))
    got = dc.da_conv_forward_ref(*_t(x, k, b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,f", SHAPES[:3])
def test_forward_ref_matches_pallas_interpret(rng, shape, f):
    x, k, b = _operands(rng, shape, f)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(deformable_conv2d_pallas(x, k, b))
    got = dc.da_conv_forward_ref(*_t(x, k, b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,f", SHAPES)
def test_dx_ref_matches_jax_vjp(rng, shape, f):
    x, k, b = _operands(rng, shape, f)
    g = rng.normal(size=shape[:3] + (f,)).astype(np.float32)
    _, vjp = jax.vjp(lambda xx: jdist.deformable_conv2d(xx, k, b), x)
    want = np.asarray(vjp(g)[0])
    got = dc.da_conv_dx_ref(*_t(g, k), x_shape=shape).numpy()
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=3e-4)


@pytest.mark.parametrize("dilation,skydome", [(2, True), (1, False)])
def test_dx_ref_other_geometry(rng, dilation, skydome):
    shape, f = (1, 8, 32, 16), 8
    x, k, b = _operands(rng, shape, f)
    g = rng.normal(size=shape[:3] + (f,)).astype(np.float32)
    kw = dict(dilation_rate=dilation, skydome=skydome)
    _, vjp = jax.vjp(lambda xx: jdist.deformable_conv2d(xx, k, b, **kw), x)
    got = dc.da_conv_dx_ref(*_t(g, k), x_shape=shape, **kw).numpy()
    np.testing.assert_allclose(got, np.asarray(vjp(g)[0]), rtol=5e-3, atol=3e-4)
    fwd = dc.da_conv_forward_ref(*_t(x, k, b), **kw).numpy()
    np.testing.assert_allclose(fwd, np.asarray(jdist.deformable_conv2d(x, k, b, **kw)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,f", SHAPES[:2])
def test_autograd_function_cpu_matches_jax_vjp(rng, shape, f):
    """All three cotangents through DAConvFunction on CPU tensors."""
    x, k, b = _operands(rng, shape, f)
    g = rng.normal(size=shape[:3] + (f,)).astype(np.float32)
    xt, kt, bt = (a.requires_grad_() for a in _t(x, k, b))
    y = dc.da_conv(xt, kt, bt)
    y.backward(torch.from_numpy(g))
    _, vjp = jax.vjp(jdist.deformable_conv2d, x, k, b)
    for name, got, want in zip(("dx", "dk", "db"), (xt.grad, kt.grad, bt.grad),
                               vjp(g)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=5e-3, atol=3e-4, err_msg=name)


def test_autograd_function_input_grad_only(rng):
    """The serving case: weights need no gradient, only dx flows."""
    x, k, b = _operands(rng, (1, 8, 32, 16), 8)
    g = rng.normal(size=(1, 8, 32, 8)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    kt, bt = _t(k, b)
    (dx,) = torch.autograd.grad(dc.da_conv(xt, kt, bt), xt, torch.from_numpy(g))
    assert kt.grad is None and bt.grad is None
    want = dc.da_conv_dx_ref(*_t(g, k), x_shape=x.shape)
    assert torch.equal(dx, want)


def test_cpu_path_launches_no_kernel(rng):
    x, k, b = _operands(rng, (1, 8, 32, 16), 8)
    before = (dc.K1_LAUNCHES, dc.K2_LAUNCHES)
    xt = torch.from_numpy(x).requires_grad_()
    dc.da_conv(xt, *_t(k, b)).sum().backward()
    assert (dc.K1_LAUNCHES, dc.K2_LAUNCHES) == before


@pytest.mark.parametrize("shape,f", SHAPES[:3])
def test_forward_ref_bf16(rng, shape, f):
    x, k, b = _operands(rng, shape, f)
    xb = torch.from_numpy(x).bfloat16()
    got = dc.da_conv_forward_ref(xb, *_t(k, b))
    assert got.dtype == torch.bfloat16
    want = np.asarray(jdist.deformable_conv2d(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16), k, b)
        .astype(jnp.float32))
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= 2e-2, err


def test_bf16_backward_dtype(rng):
    x, k, b = _operands(rng, (1, 8, 32, 16), 8)
    xb = torch.from_numpy(x).bfloat16().requires_grad_()
    y = dc.da_conv(xb, *_t(k, b))
    (dx,) = torch.autograd.grad(y.float().sum(), xb)
    assert dx.dtype == torch.bfloat16
    want = dc.da_conv_dx_ref(torch.ones(1, 8, 32, 8), torch.from_numpy(k),
                             x_shape=x.shape)
    err = (dx.float() - want).abs().max() / want.abs().max()
    assert err <= 2e-2, err


def test_odd_kernel_plain_path(rng):
    """k=5 on the CPU takes the plain versions of K5 (the gather form) and,
    backward, of K6 and K7."""
    shape, f = (1, 8, 32, 8), 6
    x = rng.normal(size=shape).astype(np.float32)
    k = (rng.normal(size=(25 * 8, f)) * 0.1).astype(np.float32)
    b = rng.normal(size=(f,)).astype(np.float32)
    g = rng.normal(size=shape[:3] + (f,)).astype(np.float32)
    xt, kt, bt = (a.requires_grad_() for a in _t(x, k, b))
    got = dc.da_conv(xt, kt, bt, kernel_size=5)
    want = np.asarray(jdist.deformable_conv2d(x, k, b, kernel_size=5))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-4)
    got.backward(torch.from_numpy(g))
    _, vjp = jax.vjp(lambda *a: jdist.deformable_conv2d(*a, kernel_size=5), x, k, b)
    for name, grad, w in zip(("dx", "dk", "db"), (xt.grad, kt.grad, bt.grad), vjp(g)):
        np.testing.assert_allclose(grad.numpy(), np.asarray(w), rtol=5e-3, atol=3e-4,
                                   err_msg=name)


@pytest.mark.parametrize("deconv", [False, True])
def test_layers_match_flax(rng, deconv):
    """DAConv / DADeconv with the same parameters as their Flax twins."""
    x = rng.normal(size=(2, 4, 16, 16)).astype(np.float32)
    if deconv:
        jmod = jdist.DADeconv(8, out_hw=(8, 32), backend="xla")
        tmod = tdist.DADeconv(16, 8, (8, 32))
    else:
        jmod = jdist.DAConv(8, backend="xla")
        tmod = tdist.DAConv(16, 8)
    params = jax.tree_util.tree_map(np.asarray,
                                    jmod.init(jax.random.PRNGKey(0), x))
    bias = rng.normal(size=(8,)).astype(np.float32)
    params["params"]["bias"] = bias
    with torch.no_grad():
        tmod.kernel.copy_(torch.from_numpy(params["params"]["kernel"]))
        tmod.bias.copy_(torch.from_numpy(bias))
        got = tmod(torch.from_numpy(x)).numpy()
    want = np.asarray(jmod.apply(params, x))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
