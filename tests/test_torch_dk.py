"""K3's plain version (`da_conv_dk_ref`, the DA weight gradient) and the
backward wiring of `DAConvFunction` on the CPU, against `jax.vjp` of
`skyhdr`'s XLA gather path and its `_pallas_dk` kernel in interpret mode.

Tolerance rtol 5e-3 / atol 3e-4, as tests/test_pallas.py holds the Pallas
backward: dK sums b*h*w products, and the order of that sum differs."""

import numpy as np
import jax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from skyhdr.ops import distortion as jdist
from skyhdr.ops.pallas.deform_conv import _pallas_dk
from skyhdr_torch.ops.kernels import deform_conv as dc

# The suite runs in several worker processes that share the CPU; torch's
# default of one thread per core in each of them oversubscribes it.
torch.set_num_threads(1)

# The shapes of tests/test_torch_da.py.
SHAPES = [((2, 8, 32, 16), 8), ((1, 16, 64, 32), 16), ((2, 8, 32, 32), 64),
          ((1, 4, 16, 128), 128), ((2, 6, 24, 8), 12)]
GEOMETRY = [(1, True), (2, True), (1, False)]
TOL = dict(rtol=5e-3, atol=3e-4)


def _operands(rng, shape, f):
    c = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    k = (rng.normal(size=(9 * c, f)) * 0.1).astype(np.float32)
    b = rng.normal(size=(f,)).astype(np.float32)
    g = rng.normal(size=shape[:3] + (f,)).astype(np.float32)
    return x, k, b, g


def _jax_grads(x, k, b, g, dilation=1, skydome=True):
    _, vjp = jax.vjp(lambda *a: jdist.deformable_conv2d(
        *a, dilation_rate=dilation, skydome=skydome), x, k, b)
    return [np.asarray(v) for v in vjp(g)]


@pytest.mark.parametrize("shape,f", SHAPES)
def test_dk_ref_matches_jax_vjp(rng, shape, f):
    x, k, b, g = _operands(rng, shape, f)
    _, want_dk, _ = _jax_grads(x, k, b, g)
    got = dc.da_conv_dk_ref(torch.from_numpy(x), torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.shape == (9 * shape[-1], f)
    np.testing.assert_allclose(got.numpy(), want_dk, **TOL)


@pytest.mark.parametrize("dilation,skydome", GEOMETRY[1:])
def test_dk_ref_other_geometry(rng, dilation, skydome):
    x, k, b, g = _operands(rng, (1, 8, 32, 16), 8)
    _, want_dk, _ = _jax_grads(x, k, b, g, dilation, skydome)
    got = dc.da_conv_dk_ref(torch.from_numpy(x), torch.from_numpy(g),
                            dilation_rate=dilation, skydome=skydome)
    np.testing.assert_allclose(got.numpy(), want_dk, **TOL)


@pytest.mark.parametrize("shape,f,dilation,skydome",
                         [(s, f, 1, True) for s, f in SHAPES[:3]]
                         + [((1, 8, 32, 16), 8, 2, True), ((1, 8, 32, 16), 8, 1, False)])
def test_dk_ref_matches_pallas_interpret(rng, shape, f, dilation, skydome):
    """The TPU kernel K3 replaces, run by the Pallas interpreter."""
    x, _, _, g = _operands(rng, shape, f)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_pallas_dk(x, g, kernel_size=3, dilation_rate=dilation,
                                     skydome=skydome, f=f))
    got = dc.da_conv_dk_ref(torch.from_numpy(x), torch.from_numpy(g),
                            dilation_rate=dilation, skydome=skydome)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_dk_ref_reads_bf16_x_as_f32(rng):
    x, _, _, g = _operands(rng, (2, 8, 32, 16), 8)
    xb = torch.from_numpy(x).bfloat16()
    got = dc.da_conv_dk_ref(xb, torch.from_numpy(g))
    want = dc.da_conv_dk_ref(xb.float(), torch.from_numpy(g))
    assert got.dtype == torch.float32 and torch.equal(got, want)


@pytest.mark.parametrize("dilation,skydome", GEOMETRY)
def test_autograd_function_all_cotangents(rng, dilation, skydome):
    """dx, dK and db through `DAConvFunction` on CPU tensors."""
    x, k, b, g = _operands(rng, (2, 8, 32, 16), 8)
    xt, kt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, k, b))
    dc.da_conv(xt, kt, bt, dilation_rate=dilation, skydome=skydome).backward(
        torch.from_numpy(g))
    want = _jax_grads(x, k, b, g, dilation, skydome)
    for name, got, w in zip(("dx", "dk", "db"), (xt.grad, kt.grad, bt.grad), want):
        np.testing.assert_allclose(got.numpy(), w, err_msg=name, **TOL)


@pytest.mark.parametrize("needs", ["kernel", "bias"])
def test_autograd_function_weight_grads_only_when_asked(rng, needs):
    """dK and db are computed only for the operands that need them."""
    x, k, b, g = _operands(rng, (1, 8, 32, 16), 8)
    xt, kt, bt = (torch.from_numpy(a) for a in (x, k, b))
    target = kt if needs == "kernel" else bt
    target.requires_grad_()
    (grad,) = torch.autograd.grad(dc.da_conv(xt, kt, bt), target, torch.from_numpy(g))
    want = _jax_grads(x, k, b, g)[1 if needs == "kernel" else 2]
    np.testing.assert_allclose(grad.numpy(), want, **TOL)


def test_input_grads_only_skips_weight_grads(rng):
    """Grad-CAM's pull: inside `input_grads_only` the backward returns dx
    alone, though the weights require gradients; outside it, all three."""
    x, k, b, g = _operands(rng, (1, 8, 32, 16), 8)
    xt, kt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, k, b))
    y = dc.da_conv(xt, kt, bt)
    with dc.input_grads_only():
        (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(g), retain_graph=True)
    assert torch.equal(dx, dc.da_conv_dx_ref(torch.from_numpy(g), kt.detach(),
                                             x_shape=x.shape))
    y.backward(torch.from_numpy(g))
    assert kt.grad is not None and bt.grad is not None


def test_cpu_backward_launches_no_kernel(rng):
    x, k, b, g = _operands(rng, (1, 8, 32, 16), 8)
    before = (dc.K1_LAUNCHES, dc.K2_LAUNCHES, dc.K3_LAUNCHES)
    xt, kt, bt = (torch.from_numpy(a).requires_grad_() for a in (x, k, b))
    dc.da_conv(xt, kt, bt).backward(torch.from_numpy(g))
    assert (dc.K1_LAUNCHES, dc.K2_LAUNCHES, dc.K3_LAUNCHES) == before
