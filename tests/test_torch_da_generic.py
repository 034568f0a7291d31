"""The odd-k DA conv of the port on the CPU: the generic `scatter_tables`
copy, the plain versions of K5 (forward), K6 (dK) and K7 (dx) against
`skyhdr`'s XLA gather path, its `jax.vjp` and the interpret-mode Pallas
kernels they replace, and the autograd glue at k=5. The `da_kernel_size=5`
model and GAN step are in `tests/test_torch_da5.py`.

Tolerances, relative to the largest value of the result: forward and dK
1e-4, dx 5e-4 (the same f32 arithmetic summed in another order)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import skyhdr.ops.distortion as jdist
import skyhdr_torch.ops.distortion as tdist
from skyhdr.ops.pallas.deform_conv import _pallas_dk, _pallas_dx, _pallas_forward
from skyhdr_torch.ops.kernels import deform_conv as dc

# The suite runs in several worker processes that share the CPU; torch's
# default of one thread per core in each of them oversubscribes it.
torch.set_num_threads(1)

TOL = {"fwd": 1e-4, "dk": 1e-4, "dx": 5e-4}


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _operands(rng, shape, f, k):
    c = shape[-1]
    x = rng.normal(size=shape).astype(np.float32)
    kern = (rng.normal(size=(k * k * c, f)) * 0.1).astype(np.float32)
    b = rng.normal(size=(f,)).astype(np.float32)
    g = rng.normal(size=shape[:3] + (f,)).astype(np.float32)
    return x, kern, b, g


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax(x, kern, b, g, k, dilation=1, skydome=True):
    """The XLA gather path's output and (dx, dK, db) by `jax.vjp`."""
    out, vjp = jax.vjp(lambda *a: jdist.deformable_conv2d(
        *a, kernel_size=k, dilation_rate=dilation, skydome=skydome), x, kern, b)
    return [np.asarray(out)] + [np.asarray(v) for v in vjp(g)]


# --- (a) the table copy ---------------------------------------------------

@pytest.mark.parametrize("k", [5, 7])
@pytest.mark.parametrize("dilation,skydome", [(1, True), (2, True), (1, False), (2, False)])
@pytest.mark.parametrize("h,w", [(8, 32), (9, 24), (16, 64)])
def test_scatter_tables_equal(k, dilation, skydome, h, w):
    got = tdist.scatter_tables(h, w, k, 1, dilation, skydome)
    want = jdist.scatter_tables(h, w, k, 1, dilation, skydome)
    assert got._fields == want._fields and got.nrefs == want.nrefs
    for name, a, b in zip(want._fields[:-1], got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b), name


def test_scatter_tables_on_device_match_numpy():
    st = tdist.scatter_tables(16, 64, 5)
    got, nrefs = tdist.scatter_tables_on(torch.device("cpu"), 16, 64, 5)
    assert nrefs == st.nrefs == 50
    for a, b in zip(got, (st.ri, st.rt, st.rw, st.rcx, st.rwx)):
        assert np.array_equal(a.numpy(), b)


# --- (b) the plain versions against the XLA path and jax.vjp --------------

# (k, x shape, F): a small map, an odd height with C=3 (the k=7 sun-pose
# input's width), and the trunk's width at k=5.
PLAIN_CASES = [(k, (2, 8, 32, 16), 8) for k in (3, 5, 7)] + [
    (k, (1, 9, 24, 3), 12) for k in (3, 5, 7)] + [(5, (1, 4, 16, 128), 128)]


@pytest.mark.parametrize("k,shape,f", PLAIN_CASES)
def test_plain_versions_match_jax(rng, k, shape, f):
    x, kern, b, g = _operands(rng, shape, f, k)
    out, want_dx, want_dk, _ = _jax(x, kern, b, g, k)
    xt, kt, bt, gt = _t(x, kern, b, g)
    assert _rel(dc.da_conv_forward_ref(xt, kt, bt, kernel_size=k), out) <= TOL["fwd"]
    dk = dc.da_conv_dk_ref(xt, gt, kernel_size=k)
    assert dk.shape == (k * k * shape[-1], f) and _rel(dk, want_dk) <= TOL["dk"]
    dx = (dc.da_conv_dx_ref(gt, kt, x_shape=shape) if k == 3 else
          dc.da_conv_dx_ref_generic(gt, kt, x_shape=shape, kernel_size=k))
    assert dx.dtype == torch.float32 and _rel(dx, want_dx) <= TOL["dx"]


@pytest.mark.parametrize("k,dilation,skydome", [(5, 2, True), (5, 1, False), (7, 1, False)])
def test_plain_versions_other_geometry(rng, k, dilation, skydome):
    x, kern, b, g = _operands(rng, (1, 8, 32, 8), 8, k)
    out, want_dx, want_dk, _ = _jax(x, kern, b, g, k, dilation, skydome)
    geom = dict(kernel_size=k, dilation_rate=dilation, skydome=skydome)
    xt, kt, bt, gt = _t(x, kern, b, g)
    assert _rel(dc.da_conv_forward_ref(xt, kt, bt, **geom), out) <= TOL["fwd"]
    assert _rel(dc.da_conv_dk_ref(xt, gt, **geom), want_dk) <= TOL["dk"]
    assert _rel(dc.da_conv_dx_ref_generic(gt, kt, x_shape=x.shape, **geom),
                want_dx) <= TOL["dx"]


# --- (c) against the TPU kernels themselves, in interpret mode ------------

def test_plain_versions_match_pallas_interpret(rng):
    """`_kernel_body`, `_dk_kernel` and `_dx_kernel`, the kernels K5, K6 and
    K7 replace, run by the Pallas interpreter at k=5."""
    k, shape, f = 5, (1, 8, 32, 8), 8
    x, kern, b, g = _operands(rng, shape, f, k)
    geom = dict(kernel_size=k, dilation_rate=1, skydome=True, interpret=True)
    fwd = np.asarray(_pallas_forward(jnp.asarray(x), jnp.asarray(kern), **geom))
    dk = np.asarray(_pallas_dk(jnp.asarray(x), jnp.asarray(g), f=f, **geom))
    dx = np.asarray(_pallas_dx(jnp.asarray(g), jnp.asarray(kern), x_shape=shape, **geom))
    xt, kt, bt, gt = _t(x, kern, np.zeros(f, np.float32), g)
    assert _rel(dc.da_conv_forward_ref(xt, kt, bt, kernel_size=k), fwd) <= TOL["fwd"]
    assert _rel(dc.da_conv_dk_ref(xt, gt, kernel_size=k), dk) <= TOL["dk"]
    assert _rel(dc.da_conv_dx_ref_generic(gt, kt, x_shape=shape, kernel_size=k),
                dx) <= TOL["dx"]


# --- (d) the autograd glue at k=5 on the CPU ------------------------------

@pytest.mark.parametrize("shape,f", [((2, 8, 32, 16), 8), ((1, 9, 24, 3), 4)])
def test_autograd_function_k5_matches_jax_vjp(rng, shape, f):
    x, kern, b, g = _operands(rng, shape, f, 5)
    _, *want = _jax(x, kern, b, g, 5)
    xt, kt, bt = (a.requires_grad_() for a in _t(x, kern, b))
    before = [getattr(dc, f"K{n}_LAUNCHES") for n in (1, 2, 3, 5, 6, 7)]
    dc.da_conv(xt, kt, bt, kernel_size=5).backward(torch.from_numpy(g))
    assert [getattr(dc, f"K{n}_LAUNCHES") for n in (1, 2, 3, 5, 6, 7)] == before
    for name, got, w in zip(("dx", "dk", "db"), (xt.grad, kt.grad, bt.grad), want):
        assert _rel(got, w) <= TOL["dx"], name


def test_input_grads_only_k5(rng):
    """Inside `input_grads_only` the k=5 backward returns dx alone (K7's
    plain version), though the weights require gradients."""
    x, kern, b, g = _operands(rng, (1, 8, 32, 16), 8, 5)
    xt, kt, bt = (a.requires_grad_() for a in _t(x, kern, b))
    y = dc.da_conv(xt, kt, bt, kernel_size=5)
    with dc.input_grads_only():
        (dx,) = torch.autograd.grad(y, xt, torch.from_numpy(g), retain_graph=True)
    assert kt.grad is None and bt.grad is None
    want = dc.da_conv_dx_ref_generic(torch.from_numpy(g), kt.detach(), x_shape=x.shape,
                                     kernel_size=5)
    assert torch.equal(dx, want)
    y.backward(torch.from_numpy(g))
    assert kt.grad is not None and bt.grad is not None


def test_even_kernel_size_raises(rng):
    x, kern, b, _ = _operands(rng, (1, 8, 32, 8), 8, 4)
    with pytest.raises(ValueError, match="odd"):
        dc.da_conv(*_t(x, kern, b), kernel_size=4)
