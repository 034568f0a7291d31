"""Tests of the port that need a CUDA card (marker `gpu`). They import no
JAX, so they also run where only the port is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Without a card each test skips with a reason."""

import pytest
import torch

from skyhdr_torch.ops.kernels import deform_conv as dc

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _operands(cuda, shape, f, dtype=torch.float32):
    gen = torch.Generator(device=cuda).manual_seed(0)
    c = shape[-1]
    x = torch.randn(shape, device=cuda, generator=gen).to(dtype)
    k = torch.randn(9 * c, f, device=cuda, generator=gen) * 0.05
    b = torch.randn(f, device=cuda, generator=gen)
    g = torch.randn(shape[:3] + (f,), device=cuda, generator=gen)
    return x, k, b, g


def _rel(a, b):
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()).item()


@pytest.mark.parametrize("shape,f", [((2, 16, 64, 32), 64), ((2, 8, 32, 128), 128),
                                     ((1, 32, 128, 64), 32)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_k1_matches_plain(cuda, shape, f, dtype, tol):
    x, k, b, _ = _operands(cuda, shape, f, dtype)
    n = dc.K1_LAUNCHES
    got = dc.da_conv_forward_k1(x, k, b)
    torch.cuda.synchronize()
    assert dc.K1_LAUNCHES == n + 1 and got.dtype == dtype
    assert _rel(got, dc.da_conv_forward_ref(x, k, b)) <= tol


@pytest.mark.parametrize("shape,f", [((2, 16, 64, 32), 64), ((2, 8, 32, 128), 128)])
def test_k2_matches_plain(cuda, shape, f):
    _, k, _, g = _operands(cuda, shape, f)
    n = dc.K2_LAUNCHES
    got = dc.da_conv_dx_k2(g, k, x_shape=shape)
    torch.cuda.synchronize()
    assert dc.K2_LAUNCHES == n + 1
    assert _rel(got, dc.da_conv_dx_ref(g, k, x_shape=shape)) <= 5e-4


@pytest.mark.parametrize("shape,f", [((2, 8, 32, 128), 128), ((2, 32, 128, 64), 32),
                                     ((2, 16, 64, 32), 64), ((1, 6, 24, 8), 12)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_matches_plain(cuda, shape, f, dtype):
    x, _, _, g = _operands(cuda, shape, f, dtype)
    n = dc.K3_LAUNCHES
    got = dc.da_conv_dk_k3(x, g)
    torch.cuda.synchronize()
    assert dc.K3_LAUNCHES == n + 1 and got.shape == (9 * shape[-1], f)
    assert _rel(got, dc.da_conv_dk_ref(x, g)) <= 1e-4
    assert torch.equal(got, dc.da_conv_dk_k3(x, g))  # fixed summation order


def test_autograd_function_on_cuda_takes_kernels(cuda):
    x, k, b, g = _operands(cuda, (2, 8, 32, 16), 8)
    x.requires_grad_()
    k.requires_grad_()
    b.requires_grad_()
    before = (dc.K1_LAUNCHES, dc.K2_LAUNCHES, dc.K3_LAUNCHES)
    dc.da_conv(x, k, b).backward(g)
    torch.cuda.synchronize()
    assert (dc.K1_LAUNCHES, dc.K2_LAUNCHES, dc.K3_LAUNCHES) == tuple(
        n + 1 for n in before)
    assert _rel(k.grad, dc.da_conv_dk_ref(x.detach(), g)) <= 1e-4
    assert _rel(b.grad, g.sum((0, 1, 2))) <= 1e-5
    assert _rel(x.grad, dc.da_conv_dx_ref(g, k.detach(), x_shape=x.shape)) <= 5e-4


def test_unsupported_width_raises(cuda):
    x, k, b, _ = _operands(cuda, (1, 8, 32, 16), 6)
    with pytest.raises(RuntimeError, match="K1"):
        dc.da_conv_forward_k1(x, k, b)
