"""K13, the optimizer update as one CUDA pass (csrc/optim.cu,
`skyhdr_torch/ops/kernels/optim.py`), on the CPU.

The kernel itself runs only on a card (`tests/test_torch_gpu.py` holds it
bit for bit to the eager chain there). Here: the per-element formula it
follows (`optim_step_ref`, with the constants `_consts` hands it) is
bit-equal to the eager chain (`_Optimizer.step_plain`) for RMSprop and
Adam under every storage-knob combination over three steps, including a
float32 moment loaded into a bfloat16-storing optimizer; the kernel's
arguments (`k13_args`); and the route: a CPU leaf takes the eager chain and
never builds or counts the kernel, the wrapper refuses CPU tensors, and a
non-contiguous leaf raises.
"""

import numpy as np
import pytest
import torch

from skyhdr_torch.ops.kernels import build as kbuild
from skyhdr_torch.ops.kernels import optim as ok
from skyhdr_torch.train import optim

torch.set_num_threads(1)

SHAPES = [(7,), (3, 5), (64, 33), (2, 3, 4, 9), (1,)]
LR = 2e-4
# (opt_state_dtype, grad dtype, param_dtype, moments loaded as float32)
CASES = {
    "f32": ("float32", "float32", "float32", False),
    "bf16_moments": ("bfloat16", "float32", "float32", False),
    "bf16_grads": ("float32", "bfloat16", "float32", False),
    "bf16_moments_grads": ("bfloat16", "bfloat16", "float32", False),
    "master": ("float32", "float32", "bfloat16", False),
    "master_bf16_grads": ("float32", "bfloat16", "bfloat16", False),
    "bf16_everything": ("bfloat16", "bfloat16", "bfloat16", False),
    "f32_moments_into_bf16": ("bfloat16", "float32", "float32", True),
}


def _grads(rng, dtype):
    """Gradients of 10^U(-4, 2) magnitudes with either sign and a few
    exact zeros."""
    out = []
    for shape in SHAPES:
        g = rng.standard_normal(shape) * 10.0 ** rng.uniform(-4, 2, shape)
        g[rng.random(shape) < 0.05] = 0.0
        out.append(torch.from_numpy(g.astype(np.float32)).to(optim.storage_dtype(dtype)))
    return out


def _pair(kind, case):
    """Two optimizers of `kind` in the same state under `case`, with
    nonzero moments drawn 10^U(-3, 3) (as a checkpoint holds them)."""
    opt_dtype, _, param_dtype, loaded = CASES[case]
    rng = np.random.default_rng(3)
    p32 = [torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in SHAPES]
    cls = optim.Adam if kind == "adam" else optim.RMSprop
    names = cls.MOMENTS
    held = {n: [torch.from_numpy((10.0 ** rng.uniform(-3, 3, s)
                                  * (rng.standard_normal(s) if n == "mu" else 1.0))
                                 .astype(np.float32)) for s in SHAPES] for n in names}
    saved = torch.float32 if loaded else optim.storage_dtype(opt_dtype)
    opts = []
    for _ in range(2):
        params = [p.to(optim.storage_dtype(param_dtype)) for p in p32]
        opt = cls(params, LR, opt_state_dtype=opt_dtype, param_dtype=param_dtype)
        state = {n: [t.to(saved) for t in held[n]] for n in names}
        if opt.master is not None:
            state["master"] = [p.clone() for p in p32]
        opt.load_moments({**state, "count": 2} if kind == "adam" else state)
        opts.append(opt)
    return opts


def _formula_step(opt, grads):
    """`_Optimizer.step`'s kernel route with `optim_step_ref` in K13's
    place, on flat views of each leaf."""
    opt._begin()
    for i, (p, g) in enumerate(zip(opt.params, grads)):
        master = None if opt.master is None else opt.master[i].view(-1)
        moments = [getattr(opt, n)[i] for n in opt.MOMENTS]
        mu, nu = moments if len(moments) == 2 else (None, moments[0])
        term = g.dtype if master is None else torch.float32
        ok.optim_step_ref(mu is not None, p.view(-1), g.reshape(-1),
                          None if mu is None else mu.view(-1), nu.view(-1), master,
                          opt._consts(term))
        for name, m in zip(opt.MOMENTS, moments):
            if m.dtype != opt.store:
                getattr(opt, name)[i] = m.to(opt.store)


def _tensors(opt):
    out = {"params": opt.params, **{n: getattr(opt, n) for n in opt.MOMENTS}}
    if opt.master is not None:
        out["master"] = opt.master
    return out


def _assert_same_bits(a, b):
    for name, xs in _tensors(a).items():
        for i, (x, y) in enumerate(zip(xs, _tensors(b)[name])):
            assert x.dtype == y.dtype, (name, i, x.dtype, y.dtype)
            assert torch.equal(x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32),
                               y.view(torch.int16 if y.dtype == torch.bfloat16 else torch.int32)), \
                (name, i, (x.float() - y.float()).abs().max().item())


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", ["rmsprop", "adam"])
def test_formula_is_the_eager_chain_bit_for_bit(kind, case):
    """Three steps of the kernel's formula and of the eager chain from the
    same state: every parameter, moment and master the same bits, and
    each stored in the dtype the chain leaves it in."""
    chain, formula = _pair(kind, case)
    rng = np.random.default_rng(11)
    for _ in range(3):
        grads = _grads(rng, CASES[case][1])
        chain.step_plain(grads)
        _formula_step(formula, grads)
        _assert_same_bits(chain, formula)
    if kind == "adam":
        assert chain.count == formula.count == 5
    start = _pair(kind, case)[0]
    weights = [(chain.master or chain.params), (start.master or start.params)]
    assert all(not torch.equal(w, w0) for w, w0 in zip(*weights))


@pytest.mark.parametrize("kind", ["rmsprop", "adam"])
def test_cpu_leaves_take_the_eager_chain(kind, monkeypatch):
    """`step` on CPU leaves runs the chain: no build, no launch counted,
    the bits of `step_plain`."""
    def no_build():
        raise AssertionError("a CPU step reached the kernel library")

    monkeypatch.setattr(kbuild, "library", no_build)
    a, b = _pair(kind, "bf16_moments_grads")
    before = ok.K13_LAUNCHES
    grads = _grads(np.random.default_rng(5), "bfloat16")
    a.step(grads)
    b.step_plain(grads)
    assert ok.K13_LAUNCHES == before
    _assert_same_bits(a, b)


def test_the_wrapper_refuses_cpu_tensors():
    """No fallback in the wrapper: a CPU leaf handed to K13 raises."""
    p, g, nu = torch.zeros(8), torch.ones(8), torch.zeros(8)
    c = optim.RMSprop([p], LR)._consts(torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        ok.optim_step_k13(False, p, g, None, nu, None, c)


@pytest.mark.parametrize("member", ["params", "nu", "master"])
def test_a_non_contiguous_leaf_raises(member):
    param_dtype = "bfloat16" if member == "master" else "float32"
    dtype = optim.storage_dtype(param_dtype)
    opt = optim.RMSprop([torch.zeros(4, 6, dtype=dtype)], LR, param_dtype=param_dtype)
    lst = getattr(opt, member)
    lst[0] = torch.zeros(6, 4, dtype=lst[0].dtype).t()
    if member == "params":
        opt.params[0] = lst[0]
    for step in (opt.step, opt.step_plain):
        with pytest.raises(ValueError, match="contiguous"):
            step([torch.ones(4, 6)])


def test_a_non_contiguous_gradient_is_taken_as_its_values():
    """An expanded or transposed gradient steps as its contiguous copy."""
    a, b = _pair("adam", "f32")
    grads = _grads(np.random.default_rng(9), "float32")
    strided = [g.t().contiguous().t() if g.dim() == 2 else g for g in grads]
    strided[0] = grads[0][:1].expand(7)
    grads[0] = grads[0][:1].expand(7).contiguous()
    a.step(strided)
    b.step(grads)
    _assert_same_bits(a, b)


@pytest.mark.parametrize("kind", ["rmsprop", "adam"])
@pytest.mark.parametrize("case", ["f32", "bf16_moments_grads", "master_bf16_grads"])
def test_kernel_arguments(kind, case):
    """The dtype flags, the alignment flag and the constants as the chain
    rounds them; Adam's bias corrections handed in as float32
    reciprocals."""
    opt = _pair(kind, case)[0]
    opt._begin()
    mu = opt.mu[2] if kind == "adam" else None
    master = None if opt.master is None else opt.master[2]
    g = _grads(np.random.default_rng(1), CASES[case][1])[2]
    term = g.dtype if master is None else torch.float32
    c = opt._consts(term)
    args = ok.k13_args(kind == "adam", opt.params[2], g, mu, opt.nu[2], master, c)
    flags, consts = args[:5], args[5:]
    bf16 = {"f32": (0, 0, 0, 0), "bf16_moments_grads": (1, 1, 1, 0),
            "master_bf16_grads": (1, 0, 0, 1)}[case]
    assert flags[:4] == [bf16[0], bf16[1] if kind == "adam" else 0, bf16[2], bf16[3]]
    assert flags[4] == 1  # fresh allocations are 16-byte aligned
    assert all(float(np.float32(v)) == v for v in consts)
    if kind == "adam":
        assert c.c1 == optim.bias_correction(0.9, 3) and c.c2 == optim.bias_correction(0.999, 3)
        assert consts[-2] == float(np.float32(1) / np.float32(c.c1))
        assert consts[-1] == float(np.float32(1) / np.float32(c.c2))
        assert c.decay_mu == float(np.float32(0.9)) and c.decay_nu == float(np.float32(0.999))
    else:
        assert consts[-2:] == [1.0, 1.0] and c.decay_nu == float(np.float32(0.9))
    # 1 - decay rounded to the term's dtype: bfloat16 only for a bfloat16
    # gradient without a master.
    want = 1.0 - (0.999 if kind == "adam" else 0.9)
    assert c.term_nu == float(torch.tensor(want, dtype=term))
    assert c.neg_lr == float(np.float32(-LR)) and c.eps == float(np.float32(1e-7))
    buf = torch.zeros(65)
    assert ok.k13_args(False, buf[1:], buf[1:], None, buf[:64], None, c)[4] == 0
