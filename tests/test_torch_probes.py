"""The probe tools' kernels on the CPU: the plain versions of K10 (the DA
forward variants), K11 (sample packing) and K12 (the dot-shape
microbench) against the JAX probes in tools/ (run in interpret mode), and
the port's three tools end to end on the CPU."""

import contextlib
import importlib.util
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from skyhdr_torch.ops.kernels import probes as tp
from skyhdr_torch.tools import exp_daconv, exp_mmshape, exp_pack

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16, F32 = torch.bfloat16, torch.float32


def _tool(name):
    """A JAX probe of tools/ (not a package), loaded by path."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JD = _tool("exp_daconv")
JP = _tool("exp_pack")
JM = _tool("exp_mmshape")


def _operands(b, c=16, f=8, h=8, w=32):
    rng = np.random.default_rng(0)
    k = (rng.normal(size=(9 * c, f)) * 0.05).astype(np.float32)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    return x, k


# (id, JAX call, port call, bf16 dots, batch). Both sides take (x, k) as
# numpy / torch arrays; the port's calls run its plain versions on the CPU.
J, P = jnp.bfloat16, BF16
CASES = [
    ("a", lambda x, k: JD.forward_a(x, k), lambda x, k: exp_daconv.forward_a(x, k), False, 2),
    ("a_bf16", lambda x, k: JD.forward_a(x, k, store=J),
     lambda x, k: exp_daconv.forward_a(x, k, store=P), False, 2),
    ("b_bf16", lambda x, k: JD.forward_b(x, k, store=J),
     lambda x, k: exp_daconv.forward_b(x, k, store=P), False, 2),
    ("c", lambda x, k: JD.forward_c(x, k), lambda x, k: exp_daconv.forward_c(x, k), False, 2),
    ("c_bf16", lambda x, k: JD.forward_c(x, k, store=J),
     lambda x, k: exp_daconv.forward_c(x, k, store=P), False, 2),
    ("cs", lambda x, k: JD.forward_c(x, k, staged=True),
     lambda x, k: exp_daconv.forward_c(x, k, staged=True), False, 2),
    ("prodbf16", lambda x, k: JD.forward_prodbf16(x, k),
     lambda x, k: exp_daconv.forward_prodbf16(x, k), True, 2),
    ("pairc", lambda x, k: JD.forward_pair(x, k),
     lambda x, k: exp_daconv.forward_pair(x, k), False, 2),
    ("pairs", lambda x, k: JD.forward_pair(x, k, use_scratch=True),
     lambda x, k: exp_daconv.forward_pair(x, k, use_scratch=True), False, 2),
] + [
    (f"diag_{m}", lambda x, k, m=m: JD.forward_diag(x, k, m),
     lambda x, k, m=m: exp_daconv.forward_diag(x, k, m), m in ("mmbf16", "fullbf16"), 2)
    for m in exp_daconv.DIAG_VARIANTS
] + [
    (f"pack{p}_{body}", lambda x, k, p=p, r=roll: JD.forward_pack(x, k, p=p, roll=r),
     lambda x, k, p=p, r=roll: exp_daconv.forward_pack(x, k, p=p, roll=r), roll is False, 4)
    for p in (2, 4) for body, roll in (("prodbf16", False), ("c", True), ("nomm", "nomm"))
] + [
    (f"dedup_p{p}_m{m}", lambda x, k, p=p, m=m: JD.forward_dedup(x, k, p=p, mblk=m),
     lambda x, k, p=p, m=m: exp_daconv.forward_dedup(x, k, p=p, mblk=m), False, 2 * p)
    for p in (1, 2) for m in (1, 2)
]


@pytest.mark.parametrize("name,jfn,tfn,bf16_dots,b", CASES, ids=[c[0] for c in CASES])
def test_daconv_probe_plain_matches_interpret(name, jfn, tfn, bf16_dots, b):
    x, k = _operands(b)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(k)))
    got = tfn(torch.from_numpy(x), torch.from_numpy(k)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    # f32 dots: the same sums in another order; bf16 dots: a sample near a
    # bf16 rounding tie may round the other way under another order.
    tol = 2e-3 if bf16_dots else 1e-5
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_pack_diag_f32_storage_prepacked():
    x, k = _operands(4)
    xp = JD._pack_samples(jnp.asarray(x), 2)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JD.forward_pack(xp, jnp.asarray(k), p=2, prepacked=True,
                                          roll="loadonly", store=jnp.float32))
    got = exp_daconv.forward_pack(tp.pack_samples_ref(torch.from_numpy(x), 2),
                                  torch.from_numpy(k), p=2, prepacked=True,
                                  roll="loadonly", store=F32).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_every_instantiation_is_reached_and_full_variants_match_daconv():
    """Each K10 instantiation is named by some variant; the whole-forward
    instantiations agree with the plain DA conv (f32 storage closely)."""
    from skyhdr_torch.ops.distortion import deformable_conv2d

    x, k = _operands(2)
    xt, kt = torch.from_numpy(x), torch.from_numpy(k)
    ref = deformable_conv2d(xt, kt, torch.zeros(8)).numpy()
    for name, p in tp.PROBES.items():
        assert tp.find_probe(p.store, gather=p.gather, taps=p.taps, dedup=p.dedup,
                             mma=p.mma, diag=p.diag) == name
        if p.diag:
            continue
        got = tp.da_probe(xt, kt, name).numpy()
        tol = 1e-5 if p.store == F32 and not p.mma else 2e-2
        assert np.abs(got - ref).max() <= tol * np.abs(ref).max(), name


def test_cuda_instantiations_are_the_probes_table():
    """csrc/probes.cu instantiates exactly the choices of PROBES, and its
    Gather and Diag enums take GATHERS' and DIAGS' order."""
    import re

    with open(os.path.join(ROOT, "skyhdr_torch", "csrc", "probes.cu")) as f:
        src = f.read()
    gathers = re.search(r"enum Gather \{([^}]*)\}", src).group(1)
    diags = re.search(r"enum Diag \{([^}]*)\}", src).group(1)
    enum = {n.split("=")[0].strip(): i for names in (gathers, diags)
            for i, n in enumerate(names.split(","))}
    assert [enum[g] for g in ("kDirect", "kStaged")] == [tp.GATHERS.index(g)
                                                        for g in ("direct", "staged")]
    diag_of = {"kFull": "", "kNoRoll": "noroll", "kNoMM": "nomm", "kMMOnly": "mmonly",
               "kMMHoist": "mmhoist", "kLoadOnly": "loadonly", "kLoad1Only": "load1only"}
    assert all(enum[k] == tp.DIAGS.index(v) for k, v in diag_of.items())
    table = src[src.index("#define SKYHDR_PROBES(X)"):src.index("extern \"C\"")]
    dtypes, gather = {"float": F32, "bf16": BF16}, {"kDirect": "direct", "kStaged": "staged"}
    cuda = [tp.Probe(dtypes[t], gather[g], int(taps), d == "true", m == "true", diag_of[dg])
            for t, g, taps, d, m, dg in re.findall(
                r"X\((\w+), (\w+), (\d+), (\w+), (\w+), (\w+)\)", table)]
    assert len(cuda) == len(set(cuda)) and set(cuda) == set(tp.PROBES.values())


@pytest.mark.parametrize("p", [2, 4])
def test_pack_plain_matches_pallas_bitwise(p):
    x, _ = _operands(4)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JP.pack_pallas(jnp.asarray(x), p))
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(tp.pack_samples_ref(xt, p).numpy(), want)
    np.testing.assert_array_equal(tp.pack_samples_library(xt, p).numpy(), want)
    np.testing.assert_array_equal(tp.unpack_samples(tp.pack_samples(xt, p), p).numpy(), x)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_mm_shape_plain_matches_make_bench(dtype):
    x = np.random.default_rng(0).normal(size=(40, 40)).astype(np.float32)
    jdt, tdt = (jnp.float32, F32) if dtype == "f32" else (jnp.bfloat16, BF16)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JM.make_bench(16, 8, 8, 3, 2, jdt)(jnp.asarray(x)))
    got = exp_mmshape.make_bench(16, 8, 8, 3, 2, tdt)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (16, 8)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("cfg", sorted(exp_mmshape.CFGS))
def test_mm_tiling_takes_every_configuration_unpadded(cfg, bf16):
    """Each exp_mmshape configuration is a whole number of one K12 block
    tile and staged chunks: the kernel runs it unpadded, 256 x 64 where m
    is 256 and 64 x 256 where f is."""
    m, k, f, _, _ = exp_mmshape.CFGS[cfg]
    mp, kp, fp, tile = tp.mm_tiling(m, k, f, bf16)
    assert (mp, kp, fp) == (m, k, f)
    assert tp.MM_TILES[tile] == ((256, 64) if m == 256 else (64, 256))


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("m,k,f,want", [
    ((13, 7, 5, (0, 256, 64))),      # all three tiles pad to 16384: the first
    ((300, 100, 70, (1, 384, 128))),  # 3 x 1 tiles of 128 x 128
    ((40, 600, 300, (2, 64, 512))),   # 1 x 2 tiles of 64 x 256
])
def test_mm_tiling_pads_odd_shapes_to_whole_tiles(m, k, f, want, bf16):
    mp, kp, fp, tile = tp.mm_tiling(m, k, f, bf16)
    bm, bf = tp.MM_TILES[tile]
    chunk = tp.MM_CHUNK
    assert (tile, mp, fp) == want
    assert mp % bm == 0 and fp % bf == 0 and kp % chunk == 0
    assert 0 <= kp - k < chunk and mp >= m and fp >= f


def test_dedup_span_and_blockdiag():
    assert tp.dedup_span(64, 256) == 5 and tp.dedup_span(8, 32) == 5
    k = torch.arange(9 * 2 * 3, dtype=torch.float32).reshape(18, 3)
    kb = tp.blockdiag_kernel(k, 2).reshape(9, 4, 6)
    assert torch.equal(kb[:, :2, :3], k.reshape(9, 2, 3))
    assert torch.equal(kb[:, 2:, 3:], k.reshape(9, 2, 3))
    assert not kb[:, :2, 3:].any() and not kb[:, 2:, :3].any()


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue().splitlines()


TOOL_RUNS = [
    (exp_daconv.main, ["--b", "4", "--h", "8", "--w", "32", "--c", "16", "--f", "8",
                       "--iters", "2", "--variants",
                       "prod,xla,a2,a2p,b2,cs2,prodbf16,pairs,fullbf16,mmhoist,pack2,"
                       "pack2:nommf,dd2m2,dd2k"], 14),
    (exp_pack.main, ["--b", "4", "--h", "8", "--w", "32", "--c", "16", "--f", "8",
                     "--iters", "2"], 3),
    (exp_mmshape.main, ["--steps", "2", "--iters", "2", "--variants", "a18,b9h,t18,zz"], 3),
]


@pytest.mark.parametrize("main,argv,lines", TOOL_RUNS, ids=["exp_daconv", "exp_pack",
                                                           "exp_mmshape"])
def test_tool_main_on_cpu(main, argv, lines):
    out = _run(main, ["--device", "cpu", *argv])
    assert out[0].startswith("# device: cpu")
    body = out[1:]
    assert len(body) == lines and not any("FAILED" in line for line in body), out
    assert all(" ms" in line for line in body)
