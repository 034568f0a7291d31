"""`skyhdr_torch.utils.jax_random` and the port's `--seed` draws against
JAX and `skyhdr` on the CPU.

  - keys, `split`, `fold_in`, bits, `uniform` and `randint`: bit-equal to
    `jax.random` (seeds 0, 1, 2; several shapes, chunked and not);
  - `normal` and `truncated_normal`: within MAX_ULPS float32 ulps of JAX and
    never over MAX_REL relative. They go through `erf_inv`, XLA's float32
    polynomial with another `log1p` (2 ulps at most against
    `jax.lax.erf_inv` on 300 000 inputs); the rest is the bit-equal uniform;
  - the port's `create_gan_state(cfg, s)` / `create_sun_state(cfg, s)`
    against `skyhdr`'s `create_*_state(cfg, PRNGKey(s))` at 16x64, plain
    and DA convs, s in {0, 2}, leaf by leaf: glorot, zeros and ones
    bit-equal, lecun_normal (truncated) and normal(0.02) as the samplers;
  - the degradation draws against `skyhdr.data.degradation.degrade_batch`'s
    (indices exact, uniforms bit-equal, normals as above) and its output,
    and the keys `TrainLoop` hands its first three train and eval steps
    against `skyhdr`'s loop;
  - the draws fixture `tests/fixtures/torch_golden_draws_16x64.npz`
    (`make_torch_golden.make_draws_golden`, which `chip_smoke.py` holds
    the card's draws to): its digests are those of `skyhdr`'s states and
    degradation draws, the port's CPU draw passes `compare_draws`, and
    planted faults fail it.
"""

import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from skyhdr_torch.config import Config, DataConfig, ModelConfig
from skyhdr_torch.data import degradation as tdeg
from skyhdr_torch.train import engine as tengine
from skyhdr_torch.utils import jax_random as jr
from skyhdr_torch.utils.transplant import _leaf_modules, export_model_vars

# The suite runs in several worker processes that share the CPU.
torch.set_num_threads(1)

SEEDS = (0, 1, 2)
SHAPES = ((1,), (7,), (3, 5, 2), (64, 33))
MAX_ULPS = 4
MAX_REL = 1e-6
H, W, B = 16, 64, 2
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _golden_module():
    spec = importlib.util.spec_from_file_location(
        "make_torch_golden", os.path.join(ROOT, "tools", "make_torch_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


G = _golden_module()


def _key_np(k) -> np.ndarray:
    return np.asarray(k).astype(np.int64)


def _ordered(a: np.ndarray) -> np.ndarray:
    """float32 bit patterns as integers ordered like the floats."""
    i = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def _assert_close_ulps(got, want, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    ulps = np.abs(_ordered(got) - _ordered(want))
    assert ulps.max(initial=0) <= MAX_ULPS, (what, int(ulps.max()))
    rel = np.abs(got.astype(np.float64) - want) / np.maximum(np.abs(want), 1e-30)
    assert rel.max(initial=0) <= MAX_REL, (what, float(rel.max()))


def _assert_bits(got, want, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32), err_msg=what)


# --- the PRNG ---------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS + (12345, 2**31 - 1))
def test_keys_split_fold_in(seed):
    want, got = jax.random.PRNGKey(seed), jr.key(seed)
    np.testing.assert_array_equal(got.numpy(), _key_np(want))
    for n in (2, 3, 6):
        np.testing.assert_array_equal(jr.split(got, n).numpy(), _key_np(jax.random.split(want, n)))
    for data in (0, 1, 7, 2**32 - 1, 0x9E3779B9):
        np.testing.assert_array_equal(jr.fold_in(got, data).numpy(),
                                      _key_np(jax.random.fold_in(want, data)))
    for _ in range(3):  # a chain, as the loops thread it
        want, want_sub = jax.random.split(want)
        got, got_sub = jr.split(got)
        np.testing.assert_array_equal(got_sub.numpy(), _key_np(want_sub))
        np.testing.assert_array_equal(got.numpy(), _key_np(want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_bits_uniform_randint_bit_equal(seed, shape):
    want, got = jax.random.PRNGKey(seed), jr.key(seed)
    np.testing.assert_array_equal(jr.bits(got, shape).numpy(),
                                  np.asarray(jax.random.bits(want, shape)).astype(np.int64))
    for lo, hi in ((0.0, 1.0), (-1.0, 1.0), (0.25, 3.5)):
        _assert_bits(jr.uniform(got, shape, lo, hi).numpy(),
                     jax.random.uniform(want, shape, minval=lo, maxval=hi), f"uniform {lo} {hi}")
    for lo, hi in ((0, 7), (0, 175), (0, 26), (3, 10), (-5, 1000003), (0, 1 << 20)):
        np.testing.assert_array_equal(jr.randint(got, shape, lo, hi).numpy(),
                                      np.asarray(jax.random.randint(want, shape, lo, hi)),
                                      err_msg=f"randint {lo} {hi}")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", SHAPES)
def test_normal_and_truncated_normal_within_ulps(seed, shape):
    want, got = jax.random.PRNGKey(seed), jr.key(seed)
    _assert_close_ulps(jr.normal(got, shape), jax.random.normal(want, shape), "normal")
    _assert_close_ulps(jr.truncated_normal(got, -2.0, 2.0, shape),
                       jax.random.truncated_normal(want, -2.0, 2.0, shape), "truncated")


def test_chunks_follow_the_flat_index(monkeypatch):
    """A draw spread over chunks is the draw of the whole index."""
    monkeypatch.setattr(jr, "CHUNK", 1000)
    want = jax.random.PRNGKey(4)
    _assert_bits(jr.uniform(jr.key(4), (5, 1001)), jax.random.uniform(want, (5, 1001)))
    _assert_close_ulps(jr.normal(jr.key(4), (4321,)), jax.random.normal(want, (4321,)))


def test_erf_inv_against_xla():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-1, 1, 200_000), 1 - rng.uniform(0, 1e-3, 50_000),
                        rng.uniform(-1e-4, 1e-4, 50_000)]).astype(np.float32)
    got = jr.erf_inv(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jax.lax.erf_inv)(x))
    ulps = np.abs(_ordered(got) - _ordered(want))
    assert ulps.max() <= 2 and np.mean(ulps == 0) >= 0.98
    assert torch.isinf(jr.erf_inv(torch.tensor([1.0, -1.0]))).all()


# --- the initial weights ----------------------------------------------------

def _configs(use_da_conv: bool):
    from skyhdr.config import Config as JConfig
    from skyhdr.config import DataConfig as JDataConfig
    from skyhdr.config import ModelConfig as JModelConfig

    tcfg = Config(model=ModelConfig(im_height=H, im_width=W, use_da_conv=use_da_conv),
                  data=DataConfig(batch_size=B))
    jcfg = JConfig(model=JModelConfig(**vars(tcfg.model)), data=JDataConfig(batch_size=B))
    return tcfg, jcfg


@pytest.fixture(scope="module", params=["plain", "da"])
def skyhdr_states(request):
    """`skyhdr`'s GAN and SUN states' trees for seeds 0 and 2 (one init
    compile each)."""
    from skyhdr.train import engine

    tcfg, jcfg = _configs(request.param == "da")
    tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    gan = {s: engine.create_gan_state(jcfg, jax.random.PRNGKey(s)) for s in (0, 2)}
    sun = {s: engine.create_sun_state(jcfg, jax.random.PRNGKey(s)) for s in (0, 2)}
    return tcfg, {s: {"gen": tree(g.gen_vars), "sun": tree(g.sun_vars),
                      "disc": tree(g.disc_vars)} for s, g in gan.items()}, \
        {s: {"sun": tree(g.sun_vars)} for s, g in sun.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _inits(module) -> dict:
    return {"/".join([coll, *path, name]): init for path, mod in _leaf_modules(module)
            for coll, name, _, _, init in mod.flax_leaves()}


def _assert_trees_equal(module, want_tree, what):
    got, want, inits = _flat(export_model_vars(module)), _flat(want_tree), _inits(module)
    assert sorted(got) == sorted(want), what
    drawn = set()
    for path, w in want.items():
        if inits[path] in ("glorot", "zeros", "ones"):
            _assert_bits(got[path], w, f"{what} {path}")
        else:
            _assert_close_ulps(got[path], w, f"{what} {path}")
        drawn.add(inits[path])
    return drawn


@pytest.mark.parametrize("seed", (0, 2))
def test_gan_state_draws_skyhdrs_weights(skyhdr_states, seed):
    tcfg, gan, _ = skyhdr_states
    state = tengine.create_gan_state(tcfg, seed, device="cpu")
    drawn = set()
    for name, module in state.modules().items():
        drawn |= _assert_trees_equal(module, gan[seed][name], name)
    assert drawn == {"glorot", "zeros", "ones", "lecun", "normal02"}


@pytest.mark.parametrize("seed", (0, 2))
def test_sun_state_draws_skyhdrs_weights(skyhdr_states, seed):
    tcfg, _, sun = skyhdr_states
    state = tengine.create_sun_state(tcfg, seed, device="cpu")
    assert "lecun" in _assert_trees_equal(state.sun, sun[seed]["sun"], "sun")


@pytest.mark.parametrize("skyhdr_states", ["da"], indirect=True)
def test_draws_fixture_is_skyhdrs(skyhdr_states):
    """The stored digests against `skyhdr`'s seed-0 DA trees (the module's
    own JAX states) and `jax.random`'s degradation draws."""
    _, gan, sun = skyhdr_states
    stored = np.load(G.DRAWS_FIXTURE)
    assert int(stored["seed"]) == 0 and os.path.getsize(G.DRAWS_FIXTURE) < 16 * 1024
    trees = {"gan/gen": gan[0]["gen"], "gan/sun": gan[0]["sun"], "gan/disc": gan[0]["disc"],
             "sun/sun": sun[0]["sun"]}
    want = G.draw_digests(trees, G.jax_degradation_draws(0))
    names = stored["w_names"].tolist()
    assert names == sorted(k for k in want if k.startswith("w/"))
    np.testing.assert_array_equal(stored["w_digests"], np.stack([want[k] for k in names]))
    for k in (k for k in want if k.startswith("d/")):
        np.testing.assert_array_equal(stored[k], want[k], err_msg=k)
    assert 0 < stored["w_exact"].sum() < len(names)


def test_port_draw_passes_the_draws_fixture():
    """The port's CPU draw against the fixture, as the card's is held; an
    index off, one ulp on a uniform-drawn leaf and a moved value fail."""
    stored = np.load(G.DRAWS_FIXTURE)
    got = G.port_draws("cpu")
    assert G.compare_draws(stored, got) == []
    names = stored["w_names"].tolist()
    exact = next(n for n, e in zip(names, stored["w_exact"]) if e and "kernel" in n)
    drawn = next(n for n, e in zip(names, stored["w_exact"]) if not e and "kernel" in n)
    got["d/crf_idx"] = got["d/crf_idx"] + 1
    got[exact] = got[exact].copy()
    got[exact][2] = np.nextafter(np.float32(got[exact][2]), np.float32(np.inf))
    got[drawn] = got[drawn].copy()
    got[drawn][3] *= 1.001
    fails = G.compare_draws(stored, got)
    assert len(fails) == 3 and all(any(k in f for f in fails)
                                   for k in ("d/crf_idx", exact, drawn)), fails


def test_flax_key_path_and_counter():
    """The key of a parameter: Flax's own `_fold_in_static` of the scope
    path and the counter."""
    from flax.core.scope import LazyRng

    root = jax.random.PRNGKey(9)
    for path, counter in ((("res0", "conv1"), 1), (("fc2",), 2), ((), 1), (("a", "bc"), 300)):
        want = LazyRng.create(root, *path, counter).as_jax_rng()
        got = jr.flax_param_key(jr.key(9), list(path), counter)
        np.testing.assert_array_equal(got.numpy(), _key_np(want))


# --- the degradation and the loops' keys --------------------------------------

@pytest.fixture(scope="module")
def banks():
    from skyhdr.data import degradation as jdeg
    from skyhdr.utils import io as jio

    curves, exposures = jio.make_synthetic_dorf(175, 1024), jio.get_exposure_lists()[0]
    return (jdeg.make_banks(curves, exposures),
            tdeg.make_banks(curves, exposures, device="cpu"), len(curves), len(exposures))


@pytest.mark.parametrize("seed", SEEDS)
def test_degradation_draws_are_skyhdrs(banks, seed):
    """`draw_degradation(key)` against the draws of `skyhdr`'s
    `degrade_batch` (its split and order), then both packages'
    `degrade_batch` from the same key: hdr_t to 1e-6 of its scale, ldr
    through the JPEG model as `test_degrade_with_jax_draws` holds it."""
    from skyhdr.data import degradation as jdeg

    jb, tb, n_crf, n_exp = banks
    shape = (B, H, W, 3)
    key = jax.random.PRNGKey(seed)
    k_crf, k_t, k_ss, k_sc, k_ns, k_nc = jax.random.split(key, 6)
    d = tdeg.draw_degradation(jr.key(seed), shape, tb)
    np.testing.assert_array_equal(d.t_idx.numpy(),
                                  np.asarray(jax.random.randint(k_t, (B,), 0, n_exp)))
    np.testing.assert_array_equal(d.crf_idx.numpy(),
                                  np.asarray(jax.random.randint(k_crf, (B,), 0, n_crf)))
    _assert_bits(d.u_s, jax.random.uniform(k_ss, (B, 1, 1, 3)), "u_s")
    _assert_bits(d.u_c, jax.random.uniform(k_sc, (B, 1, 1, 3)), "u_c")
    _assert_close_ulps(d.z_s, jax.random.normal(k_ns, shape), "z_s")
    _assert_close_ulps(d.z_c, jax.random.normal(k_nc, shape), "z_c")

    hdr = np.random.default_rng(seed).uniform(0, 2, shape).astype(np.float32)
    want_t, want_ldr = jdeg.degrade_batch(key, jnp.asarray(hdr), jb)
    got_t, got_ldr = tdeg.degrade_batch(jr.key(seed), torch.from_numpy(hdr), tb)
    want_t = np.asarray(want_t)
    assert np.abs(got_t.numpy() - want_t).max() <= 1e-6 * max(1.0, np.abs(want_t).max())
    diff = np.abs(got_ldr.numpy() - np.asarray(want_ldr))
    assert diff.max() <= 3 / 255 + 1e-6 and np.mean(diff < 1e-6) >= 0.99


def test_train_loop_keys_are_skyhdrs(tmp_path):
    """The keys both loops hand their steps over one epoch of three train
    and three test batches: `split` of `PRNGKey(rng_seed)` once a batch."""
    import flax

    from skyhdr.config import Config as JConfig
    from skyhdr.config import TrainConfig as JTrainConfig
    from skyhdr.train.loop import TrainLoop as JTrainLoop
    from skyhdr_torch.config import TrainConfig
    from skyhdr_torch.train.loop import TrainLoop

    @flax.struct.dataclass
    class JState:
        step: jnp.ndarray
        epoch: jnp.ndarray

    rng = np.random.default_rng(0)
    batches = [{"hdr": rng.uniform(0, 1, (2, 4, 8, 3)).astype(np.float32),
                "elevation": np.full(2, i, np.float32)} for i in range(6)]
    seen = {"t": [], "j": []}

    def steps(tag, state_of):
        def train_step(state, batch, key):
            seen[tag].append(("train", _key_np(key)))
            return state_of(state), {"m": float(np.asarray(batch["elevation"]).sum())}

        def eval_step(state, batch, key):
            seen[tag].append(("eval", _key_np(key)))
            return {"m": 0.0}, {}
        return train_step, eval_step

    tc = dict(ckpt_every_epochs=100)
    loop = TrainLoop(Config(train=TrainConfig(**tc)), "SUN",
                     lambda: tengine.empty_sun_state(Config(model=ModelConfig(
                         im_height=8, im_width=32)), "cpu"),
                     *steps("t", lambda s: s), batches[:3], batches[3:],
                     workdir=str(tmp_path / "t"), log=lambda *_: None, device="cpu")
    loop.run(epochs=1, rng_seed=7)
    jloop = JTrainLoop(JConfig(train=JTrainConfig(**tc)), "SUN",
                       lambda: JState(step=jnp.zeros((), jnp.int32),
                                      epoch=jnp.zeros((), jnp.int32)),
                       *steps("j", lambda s: s), batches[:3], batches[3:],
                       workdir=str(tmp_path / "j"), log=lambda *_: None, prefetch=0)
    jloop.run(epochs=1, rng_seed=7)
    assert [k for k, _ in seen["t"]] == [k for k, _ in seen["j"]] == ["train"] * 3 + ["eval"] * 3
    for (_, got), (_, want) in zip(seen["t"], seen["j"]):
        np.testing.assert_array_equal(got, want)
