"""The train steps with plain convs (`use_da_conv=False`, `skyhdr`'s
default) on the CPU against `skyhdr`'s, at 16x64 b2 from the seeded
weights, on the DA train golden's inputs:

  - float32 (tests/fixtures/torch_golden_train_plain_16x64.npz,
    `make_torch_golden.make_train_golden(use_da_conv=False)`): one GAN step
    and one sun step at the DA goldens' tolerances (metrics 1e-3, update
    digests 2e-2, BatchNorm sums 1e-4); a port run in bfloat16 fails them;
  - bfloat16 compute (tests/fixtures/torch_golden_train_plain_bf16_16x64.npz,
    `make_train_golden_bf16(use_da_conv=False)`): both train steps and both
    eval steps, each quantity within half of `skyhdr`'s own bf16-vs-f32 gap
    (`compare_train_golden_bf16`); a port run in float32 fails that.

On this path bf16 reaches the generator (at DA its layers stay float32).
Each of its bf16 layers rounds where `skyhdr`'s does, from the same input
and cotangent (`test_plain_bf16_layers_round_as_skyhdr`); but its twelve
bf16 trunk convs amplify a one-ulp difference as far as bf16 itself moves
the values, in `skyhdr` as in the port: `skyhdr`'s own bf16 steps from
weights perturbed by 2e-7 (float32 noise) land as far from its unperturbed
run, on every GAN-step quantity, as the float32 steps do. Those quantities
(`make_torch_golden.PLAIN_BF16_AMPLIFIED`) are therefore held to their
class's largest gap, own or perturbed; the sun and sun eval steps, which
run the sun-pose net alone, are held per quantity. ROADMAP Queue 3 records
it.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

# The suite runs in several worker processes that share the CPU; torch's
# default of one thread per core in each of them oversubscribes it.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
spec_ = importlib.util.spec_from_file_location(
    "make_torch_golden", os.path.join(ROOT, "tools", "make_torch_golden.py"))
G = importlib.util.module_from_spec(spec_)
spec_.loader.exec_module(G)


def _load(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def stored():
    return _load(G.PLAIN_TRAIN_FIXTURE)


@pytest.fixture(scope="module")
def stored_bf16():
    return _load(G.PLAIN_BF16_TRAIN_FIXTURE)


def _bf16_port(stored_bf16, compute_dtype):
    """The port's eval steps, then its train steps, at plain convs under
    `compute_dtype`, from the seeded weights on the fixture's inputs."""
    cfg = G.golden_config(compute_dtype=compute_dtype, use_da_conv=False)
    state, sun_state = G.bf16_states(stored_bf16, cfg, "cpu")
    return {**G.port_eval_bf16(stored_bf16, cfg, state, sun_state, "cpu"),
            **G.port_steps(stored_bf16, cfg, state, sun_state, "cpu")}


@pytest.fixture(scope="module")
def bf16_port(stored_bf16):
    return _bf16_port(stored_bf16, "bfloat16")


@pytest.fixture(scope="module")
def f32_port(stored_bf16):
    return _bf16_port(stored_bf16, "float32")


def test_plain_fixtures_share_the_da_inputs(stored, stored_bf16):
    """The degradation does not depend on the model: the plain goldens were
    fed the DA train golden's inputs, from the port's seeded plain-conv
    weights."""
    from skyhdr_torch.utils.transplant import init_gan_vars, tree_digest

    da = _load(G.TRAIN_FIXTURE)
    gv, sv, dv = init_gan_vars(G.golden_config(use_da_conv=False), int(da["seed"]))
    digest = tree_digest({"gen": gv, "sun": sv, "disc": dv})
    for fixture in (stored, stored_bf16):
        for k in ("seed", "elevation", "hdr_t", "ldr", "sunpose_gt"):
            np.testing.assert_array_equal(fixture[k], da[k], err_msg=k)
        assert abs(digest - float(fixture["weights_digest"])) <= 1e-9 * digest


def test_plain_f32_steps_match_skyhdr(stored):
    port = G.port_train_golden(stored, "cpu", use_da_conv=False)
    fails, worst = G.compare_train_golden(stored, port, 1e-3, 2e-2)
    assert not fails, (fails, worst)


def test_plain_f32_golden_fails_a_bf16_port(stored, bf16_port):
    """The port run under bfloat16 compute misses the float32 golden: its
    GAN metrics move by the bf16 effect (~1e-2), far past 1e-3."""
    port = dict(bf16_port, gan_metrics=np.array(
        [bf16_port["gan_metric_dict"][k] for k in stored["gan_metric_names"]]))
    fails, _ = G.compare_train_golden(stored, port, 1e-3, 2e-2)
    assert any(line.startswith("gan metric") for line in fails), fails


@pytest.mark.parametrize("resolved", [True, False], ids=["cpu", "card"])
def test_plain_bf16_steps_match_skyhdr(stored_bf16, bf16_port, resolved):
    fails, worst = G.compare_train_golden_bf16(stored_bf16, bf16_port, resolved,
                                               amplified=G.PLAIN_BF16_AMPLIFIED)
    assert not fails, (fails, worst)


@pytest.mark.parametrize("resolved", [True, False], ids=["cpu", "card"])
def test_plain_bf16_golden_fails_a_float32_port(stored_bf16, f32_port, resolved):
    """The port run in float32 lands on `skyhdr`'s own gap on the sun
    step's quantities: the per-quantity tolerances fail it, and so does the
    median of gap / own gap over the quantities held per quantity."""
    fails, worst = G.compare_train_golden_bf16(stored_bf16, f32_port, resolved,
                                               amplified=G.PLAIN_BF16_AMPLIFIED)
    assert worst["median_of_own"] > 0.9, worst
    assert any(line.startswith("median gap / own gap") for line in fails), fails
    if resolved:
        assert any(line.startswith("sun gradient") for line in fails), fails


def test_plain_bf16_generator_amplifies_f32_noise(stored_bf16):
    """What puts the GAN step out of resolution, from the fixture alone:
    `skyhdr`'s bf16 steps from weights perturbed by 2e-7 (its "pert<k>_"
    values, three draws) move the GAN-step quantities about as far as bf16
    moves them from float32 (median of perturbed gap / own gap 0.98), and
    the sun step's quantities, with no bf16 generator in them, less than
    half as far (0.26)."""
    own = {n: g for _, n, g in G.bf16_own_gaps(stored_bf16)}
    rows = G.bf16_pert_gaps(stored_bf16)
    assert len(rows) == G.PLAIN_BF16_PERTURB_DRAWS * len(own)
    amplified = [g / own[n] for _, n, g in rows
                 if n.startswith(G.PLAIN_BF16_AMPLIFIED) and own[n] > 0]
    sun = [g / own[n] for _, n, g in rows if n.startswith(("sun ", "sun_eval ")) and own[n] > 0]
    assert np.median(amplified) > 0.6, np.median(amplified)
    assert np.median(sun) < np.median(amplified) / 2, (np.median(sun), np.median(amplified))


def _gap(got, want, bf16: bool, before: float = 0.0):
    """(share of elements that differ, largest difference over the allowed
    one): for a bf16 tensor one bf16 ulp of the larger of the two values
    plus `before` (a float32 sum on the other side of a rounding boundary;
    a conv's sum rounds before its bias is added, so `before` is the
    largest |bias|) plus 1e-5 of the tensor's largest value (float32 sums in
    another order, where a sum cancels to near zero); for a float32 tensor
    1e-5 of its largest value."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want)
    allowed = 1e-5 * np.abs(want).max()
    if bf16:
        top = np.maximum(np.abs(got), np.abs(want)) + before
        allowed = allowed + np.exp2(np.floor(np.log2(np.maximum(top, 1e-30))) - 7)
    return float((d > 0).mean()), float((d / allowed).max())


def _port_layer(kind, cin, cout):
    from skyhdr_torch.models.layers import Conv2D, InstanceNorm, ResizeDeconv

    if kind == "trunk_conv":
        return Conv2D(cin, cout, 3, dtype=torch.bfloat16)
    if kind == "resize_deconv":
        return ResizeDeconv(cin, cout, (16, 64), 3, dtype=torch.bfloat16)
    if kind == "decoder_out":
        return Conv2D(cin, cout, 7)
    return InstanceNorm(cin)


@pytest.mark.parametrize("kind", ["trunk_conv", "resize_deconv", "decoder_out", "instance_norm"])
def test_plain_bf16_layers_round_as_skyhdr(kind):
    """Each kind of layer the bf16 plain generator runs, from the same input
    and cotangent as `skyhdr`'s: the trunk's 3x3 bf16 conv (128 -> 128 at
    4x16), the sky decoder's bf16 resize-deconv (128 -> 64, to 16x64), its
    last 7x7 conv, which promotes the bf16 input to float32 (`skyhdr`
    width-folds it), and InstanceNorm + leaky ReLU on a bf16 input. The
    output and the input gradient differ only where a float32 sum lands on
    the other side of a bf16 rounding boundary (one ulp, in at most 1e-3 of
    the elements; `_gap`); the weight gradient likewise, and within float32
    noise where the layer computes in float32. Not compared: the bias gradients of the bf16 convs
    (XLA on the CPU sums the bf16 cotangent in bf16, the port rounds the
    float32 sum once), which are exactly zero in the model: those convs
    feed InstanceNorms (`in_fed_biases`)."""
    import jax
    import jax.numpy as jnp

    from skyhdr.models import layers as jl
    from skyhdr_torch.utils.transplant import load_model_vars

    rng = np.random.default_rng(4)
    shape, cin, cout, jmod = {
        "trunk_conv": ((2, 4, 16, 128), 128, 128, jl.conv(128, 3, 1, dtype=jnp.bfloat16)),
        "resize_deconv": ((2, 8, 32, 128), 128, 64,
                          jl.ResizeDeconv(64, (16, 64), 3, dtype=jnp.bfloat16)),
        "decoder_out": ((2, 16, 64, 32), 32, 3, jl.conv(3, 7, 1)),
        "instance_norm": ((2, 16, 64, 32), 32, 32, jl.InstanceNorm()),
    }[kind]
    x = jnp.asarray(rng.uniform(-1, 1, shape), jnp.bfloat16)
    variables = jmod.init(jax.random.PRNGKey(1), x)
    variables = jax.tree_util.tree_map(
        lambda v: jnp.asarray(rng.normal(size=v.shape) * 0.1 + (1.0 if v.ndim == 1 else 0.0),
                              v.dtype), variables)
    call = (lambda v, xx: jmod.apply(v, xx, act="lrelu01")) if kind == "instance_norm" \
        else jmod.apply
    y, vjp = jax.vjp(call, variables, x)
    g = jnp.asarray(rng.normal(size=y.shape), y.dtype)
    dvars, dx = vjp(g)

    port = _port_layer(kind, cin, cout)
    load_model_vars(port, jax.tree_util.tree_map(np.asarray, variables))
    xt = torch.from_numpy(np.asarray(x, np.float32)).bfloat16().requires_grad_()
    yt = port(xt, act="lrelu01") if kind == "instance_norm" else port(xt)
    assert str(yt.dtype) == f"torch.{y.dtype}", (yt.dtype, y.dtype)
    gt = torch.from_numpy(np.asarray(g, np.float32)).to(yt.dtype)
    names = [n for n, _ in port.named_parameters()]
    grads = torch.autograd.grad(yt, [xt, *port.parameters()], gt)
    bias = [np.abs(np.asarray(v)).max() for p, v in G.flat_leaves(
        jax.tree_util.tree_map(np.asarray, variables)["params"]) if p.endswith("bias")]
    for name, a, w in (("y", yt.detach().float(), y), ("dx", grads[0].float(), dx)):
        # The resize-deconv's input gradient sums the conv's, rounded first.
        before = {("y", "instance_norm"): 0.0, ("dx", "resize_deconv"): float(
            np.abs(np.asarray(w, np.float32)).max())}.get((name, kind), max(bias) if name == "y"
                                                          else 0.0)
        share, over = _gap(a, w, w.dtype == jnp.bfloat16, before)
        assert over <= 1.0 and (w.dtype != jnp.bfloat16 or share <= 1e-3), (kind, name, share, over)
    from skyhdr_torch.utils.transplant import export_model_vars

    want = dict(G.flat_leaves(jax.tree_util.tree_map(np.asarray, dvars)["params"]))
    got = dict(G.flat_leaves(export_model_vars(
        port, value_of=dict(zip(port.parameters(), [g.float() for g in grads[1:]])).__getitem__,
        collections=("params",))["params"]))
    assert set(got) == set(want) and len(names) == len(got)
    for path in got:
        if path.endswith("bias") and kind != "decoder_out" and kind != "instance_norm":
            continue
        share, over = _gap(got[path], want[path], kind in ("trunk_conv", "resize_deconv"))
        assert over <= 1.0, (kind, path, share, over)


@pytest.mark.parametrize("shape,size", [((2, 8, 32, 64), (16, 64)), ((2, 4, 16, 32), (16, 64)),
                                        ((2, 8, 32, 1), (32, 128)), ((2, 16, 64, 1), (32, 128))])
def test_bf16_resize_rounds_as_skyhdr(shape, size):
    """Fault repaired (ROADMAP Queue 3, F3): in bfloat16 the port's resize rounded after
    each axis, `skyhdr`'s resize-deconv upscale (a dilated depthwise conv,
    c >= 8) rounds once, so 28% of a resize-deconv's inputs were one ulp
    off. Now the output is bit-equal for both of `skyhdr`'s integer forms
    (the conv, and the per-op phase blend of the Grad-CAM maps, c = 1), and
    so is the conv form's gradient (the maps carry none in the model)."""
    import jax
    import jax.numpy as jnp

    from skyhdr.ops.resize import resize_bilinear as jax_resize
    from skyhdr_torch.ops.resize import _resize_axis, resize_bilinear

    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.uniform(-1, 1, shape), jnp.bfloat16)
    y, vjp = jax.vjp(lambda a: jax_resize(a, size), x)
    g = jnp.asarray(rng.normal(size=y.shape), jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(x, np.float32)).bfloat16().requires_grad_()
    yt = resize_bilinear(xt, size)
    np.testing.assert_array_equal(yt.detach().float().numpy(), np.asarray(y, np.float32))
    if shape[-1] >= 8:
        (dx,) = torch.autograd.grad(yt, xt, torch.from_numpy(np.asarray(g, np.float32)).bfloat16())
        np.testing.assert_array_equal(dx.float().numpy(), np.asarray(vjp(g)[0], np.float32))
        per_axis = _resize_axis(_resize_axis(xt.detach(), 1, size[0]), 2, size[1])
        assert (per_axis.float().numpy() != np.asarray(y, np.float32)).mean() > 0.1


@pytest.mark.parametrize("slope", [0.1, 0.3])
def test_bf16_leaky_relu_slope_rounds_as_skyhdr(slope):
    """Fault repaired (ROADMAP Queue 3, F4): on a bfloat16 tensor `flax.linen.leaky_relu`
    multiplies by the slope rounded to bfloat16 (0.1 -> 0.10009765625, 0.3
    -> 0.30078125), the port multiplied by the exact slope; the generator's
    leaky ReLU (0.1, bf16 with plain convs) and SunRadNet's (0.3, bf16 under
    bf16 compute) moved a negative input by a quarter of an ulp, 4% of an
    InstanceNorm + leaky ReLU's outputs by one ulp. Now the output and the
    gradient are bit-equal."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from skyhdr_torch.models.layers import leaky_relu

    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.normal(size=(4096,)), jnp.bfloat16)
    y, vjp = jax.vjp(lambda a: nn.leaky_relu(a, slope), x)
    g = jnp.asarray(rng.normal(size=y.shape), jnp.bfloat16)
    xt = torch.from_numpy(np.asarray(x, np.float32)).bfloat16().requires_grad_()
    yt = leaky_relu(xt, slope)
    (dx,) = torch.autograd.grad(yt, xt, torch.from_numpy(np.asarray(g, np.float32)).bfloat16())
    np.testing.assert_array_equal(yt.detach().float().numpy(), np.asarray(y, np.float32))
    np.testing.assert_array_equal(dx.float().numpy(), np.asarray(vjp(g)[0], np.float32))
    exact = torch.nn.functional.leaky_relu(xt.detach(), slope)
    assert (exact.float().numpy() != np.asarray(y, np.float32)).mean() > 0.01


@pytest.mark.slow
@pytest.mark.parametrize("which", ["f32", "bf16"])
def test_plain_fixture_regenerates(which):
    path, make = {"f32": (G.PLAIN_TRAIN_FIXTURE,
                          lambda: G.make_train_golden(0, use_da_conv=False)),
                  "bf16": (G.PLAIN_BF16_TRAIN_FIXTURE,
                           lambda: G.make_train_golden_bf16(0, use_da_conv=False))}[which]
    stored, fresh = _load(path), make()
    assert sorted(fresh) == sorted(stored)
    for name in stored:
        if stored[name].dtype.kind in "US":
            np.testing.assert_array_equal(fresh[name], stored[name], err_msg=name)
        else:
            np.testing.assert_allclose(fresh[name], stored[name], rtol=1e-6, atol=1e-9,
                                       err_msg=name)
    assert os.path.getsize(path) < 200 * 1024
