"""Training under `compute_dtype="bfloat16"` on the CPU against `skyhdr`'s
bf16 steps, at 16x64 DA b2 from the seeded weights
(`tools/make_torch_golden.make_train_golden_bf16`, stored in
tests/fixtures/torch_golden_train_bf16_16x64.npz).

`skyhdr`'s DA layers run on the Pallas path in interpret mode there: its
XLA path promotes the bilinear samples to float32 against a bf16 kernel,
the Pallas kernels (and the port) round samples and weights to bf16. That
JAX run takes minutes, so only the test that regenerates the fixture makes
it (marked slow); the port's tests read the stored fixture.

What is compared: the metrics of both train steps and both eval steps, the
per-leaf GRADIENT digests (sum g, sum |g|) recovered from the optimizers'
moments, and the BatchNorm running sums. Not the first-step updates: RMSprop
and Adam move each element by about a constant times lr sign(g), so an
update digest counts sign flips of small gradients, which bf16 rounding
flips. A conv bias that feeds an InstanceNorm has exactly zero gradient and
is held to the optimizer's bound on |update| (`in_fed_biases`).

The tolerances (`make_torch_golden.bf16_tolerances`) are per quantity: half
of `skyhdr`'s own gap between its bf16 and its float32 steps on that
quantity (the own gap floored at a quarter of its class's median), so that
the port run in float32 fails the comparison; SunRadNet's and the sky
decoder's quantities, which an amplifier puts outside that resolution, within
their class's largest own gap. The planted faults show what the comparison
sees: two trunk kernels' gradients swapped, a sun-pose conv's gradient
scaled by 1.05, InstanceNorm's statistics taken in bf16 and the sun-pose
softmax's output rounded to bf16 (two rounding points moved).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from skyhdr_torch.data.records import write_tfrecord
from skyhdr_torch.models import sunpose
from skyhdr_torch.models.layers import InstanceNorm, leaky_relu_01
from skyhdr_torch.train.checkpoints import CheckpointManager

# The suite runs in several worker processes that share the CPU; torch's
# default of one thread per core in each of them oversubscribes it.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


G = _load_tool("make_torch_golden")


@pytest.fixture(scope="module")
def stored():
    with np.load(G.BF16_TRAIN_FIXTURE) as f:
        return {k: f[k] for k in f.files}


@pytest.fixture(scope="module")
def clean_port(stored):
    """The port's bf16 eval steps, then its train steps, from the seeded
    weights (unfused IN)."""
    return G.port_train_golden_bf16(stored, "cpu")


@pytest.fixture(scope="module")
def clean_eval(clean_port):
    return {k: clean_port[k] for k in ("gan_eval_metrics", "sun_eval_metrics")}


@pytest.mark.slow
def test_bf16_train_golden_fixture_regenerates(stored):
    fresh = G.make_train_golden_bf16(0)
    assert sorted(fresh) == sorted(stored)
    for name in stored:
        if stored[name].dtype.kind in "US":
            np.testing.assert_array_equal(fresh[name], stored[name], err_msg=name)
        else:
            np.testing.assert_allclose(fresh[name], stored[name], rtol=1e-6,
                                       atol=1e-9, err_msg=name)
    assert os.path.getsize(G.BF16_TRAIN_FIXTURE) < 200 * 1024


def test_bf16_fixture_shares_the_f32_inputs(stored):
    """The degradation does not depend on the compute dtype: the bf16 golden
    was fed the f32 golden's inputs, from the same seeded weights."""
    with np.load(G.TRAIN_FIXTURE) as f32:
        for k in ("seed", "weights_digest", "elevation", "hdr_t", "ldr", "sunpose_gt"):
            np.testing.assert_array_equal(stored[k], f32[k], err_msg=k)


def test_in_fed_biases_by_structure(stored):
    """The zero-gradient leaves are the biases of the convs that feed an
    InstanceNorm: the encoder's three, the trunk's twelve, the DA
    resize-deconvs' four and the sun-pose net's six; not the decoders' last
    convs (conv1_f, conv1_u), which feed a leaky ReLU."""
    paths = stored["gan_grad_paths"]
    fed = {str(p) for p in paths[G.in_fed_biases(paths)]}
    want = ({f"gen/conv{i}_d/bias" for i in (1, 2, 3)}
            | {f"gen/res{i}/conv{j}/bias" for i in range(6) for j in (1, 2)}
            | {f"gen/conv{i}_{s}/bias" for i in (2, 3) for s in "fu"}
            | {f"sun/sunlayer{i}/conv{j}/bias" for i in (1, 2, 3) for j in (1, 2)})
    assert fed == want
    sun_paths = stored["sun_grad_paths"]
    assert ({str(p) for p in sun_paths[G.in_fed_biases(sun_paths)]}
            == {p[len("sun/"):] for p in want if p.startswith("sun/")})


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused_in"])
def test_bf16_steps_match_skyhdr(stored, clean_port, fused):
    port = (G.port_train_golden_bf16(stored, "cpu", fused_instance_norm=True) if fused
            else clean_port)
    fails, worst = G.compare_train_golden_bf16(stored, port)
    assert not fails, (fails, worst)


def test_bf16_eval_steps_match_skyhdr(stored, clean_eval):
    tol = G.bf16_tolerances(stored)
    for kind in ("gan_eval", "sun_eval"):
        for name, got, want in zip(stored[f"{kind}_metric_names"], clean_eval[f"{kind}_metrics"],
                                   stored[f"{kind}_metrics"]):
            assert abs(got - want) <= tol[f"{kind} metric {name}"] * abs(want), (kind, name)


@pytest.mark.parametrize("resolved", [True, False], ids=["cpu", "card"])
def test_bf16_golden_fails_a_float32_port(stored, resolved):
    """The port run under compute_dtype="float32" lands on `skyhdr`'s own
    bf16-vs-f32 gap on every quantity: the CPU's per-quantity tolerances
    fail it nearly everywhere, and the card's (each class's largest own
    gap) through the median of gap / own gap."""
    cfg = G.golden_config()
    state, sun_state = G.bf16_states(stored, cfg, "cpu")
    port = {**G.port_eval_bf16(stored, cfg, state, sun_state, "cpu"),
            **G.port_steps(stored, cfg, state, sun_state, "cpu")}
    fails, worst = G.compare_train_golden_bf16(stored, port, resolved=resolved)
    assert worst["median_of_own"] > 0.9, worst
    assert any(line.startswith("median gap / own gap") for line in fails), fails
    if resolved:
        assert len(fails) > len(G.bf16_own_gaps(stored)) // 2, fails


def _flips(got, want):
    """(share of elements that differ, largest difference in bf16 ulps of
    the wanted element): one ulp is at most 2^-7 of a value, so a value
    rounded on the other side of a boundary differs by at most 2^-7 of it.
    Where a sum cancels to near zero, float32 sums in two orders differ by
    ~1e-7 of the terms, so 1e-6 of the largest value is allowed on top."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    d = np.abs(got - want)
    ulp = np.abs(want) * 2.0 ** -7 + 1e-6 * np.abs(want).max()
    return float((d > 0).mean()), float((d / ulp).max())


def test_bf16_da_conv_rounds_where_pallas_rounds():
    """The DA conv with bf16 x against `skyhdr`'s Pallas kernels (interpret
    mode): samples and weights rounded to bf16, f32 accumulation, the bias
    added, then one rounding (forward); dx from the f32 cotangent cast to
    bf16, dK and db in f32 (`_da_bwd`). Only a float32 sum that lands on the
    other side of a bf16 rounding boundary may differ, by one ulp. The XLA
    path promotes the samples to f32 and differs in most elements."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from skyhdr.ops.distortion import deformable_conv2d
    from skyhdr.ops.pallas.deform_conv import deformable_conv2d_pallas
    from skyhdr_torch.ops.kernels.deform_conv import da_conv

    rng = np.random.default_rng(0)
    shape, f = (2, 8, 32, 16), 16
    x = jnp.asarray(rng.uniform(-1, 1, shape), jnp.bfloat16)
    k = (rng.normal(size=(9 * shape[-1], f)) * 0.1).astype(np.float32)
    b = rng.normal(size=(f,)).astype(np.float32)
    g = jnp.asarray(rng.normal(size=shape[:3] + (f,)), jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        y, vjp = jax.vjp(deformable_conv2d_pallas, x, k, b)
        want = (y, *vjp(g))
    y_xla = deformable_conv2d(x, k, b)
    xt = torch.from_numpy(np.asarray(x, np.float32)).bfloat16().requires_grad_()
    kt, bt = torch.from_numpy(k).requires_grad_(), torch.from_numpy(b).requires_grad_()
    yt = da_conv(xt, kt, bt)
    got = (yt, *torch.autograd.grad(yt, (xt, kt, bt),
                                    torch.from_numpy(np.asarray(g, np.float32)).bfloat16()))
    assert [t.dtype for t in got] == [torch.bfloat16, torch.bfloat16, torch.float32,
                                      torch.float32]
    for name, a, w in zip(("y", "dx"), got, want):
        share, ulps = _flips(a.detach().float(), w)
        assert share <= 1e-3 and ulps <= 1.0, (name, share, ulps)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(want[2])).max()))
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]), rtol=1e-6)
    assert _flips(y_xla, want[0])[0] > 0.1


def test_bf16_folded_tiny_conv_matches_skyhdr():
    """`skyhdr` width-folds a stride-1 conv with <= 8 outputs
    (`fold_tiny_convs`, `skyhdr/models/layers.py:118-121`); the port runs
    the plain conv. In bf16 (a 7x7 conv, 32 -> 3, at 16x64) the output and
    dK agree to one ulp at a rounding boundary, and dx too. The bias
    gradient is the sum of the bf16 cotangent: the port rounds the float32
    sum once; XLA on the CPU sums in bf16, so `skyhdr`'s is not held here."""
    import jax
    import jax.numpy as jnp

    from skyhdr.ops.foldconv import pick_fold, width_folded_conv
    from skyhdr_torch.models.layers import Conv2D

    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, 16, 64, 32)).astype(np.float32)
    k = (rng.normal(size=(7, 7, 32, 3)) * 0.05).astype(np.float32)
    b = rng.normal(size=(3,)).astype(np.float32)
    g = jnp.asarray(rng.normal(size=(2, 16, 64, 3)), jnp.bfloat16)
    assert pick_fold(64, 3) > 1
    fold = lambda xx, kk, bb: width_folded_conv(xx.astype(jnp.bfloat16),
                                                kk.astype(jnp.bfloat16), bb)
    y, vjp = jax.vjp(fold, x, k, b)
    want = (y, *vjp(g))
    conv = Conv2D(32, 3, 7, dtype=torch.bfloat16)
    with torch.no_grad():
        conv.kernel.copy_(torch.from_numpy(k).permute(3, 2, 0, 1))
        conv.bias.copy_(torch.from_numpy(b))
    xt = torch.from_numpy(x).requires_grad_()
    yt = conv(xt)
    gt = torch.from_numpy(np.asarray(g, np.float32)).bfloat16()
    dx, dk, db = torch.autograd.grad(yt, (xt, conv.kernel, conv.bias), gt)
    for name, a, w in (("y", yt.detach().float(), want[0]), ("dx", dx, want[1]),
                       ("dk", dk.permute(2, 3, 1, 0), want[2])):
        share, ulps = _flips(a, w)
        assert share <= 1e-3 and ulps <= 1.0, (name, share, ulps)
    exact = gt.float().sum((0, 1, 2)).bfloat16().float()
    assert torch.equal(db, exact)


def test_bf16_perceptual_l1_within_skyhdrs_own_gap():
    """VGG16's perceptual L1 with bf16 features against `skyhdr`'s on the
    same inputs. The features, where the bf16 rounding happens, are held at
    each pool to half of `skyhdr`'s own bf16-vs-f32 gap (relative L1): both
    packages accumulate the bf16 convolutions in float32 and round their
    outputs, and differ only where a sum falls on the other side of a
    rounding boundary, which spreads through the pools (pool3: 6% of the
    elements, 0.07 of the own gap). The loss, mean |f(pred) - f(target)|,
    and its gradient are held within the own gap only: in the loss the
    features' bf16 errors cancel between f(pred) and f(target) (the own gap
    drops from the features' ~5e-3 to ~1.6e-4 here, 1.5e-5 on the train
    golden's inputs), the other package's rounding-boundary differences do
    not."""
    import jax
    import jax.numpy as jnp

    from skyhdr.models import vgg16 as jvgg
    from skyhdr_torch.models.vgg16 import perceptual_l1, vgg16_features, vgg_constants

    weights = jvgg.random_vgg16_weights()
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 1, (2, 16, 64, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    want = {dt: jax.value_and_grad(lambda p: jvgg.perceptual_l1(weights, p, b, dt))(a)
            for dt in (jnp.float32, jnp.bfloat16)}
    feats = {dt: [np.asarray(f, np.float32) for f in jvgg.vgg16_features(weights, a, dt)]
             for dt in (jnp.float32, jnp.bfloat16)}
    consts = vgg_constants(weights, "cpu")
    got = [f.float().numpy() for f in vgg16_features(consts, torch.from_numpy(a),
                                                      torch.bfloat16)]
    rel_l1 = lambda x, y: np.abs(x - y).sum() / np.abs(y).sum()
    for level, (g, w16, w32) in enumerate(zip(got, feats[jnp.bfloat16], feats[jnp.float32])):
        assert rel_l1(g, w16) <= G.BF16_GAP_SHARE * rel_l1(w32, w16), level
    pt = torch.from_numpy(a).requires_grad_()
    loss = perceptual_l1(consts, pt, torch.from_numpy(b), dtype=torch.bfloat16)
    (grad,) = torch.autograd.grad(loss, pt)
    (l16, g16), (l32, g32) = want[jnp.bfloat16], want[jnp.float32]
    l16, l32, g16, g32 = float(l16), float(l32), np.asarray(g16), np.asarray(g32)
    assert abs(float(loss.detach()) - l16) <= abs(l16 - l32)
    assert np.abs(grad.numpy() - g16).sum() <= np.abs(g16 - g32).sum()


def _flip_one_ulp(rate, seed):
    """A forward hook that moves a `rate` share of a bf16 output's elements
    (drawn from `seed`) one bf16 ulp up or down: what a device whose float32
    sums run in another order does to a bf16 layer's output."""
    gen = torch.Generator().manual_seed(seed)

    def hook(module, args, out):
        if out.dtype != torch.bfloat16:
            return out
        f = out.detach().float()
        ulp = torch.exp2(torch.floor(torch.log2(f.abs().clamp_min(1e-30))) - 7)
        pick = (torch.rand(f.shape, generator=gen) < rate).float()
        sign = torch.where(torch.rand(f.shape, generator=gen) < 0.5, -1.0, 1.0)
        return out + ((f + pick * sign * ulp).to(out.dtype) - out).detach()
    return hook


def test_one_ulp_roundings_move_the_bf16_sun_step(stored):
    """Why the card's run is held to coarser tolerances than the CPU's. On
    the card every bf16 layer of the sun-pose net rounds as on the CPU, to
    one ulp in ~1e-4 of the elements (chip_smoke.py: `bf16_layers`); the
    net amplifies such differences. Moving 1e-4 of every bf16 layer output
    one ulp, as a device that sums in another order does, moves the sun
    step's KL by as much as half `skyhdr`'s own bf16-vs-f32 gap on it (an
    H100: 2.74e-4 against 4.16e-4), and the unperturbed port stays within a
    fiftieth of that gap."""
    from skyhdr_torch.train.losses import kl_divergence

    cfg = G.bf16_config()
    x, gt = (torch.from_numpy(np.array(stored[k])) for k in ("ldr", "sunpose_gt"))
    names = list(stored["sun_metric_names"])
    want = float(stored["sun_metrics"][names.index("kl")])
    own = abs(float(stored["f32_sun_metrics"][names.index("kl")]) - want) / want

    def kl(rate, seed):
        net = G.bf16_states(stored, cfg, "cpu")[1].sun
        if rate:
            for m in net.modules():
                if not any(True for _ in m.children()):
                    m.register_forward_hook(_flip_one_ulp(rate, seed))
        with torch.no_grad():
            return float(kl_divergence(gt, net(x)[0]))

    assert abs(kl(0, 0) - want) / want <= own / 50
    moved = [abs(kl(1e-4, seed) - want) / want for seed in range(3)]
    assert max(moved) >= own / 2, (moved, own)


def _planted(opt, edit):
    """`opt.step` with `edit(grads, index_of_param)` applied to the gradients
    first."""
    step = opt.step

    def faulty(grads):
        grads = list(grads)
        edit(grads, {id(p): i for i, p in enumerate(opt.params)})
        return step(grads)

    opt.step = faulty


def _swap(a, b):
    def edit(grads, ix):
        grads[ix[id(a)]], grads[ix[id(b)]] = grads[ix[id(b)]], grads[ix[id(a)]]
    return edit


def _scale(p, by):
    def edit(grads, ix):
        grads[ix[id(p)]] = grads[ix[id(p)]] * by
    return edit


# fault -> the failures the comparison must report (each a prefix of a line)
FAULTS = {
    "swap_trunk_kernels": ("gan gradient gen/res0/conv1/kernel",
                           "gan gradient gen/res0/conv2/kernel"),
    "scale_sunpose_conv": ("gan gradient sun/sunlayer2/conv1/kernel",
                           "sun gradient sunlayer2/conv1/kernel"),
    # Rounding points moved: InstanceNorm's statistics taken in bf16, not
    # float32 (`skyhdr/models/layers.py:67-71`); the sun-pose softmax's
    # output rounded to bf16 (`skyhdr/models/sunpose.py:105-108` keeps it
    # float32).
    "instance_norm_stats_bf16": ("sun metric dog", "sun_eval metric dog"),
    "softmax_output_bf16": ("sun metric dog", "sun_eval metric dog"),
}


def _in_stats_in_x_dtype(self, x, act="none"):
    """`InstanceNorm.forward` (unfused) with the statistics in x.dtype."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = x.var(dim=(1, 2), keepdim=True, unbiased=False)
    y = (((x - mean) * torch.rsqrt(var + self.epsilon)).float() * self.scale
         + self.bias).to(x.dtype)
    return {"relu": torch.relu, "lrelu01": leaky_relu_01}.get(act, lambda t: t)(y)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_bf16_golden_sees_a_planted_fault(stored, clean_eval, monkeypatch, fault):
    cfg = G.bf16_config()
    state, sun_state = G.bf16_states(stored, cfg, "cpu")
    evals = clean_eval
    if fault == "swap_trunk_kernels":
        _planted(state.opt_gen, _swap(state.gen.res0.conv1.kernel, state.gen.res0.conv2.kernel))
    elif fault == "scale_sunpose_conv":
        _planted(state.opt_gen, _scale(state.sun.sunlayer2.conv1.kernel, 1.05))
        _planted(sun_state.opt, _scale(sun_state.sun.sunlayer2.conv1.kernel, 1.05))
    else:
        if fault == "instance_norm_stats_bf16":
            monkeypatch.setattr(InstanceNorm, "forward", _in_stats_in_x_dtype)
        else:
            forward = sunpose.SunPoseNet.forward

            def rounded(self, x, eps=None):
                sm, acts = forward(self, x, eps)
                return sm.to(torch.bfloat16).float(), acts

            monkeypatch.setattr(sunpose.SunPoseNet, "forward", rounded)
        evals = G.port_eval_bf16(stored, cfg, state, sun_state, "cpu")
    port = {**evals, **G.port_steps(stored, cfg, state, sun_state, "cpu")}
    fails, _ = G.compare_train_golden_bf16(stored, port)
    for want in FAULTS[fault]:
        assert any(line.startswith(want + ":") for line in fails), (want, fails)


def test_bf16_layer_check_sees_a_float32_layer(stored):
    """chip_smoke.py's card-vs-CPU layer check, here between two CPU copies
    of the bf16 sun-pose net: every layer equal, and the check passes; a
    copy whose sunlayer1.conv2 keeps its kernel in float32 (rounding only
    its output to bf16) differs there in over a quarter of the elements, and
    fails it."""
    from skyhdr_torch.models.layers import Conv2D
    from skyhdr_torch.train.losses import kl_divergence

    smoke = _load_chip_smoke()
    tables = smoke.bf16_layers(G, stored, False, ("cpu", "cpu"))
    assert all(row[5] == 0 for rows in tables.values() for row in rows)
    smoke.check_bf16_layers(tables, "cpu")
    cfg = G.bf16_config()
    nets = [smoke.build_port(cfg, int(stored["seed"]), "cpu")[1].requires_grad_(True)
            for _ in range(2)]
    conv = nets[1].sunlayer1.conv2
    conv.dtype = None
    conv.forward = lambda x, padding="SAME": Conv2D.forward(conv, x, padding).bfloat16()
    x, gt = (torch.from_numpy(np.array(stored[k])) for k in ("ldr", "sunpose_gt"))
    rows = smoke.layers_across_devices(nets, lambda net, dev: kl_divergence(gt, net(x)[0]))
    y = next(r for r in rows if r[:2] == ("sunlayer1.conv2", "y"))
    assert y[5] > 0.25, y
    with pytest.raises(SystemExit, match="sunlayer1.conv2"):
        smoke.check_bf16_layers({"sunpose": rows}, "planted")


def _load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _write_dataset(root, h, w, counts, seed=0):
    """Synthetic skies (`tools/make_synth_dataset.synth_panorama`), one
    record a file, as <root>/<split>/NNNN.tfrecord."""
    synth = _load_tool("make_synth_dataset").synth_panorama
    rng = np.random.default_rng(seed)
    for split, n in counts.items():
        os.makedirs(os.path.join(root, split))
        for i in range(n):
            img, sun_y = synth(rng, h, w)
            write_tfrecord(os.path.join(root, split, f"{i:04d}.tfrecord"),
                           [{"image": img[:, :, ::-1].tobytes(),
                             "azimuth": float(w * 0.5 - 1.0), "elevation": float(sun_y)}])
    return root


def test_bf16_training_cli_epoch_resume_and_sun_handoff(tmp_path, capsys):
    """train_sun then train under --compute-dtype bfloat16 at 16x64 DA b2:
    a SUN epoch, a SKY epoch that takes its sun-pose weights, a resume.
    The checkpoints hold float32 tensors, as under float32 compute."""
    from skyhdr_torch.cli import train, train_sun

    ds = _write_dataset(str(tmp_path / "ds"), 16, 64, {"train": 4, "test": 2})
    flags = ["--dir", ds, "--imheight", "16", "--imwidth", "64", "--da-conv", "true",
             "--batchsize", "2", "--ckpt-every", "1", "--workdir", str(tmp_path),
             "--device", "cpu", "--dorf", "", "--compute-dtype", "bfloat16"]
    train_sun.main(flags + ["--train", "true", "--epochs", "1", "--outputimg-every", "0",
                            "--seed", "7"])
    # lr 0: the SKY run moves no weight, so its checkpoint shows the hand-off.
    train.main(flags + ["--vgg", "", "--epochs", "1", "--lr", "0"])
    out = capsys.readouterr().out
    assert "Pretrained SUN checkpoint restored for fine-tuning" in out and "Epoch 1:" in out
    sky = CheckpointManager(str(tmp_path / "checkpoints" / "SKY"))
    sun = CheckpointManager(str(tmp_path / "checkpoints" / "SUN")).read_latest()
    blob = sky.read_latest()
    assert all(torch.equal(blob["modules"]["sun"][k], v)
               for k, v in sun["modules"]["sun"].items())
    assert all(v.dtype == torch.float32 for m in blob["modules"].values() for v in m.values())
    assert all(v.dtype == torch.float32 for o in blob["optimizers"].values() for v in o["nu"])
    train.main(flags + ["--vgg", "", "--epochs", "2"])
    out = capsys.readouterr().out
    assert "Latest SKY checkpoint restored (epoch 1)" in out
    assert "Epoch 2:" in out and "Epoch 1:" not in out
    assert sky.steps() == [1, 2]
    for line in out.splitlines():
        if line.startswith("Epoch 2:"):
            assert "nan" not in line.lower(), line
