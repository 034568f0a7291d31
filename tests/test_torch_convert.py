"""Checkpoints of `skyhdr` (Orbax) served and resumed by the port, on the
CPU at 16x64 DA b2: `skyhdr.train.checkpoints.CheckpointManager` saves
GanStates and SunStates built from `make_torch_golden.resume_export` (the
seeded weights; BatchNorm statistics and optimizer moments drawn nonzero,
so that a wrong leaf mapping shows), `tools/export_jax_checkpoint.py`
exports them and `skyhdr_torch.cli.import_checkpoint` imports them.

Tolerances: every leaf exactly (float32, and bfloat16 upcast); serving
against `skyhdr`'s at rtol 1e-3, atol 1e-3 (tests/test_torch_slice.py);
the resumed GAN and sun steps within the train golden's (metrics 1e-3,
updates 2e-2 of the leaf's sum |update|, BatchNorm sums 1e-4;
chip_smoke.py's GOLDEN_*); the port against itself exactly."""

import importlib.util
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skyhdr.config import Config as JConfig
from skyhdr.config import DataConfig as JDataConfig
from skyhdr.config import ModelConfig as JModelConfig
from skyhdr.train.checkpoints import CheckpointManager as JCheckpointManager
from skyhdr_torch.cli import import_checkpoint, inference
from skyhdr_torch.data import records as trec
from skyhdr_torch.train import engine
from skyhdr_torch.train.checkpoints import CheckpointManager
from skyhdr_torch.train.convert import export_from_state, state_from_export
from skyhdr_torch.train.loop import TrainLoop
from skyhdr_torch.utils.flax_export import MANIFEST, read_export, write_export
from skyhdr_torch.utils.png import write_png
from skyhdr_torch.utils.transplant import load_model_vars

# The suite runs in several worker processes that share the CPU.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 16, 64
FLAGS = ["--imheight", str(H), "--imwidth", str(W), "--da-conv", "true"]
METRIC_RTOL, UPDATE_RTOL = 1e-3, 2e-2


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


G = _load("make_torch_golden", "tools/make_torch_golden.py")
TOOL = _load("export_jax_checkpoint", "tools/export_jax_checkpoint.py")
CFG = G.golden_config()


@pytest.fixture(scope="module")
def source():
    return G.resume_export(0)


def _convert(root, source, names=("SKY", "SUN"), tool_flags=(), **dtypes):
    """Orbax checkpoints of `source`'s states (with `dtypes`), exported by
    the tool (given `tool_flags` too) and imported by the port's CLI: (JAX
    workdir, export, port workdir)."""
    jwork, out, pwork = (str(root / d) for d in ("jax", "export", "port"))
    for name in names:
        JCheckpointManager(os.path.join(jwork, "checkpoints", name)).save(
            source[name][0]["orbax_step"], G.jax_state(source[name], **dtypes))
    TOOL.main(["--workdir", jwork, "--out", out, *FLAGS, *tool_flags])
    import_checkpoint.main(["--export", out, "--workdir", pwork, *FLAGS, "--device", "cpu"])
    return jwork, out, pwork


@pytest.fixture(scope="module")
def f32(tmp_path_factory, source):
    return _convert(tmp_path_factory.mktemp("f32"), source)


@pytest.fixture(scope="module")
def bf16_params(tmp_path_factory, source):
    # The command line it was trained with: the tool's first template fits.
    return _convert(tmp_path_factory.mktemp("bf16p"), source,
                    tool_flags=("--param-dtype", "bfloat16"), param_dtype="bfloat16")


def _blob(pwork, name):
    return CheckpointManager(os.path.join(pwork, "checkpoints", name)).read_latest()


def _same_leaves(got, want):
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_array_equal(np.asarray(got[path]), want[path], err_msg=path)


def _bf16(x):
    """`x` rounded to bfloat16 as JAX stores it, back in float32."""
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


@pytest.mark.parametrize("name", ["SKY", "SUN"])
def test_every_leaf_exact(f32, source, name):
    """Params, BatchNorm statistics, RMSprop nu (gen, sun, disc), Adam mu,
    nu and count, step and epoch: through Orbax, the tool and the import,
    then back out of the port's checkpoint."""
    _, out, pwork = f32
    want_manifest, want = source[name]
    manifest, leaves = read_export(os.path.join(out, name))
    _same_leaves(leaves, want)
    assert {k: manifest[k] for k in want_manifest} == want_manifest
    assert CheckpointManager(os.path.join(pwork, "checkpoints", name)).steps() == [
        want_manifest["orbax_step"]]
    state = engine.load_state(_blob(pwork, name), CFG, "cpu")
    got_manifest, got = export_from_state(state)
    _same_leaves(got, want)
    assert got_manifest == want_manifest


def test_bf16_moments_import_upcast_exactly(tmp_path, source):
    """A SunState trained with opt_state_dtype=bfloat16: Adam's mu and nu
    upcast exactly, its count an integer as before. The tool is told
    param_dtype=bfloat16, so its first template does not fit and the
    float32 one does."""
    _, out, pwork = _convert(tmp_path, source, names=("SUN",), opt_state_dtype="bfloat16",
                             tool_flags=("--param-dtype", "bfloat16"))
    manifest, _ = read_export(os.path.join(out, "SUN"))
    assert manifest["opt_state_dtype"] == "bfloat16" and manifest["param_dtype"] == "float32"
    assert {p: e["dtype"] for p, e in manifest["leaves"].items() if p.startswith("opt")} == {
        p: "bfloat16" for p in source["SUN"][1] if p.startswith("opt")}
    state = engine.load_state(_blob(pwork, "SUN"), CFG, "cpu")
    got_manifest, got = export_from_state(state)
    assert got_manifest["count"] == 7
    _same_leaves(got, {p: _bf16(v) if p.startswith("opt") else v
                       for p, v in source["SUN"][1].items()})


def _write_pngs(folder, n=2, seed=1):
    rng = np.random.default_rng(seed)
    os.makedirs(folder)
    for i in range(n):
        write_png(os.path.join(folder, f"pano{i}.png"),
                  rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
    return folder, np.stack([inference._imread01(os.path.join(folder, f"pano{i}.png"))
                             for i in range(n)])


def _serve(monkeypatch, indir, outdir, pwork):
    """The port's serving CLI from the checkpoints under `pwork`: its
    outputs, caught before the .hdr encoding."""
    got = {}
    monkeypatch.setattr(inference, "write_hdr",
                        lambda path, hdr: got.__setitem__(os.path.basename(path), hdr))
    inference.main(["--indir", indir, "--outdir", outdir, *FLAGS, "--batch", "2",
                    "--device", "cpu", "--workdir", pwork])
    return np.stack([got[f"pano{i}.hdr"] for i in range(2)])


def _port_forward(gen_tree, sun_tree, ldr):
    gen, sun = engine.build_models(CFG, "cpu")
    load_model_vars(gen, gen_tree)
    load_model_vars(sun, sun_tree)
    with torch.no_grad():
        return engine.make_inference_fn(CFG)(gen, sun, torch.from_numpy(ldr))[
            "y_final_lin"].numpy()


def _vars(leaves, prefix, round_params=False):
    from skyhdr_torch.utils.flax_export import unflatten

    tree = unflatten(leaves, prefix)
    if round_params:
        tree["params"] = _map(tree["params"], _bf16)
    return tree


def _map(tree, fn):
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def test_serving_matches_skyhdr(f32, source, tmp_path, monkeypatch, capsys):
    """`skyhdr`'s serving from the Orbax SKY + SUN checkpoints against the
    port's CLI from the imported ones, on the same PNGs. The SUN
    checkpoint's sun-pose net is not the SKY one's, and both packages
    serve the SUN one."""
    from skyhdr.cli.common import restore_model_vars
    from skyhdr.train.engine import make_inference_fn

    jwork, _, pwork = f32
    indir, ldr = _write_pngs(str(tmp_path / "in"))
    jcfg = JConfig(model=JModelConfig(**vars(CFG.model)), data=JDataConfig(batch_size=2))
    logs = []
    gv, sv = restore_model_vars(jcfg, jwork, log=logs.append)
    assert logs == ["Latest SKY checkpoint restored", "Latest SUN checkpoint restored"]
    want = np.asarray(make_inference_fn(jcfg)(gv, sv, jnp.asarray(ldr))["y_final_lin"])
    got = _serve(monkeypatch, indir, str(tmp_path / "out"), pwork)
    text = capsys.readouterr().out
    assert "Latest SKY checkpoint restored" in text and "Latest SUN checkpoint restored" in text
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    sky = source["SKY"][1]
    with_sky_sun = _port_forward(_vars(sky, "gen_vars"), _vars(sky, "sun_vars"), ldr)
    assert not np.allclose(with_sky_sun, want, rtol=1e-3, atol=1e-3)


@pytest.fixture(scope="module")
def jax_resumed(f32):
    """One JAX GAN step and one JAX sun step from the states the tool
    restores from Orbax (`make_resume_golden` on them)."""
    jwork = f32[0]
    from skyhdr.config import Config, DataConfig, ModelConfig
    from skyhdr.train.engine import create_gan_state, create_sun_state

    jcfg = Config(model=ModelConfig(**vars(CFG.model)), data=DataConfig(batch_size=2))
    states = [TOOL.restore_host(jcfg, os.path.join(jwork, "checkpoints", name), factory)[1]
              for name, factory in (("SKY", create_gan_state), ("SUN", create_sun_state))]
    return G.make_resume_golden(0, states=states)


def test_resumed_steps_match_skyhdr(f32, jax_resumed):
    pwork = f32[2]
    gan, sun = (CheckpointManager(os.path.join(pwork, "checkpoints", name)).restore_latest(
        CFG, "cpu") for name in ("SKY", "SUN"))
    assert (gan.step, gan.epoch, sun.step, sun.epoch, sun.opt.count) == (12, 2, 7, 1, 7)
    port = G.port_steps(jax_resumed, CFG, gan, sun, "cpu")
    fails, worst = G.compare_train_golden(jax_resumed, port, METRIC_RTOL, UPDATE_RTOL)
    assert not fails, (fails[:10], json.dumps(worst))


def test_resume_golden_fixture_regenerates(jax_resumed):
    stored = np.load(G.RESUME_FIXTURE)
    assert sorted(jax_resumed) == sorted(stored.files)
    for name in stored.files:
        if stored[name].dtype.kind in "US":
            np.testing.assert_array_equal(jax_resumed[name], stored[name], err_msg=name)
        else:
            np.testing.assert_allclose(jax_resumed[name], stored[name], rtol=1e-6,
                                       atol=1e-9, err_msg=name)
    assert os.path.getsize(G.RESUME_FIXTURE) < 60 * 1024


@pytest.fixture(scope="module")
def golden_import(tmp_path_factory, source):
    """The resume golden's export rebuilt from numpy and imported by the
    CLI: the port's workdir."""
    root = tmp_path_factory.mktemp("golden")
    out, pwork = str(root / "export"), str(root / "port")
    for name, (manifest, leaves) in source.items():
        write_export(os.path.join(out, name), manifest, leaves)
    import_checkpoint.main(["--export", out, "--workdir", pwork, *FLAGS, "--device", "cpu"])
    return pwork


def _golden_states(pwork):
    return [CheckpointManager(os.path.join(pwork, "checkpoints", name)).restore_latest(
        CFG, "cpu") for name in ("SKY", "SUN")]


def test_resume_golden_on_the_port(source, golden_import):
    """The port's side of chip_smoke.py's resume golden, on the CPU against
    the stored file: the export rebuilt from numpy, imported by the CLI,
    one GAN step and one sun step."""
    stored = np.load(G.RESUME_FIXTURE)
    assert G.export_digest(source) == pytest.approx(float(stored["export_digest"]), rel=1e-12)
    gan, sun = _golden_states(golden_import)
    fails, worst = G.compare_train_golden(stored, G.port_steps(stored, CFG, gan, sun, "cpu"),
                                          METRIC_RTOL, UPDATE_RTOL)
    assert not fails, (fails[:10], json.dumps(worst))


@torch.no_grad()
def _swap_trunk_nu(gan, sun):
    nu = gan.opt_gen.moments()["nu"]
    a, b = nu[gan.gen.res0.conv1.kernel], nu[gan.gen.res0.conv2.kernel]
    held = a.clone()
    a.copy_(b)
    b.copy_(held)


def _adam_count_0(gan, sun):
    sun.opt.count = 0


@torch.no_grad()
def _adam_mu_0(gan, sun):
    for mu in sun.opt.mu:
        mu.zero_()


@pytest.mark.parametrize("fault, kind", [(_swap_trunk_nu, "gan"), (_adam_count_0, "sun"),
                                         (_adam_mu_0, "sun")],
                         ids=["swapped_trunk_nu", "adam_count_0", "adam_mu_0"])
def test_resume_golden_sees_a_wrong_moment(golden_import, fault, kind):
    """The resume golden fails when an imported moment sits on the wrong
    leaf or an optimizer counter is lost: two trunk kernels' RMSprop
    moments swapped, Adam's count 0, Adam's first moments zeroed. The
    other tests map both directions through one layout, so only this
    parity can see such a mistake, and only while the drawn moments
    weigh against the gradients (`make_torch_golden.resume_export`)."""
    stored = np.load(G.RESUME_FIXTURE)
    gan, sun = _golden_states(golden_import)
    fault(gan, sun)
    fails, _ = G.compare_train_golden(stored, G.port_steps(stored, CFG, gan, sun, "cpu"),
                                      METRIC_RTOL, UPDATE_RTOL)
    assert fails and all(f.startswith(f"{kind} update ") for f in fails), fails[:10]


def test_bf16_params_serve_the_stored_params(bf16_params, source, tmp_path, monkeypatch):
    _, out, pwork = bf16_params
    for name in ("SKY", "SUN"):
        manifest, leaves = read_export(os.path.join(out, name))
        assert manifest["param_dtype"] == "bfloat16" and manifest["opt_state_dtype"] is None
        assert not any(p.startswith("opt") for p in leaves)
        blob = _blob(pwork, name)
        assert blob["param_dtype"] == "bfloat16" and blob["optimizers"] == {}
    indir, ldr = _write_pngs(str(tmp_path / "in"))
    got = _serve(monkeypatch, indir, str(tmp_path / "out"), pwork)
    sky, sun = source["SKY"][1], source["SUN"][1]
    want = _port_forward(_vars(sky, "gen_vars", round_params=True),
                         _vars(sun, "sun_vars", round_params=True), ldr)
    np.testing.assert_array_equal(got, want)


def _write_records(root, n=2, seed=0):
    rng = np.random.default_rng(seed)
    for split in ("train", "test"):
        os.makedirs(os.path.join(root, split))
        trec.write_tfrecord(os.path.join(root, split, "0000.tfrecord"), [
            {"image": rng.uniform(0.0, 4.0, (H, W, 3)).astype(np.float32).tobytes(),
             "azimuth": float(W // 2 - 1), "elevation": float(rng.uniform(2, H - 3))}
            for _ in range(n)])
    return root


def test_bf16_params_hand_off_the_stored_sun_pose_net(bf16_params, tmp_path, capsys):
    """A fresh GAN run of the port's training CLI takes the SUN
    checkpoint's stored (bfloat16) sun-pose parameters, as
    `skyhdr.cli.train` does; at lr 0 its checkpoint shows them."""
    from skyhdr_torch.cli import train

    pwork = bf16_params[2]
    work = str(tmp_path / "run")
    train.main(["--dir", _write_records(str(tmp_path / "ds")), *FLAGS, "--batchsize", "2",
                "--epochs", "1", "--ckpt-every", "1", "--lr", "0", "--workdir", work,
                "--device", "cpu", "--dorf", "", "--vgg", "",
                "--sun", os.path.join(pwork, "checkpoints", "SUN")])
    assert "Pretrained SUN checkpoint restored for fine-tuning" in capsys.readouterr().out
    want = _blob(pwork, "SUN")["modules"]["sun"]
    got = _blob(work, "SKY")["modules"]["sun"]
    assert sorted(got) == sorted(want) and all(torch.equal(got[k], v) for k, v in want.items())


def test_bf16_params_refuse_to_resume(bf16_params):
    pwork = bf16_params[2]
    for name in ("SKY", "SUN"):
        with pytest.raises(NotImplementedError, match="param_dtype='bfloat16'.*Queue 1 item 6"):
            CheckpointManager(os.path.join(pwork, "checkpoints", name)).restore_latest(CFG, "cpu")
    drawn = []
    with pytest.raises(NotImplementedError, match="param_dtype"):
        TrainLoop(CFG, "SKY", lambda: drawn.append(1), None, None, None, None,
                  workdir=pwork, log=lambda *_: None, device="cpu")
    assert not drawn  # no fresh start in its place


@pytest.mark.parametrize("kind", ["gan", "sun"])
def test_round_trip_is_the_identity(kind):
    """export_from_state -> state_from_export from a port state whose every
    tensor (moments included) and counter is nonzero."""
    state = (engine.create_gan_state if kind == "gan" else engine.create_sun_state)(
        CFG, 0, "cpu")
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for opt in state.optimizers().values():
            for moments in opt.moments().values():
                for t in moments.values():
                    t.copy_(torch.rand(t.shape, generator=gen))
        for module in state.modules().values():
            for t in module.buffers():
                t.copy_(torch.rand(t.shape, generator=gen))
    state.step, state.epoch = 9, 3
    if kind == "sun":
        state.opt.count = 9
    before = engine.state_dict(state)
    back = engine.state_dict(state_from_export(export_from_state(state), CFG, "cpu"))
    assert back["step"] == 9 and back["epoch"] == 3
    for group in ("modules", "optimizers"):
        for name, part in before[group].items():
            for key, v in part.items():
                w = back[group][name][key]
                same = (all(torch.equal(a, b) for a, b in zip(v, w)) and len(v) == len(w)
                        if isinstance(v, list) else
                        torch.equal(v, w) if torch.is_tensor(v) else v == w)
                assert same, f"{group}/{name}/{key}"


def _broken(source, how):
    manifest, leaves = source["SKY"]
    manifest, leaves = dict(manifest), dict(leaves)
    path = "gen_vars/params/res0/conv1/kernel"
    if how == "model shape":
        manifest["im_width"] = 128
    elif how == "leaf shape":
        leaves[path] = leaves[path][:, :1]
    elif how == "missing leaf":
        del leaves[path]
    elif how == "unexpected leaf":
        leaves["opt_gen/nu/2/x"] = leaves[path]
    elif how == "kind":
        manifest["kind"] = "disc"
    return manifest, leaves


@pytest.mark.parametrize("how,match", [
    ("model shape", "im_width \\(128, 64\\)"),
    ("leaf shape", "res0/conv1/kernel: shape"),
    ("missing leaf", "missing \\['gen_vars/params/res0/conv1/kernel'\\]"),
    ("unexpected leaf", "unexpected \\['opt_gen/nu/2/x'\\]"),
    ("kind", "kind 'disc'"),
])
def test_import_refuses_a_mismatched_export(source, how, match):
    with pytest.raises(ValueError, match=match):
        state_from_export(_broken(source, how), CFG, "cpu")


def test_read_export_checks_format_and_shapes(source, tmp_path):
    manifest, leaves = source["SUN"]
    out = str(tmp_path / "e")
    write_export(out, manifest, leaves)
    assert read_export(out)[0]["format"] == "skyhdr-flax-export"
    with open(os.path.join(out, MANIFEST)) as f:
        doc = json.load(f)
    for key, value, match in (("version", 2, "version 2"),
                              ("leaves", {"sun_vars/params/fc2/bias": {"shape": [1]}},
                               "fc2/bias: shape")):
        with open(os.path.join(out, MANIFEST), "w") as f:
            json.dump(dict(doc, **{key: value}), f)
        with pytest.raises(ValueError, match=match):
            read_export(out)


def test_import_cli_needs_an_export(tmp_path):
    with pytest.raises(SystemExit, match="no SKY/manifest.json or SUN/manifest.json"):
        import_checkpoint.main(["--export", str(tmp_path), "--workdir", str(tmp_path),
                                *FLAGS, "--device", "cpu"])
