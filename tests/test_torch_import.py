"""Reference checkpoints into the port: rave_tpu_torch's importer against rave_tpu's.

The repo holds no checkpoint of the reference (acids-ircam/RAVE), so
tools/torch_reference_ckpt.py writes one from a model's weights under the
reference's names and torch layouts. The first check holds that helper to
the JAX package's importer: `rave_tpu.utils.import_torch` maps its state
dict back onto the JAX template, every tensor where it came from (the
weight-normed kernels up to the re-decomposition's float32 rounding, all
else bit for bit).

Then, for v2, v1 (BatchNorm's running statistics), discrete (the RVQ's
codebooks), v3 (Snake's alpha; AdaIN's state is not imported), v2 with the
noise synth and hybrid (the GRU), both routes into the port give the same
weights bit for bit: the JAX importer followed by `from_jax_variables`, and
the port's importer on its own `to_jax_variables` template
(`load_reference_state`). The imported port model's encode and decode
match the JAX model's on the source weights within 1e-4 (the noise synths
fed the JAX draws). `to_jax_variables` gives back the JAX variables a model
was loaded from, bit for bit, the critics' included.

Last, `cli import_torch --device cpu` on a `.ckpt` (the helper's dict under
`state_dict`, `model.`-prefixed) and a `.gin` config: the run directory,
`--ema_weights` with and without an EMA entry, `cli export` then `generate`
on the run against the same artifact of the source weights, and `cli
train` resuming the imported run (its data settings given to the import as
overrides, so that both name the same run directory).
"""
import io
import json
import sys
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from rave_tpu.config import compose as jax_compose
from rave_tpu.factory import build_discriminator as jax_build_discriminator
from rave_tpu.factory import build_rave as jax_build_rave
from rave_tpu.utils.import_torch import import_reference_checkpoint
from rave_tpu_torch import cli, config
from rave_tpu_torch.config import compose
from rave_tpu_torch.factory import build_discriminator, build_rave
from rave_tpu_torch.nn.conv import ConvTranspose1d, _WeightNormConv
from rave_tpu_torch.train.state import create_train_state
from rave_tpu_torch.utils.checkpoint import save_checkpoint
from rave_tpu_torch.utils.convert import from_jax_variables, jax_path, to_jax_variables
from rave_tpu_torch.utils.import_torch import load_reference_state

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from torch_reference_ckpt import reference_state_dict, save_reference_ckpt  # noqa: E402

MODEL_TOL = 1e-4
CASES = {
    "v2": (["v2"], ["capacity=2", "latent_size=4", "ratios=[4,4,2]",
                    "dilations=[[1,3],[1,3],[1]]"]),
    "v1": (["v1"], ["capacity=4", "latent_size=4", "n_band=4", "ratios=[4,2]"]),
    "discrete": (["discrete"], ["capacity=2", "latent_size=4", "ratios=[4,4,2]",
                                "dilations=[[1],[1],[1]]", "latent.num_quantizers=2",
                                "latent.codebook_size=16", "latent.noise_augmentation=2"]),
    "v3": (["v3"], ["capacity=4", "latent_size=4", "ratios=[4,4,2]",
                    "dilations=[[1],[1],[1]]"]),
    "noise": (["v2", "noise"], ["capacity=2", "latent_size=4", "ratios=[4,4,2]",
                                "dilations=[[1],[1],[1]]", "decoder.noise_ratios=[4,2]",
                                "decoder.noise_bands=8"]),
    "hybrid": (["hybrid"], ["n_mels=16", "mel_n_fft=512", "mel_hop=128", "encoder.ratios=[4]",
                            "ratios=[4,4,2]", "capacity=2", "latent_size=4",
                            "dilations=[[1],[1],[1]]", "decoder.recurrent_layers=1"]),
}


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() or 1e-12))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(flat(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


def scrambled(variables, seed):
    """Every leaf away from its initial value (the RAVE buffers, the running
    statistics, the codebooks, Snake's alpha), so that an import which
    dropped one would show; AdaIN's state stays as initialized."""
    rng = np.random.default_rng(seed)

    def leaf(path, v):
        v = np.asarray(v)
        name = path[-1].key
        if path[0].key == "adain":
            return v
        if name in ("var", "cluster_size", "fidelity", "alpha"):
            return rng.uniform(0.5, 2.0, v.shape).astype(v.dtype)
        if name == "inited":
            return np.ones_like(v)
        if name == "receptive_field":
            return v
        return (v + rng.standard_normal(v.shape) * 0.1).astype(v.dtype)

    return jax.tree_util.tree_map_with_path(leaf, variables)


def transposed_paths(model):
    return {jax_path(n) for n, m in model.named_modules() if isinstance(m, ConvTranspose1d)}


class Case:
    """A preset's tiny JAX model with scrambled weights, the same weights in
    a port model, and their reference-named state dict."""

    def __init__(self, name, seed=0):
        names, overrides = CASES[name]
        self.cfg = compose(names, overrides)
        jcfg = jax_compose(names, overrides)
        self.jax_model = jax_build_rave(jcfg, train=False, stream_batch=1)
        x0 = jnp.zeros((1, self.cfg.block_size() * 2, 1), jnp.float32)
        init = jax_build_rave(jcfg, train=True).init(
            {"params": jax.random.key(seed), "noise": jax.random.key(1)}, x0)
        self.variables = scrambled({k: v for k, v in init.items() if k != "cache"}, seed)
        self.source = build_rave(self.cfg, seed=3, device="cpu")
        from_jax_variables(self.source, self.variables)
        self.sd = reference_state_dict(self.variables, generator=self.cfg.decoder.kind,
                                       transposed=transposed_paths(self.source))
        self.np_sd = {k: v.numpy() for k, v in self.sd.items()}


@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    return Case(request.param)


def effective_state(model):
    """`model.state_dict()` with each weight-normed conv's (v, g) replaced
    by its kernel: what an import keeps (it re-decomposes the kernel)."""
    state = dict(model.state_dict())
    for name, m in model.named_modules():
        if isinstance(m, _WeightNormConv) and m.weight_norm:
            del state[f"{name}.v"], state[f"{name}.g"]
            state[f"{name}.kernel"] = m.weight().detach()
    return state


def effective(v, g):
    v = np.asarray(v, np.float64)
    return v * np.asarray(g).reshape(1, 1, -1) / np.sqrt((v ** 2).sum(axis=(0, 1), keepdims=True))


def test_helper_is_reference_named(case):
    """rave_tpu's importer maps the helper's dict back onto the JAX template:
    every template leaf filled at its shape, the plain tensors bit for bit,
    the weight-normed kernels' products within 1e-6."""
    v = case.variables
    params, buffers, codebook, stats = import_reference_checkpoint(
        case.np_sd, v["params"], v["buffers"], v.get("codebook"))
    assert all(k.startswith("model.") for k in case.sd)
    got, want = flat(params), flat(v["params"])
    assert {k: a.shape for k, a in got.items()} == {k: a.shape for k, a in want.items()}
    for path, value in want.items():
        if path.endswith("/v"):
            g = path[:-2] + "/g"
            err = rel_err(effective(got[path], got[g]), effective(value, want[g]))
            assert err < 1e-6, path
        elif not path.endswith("/g"):
            np.testing.assert_array_equal(got[path], value, err_msg=path)
    for name in ("latent_pca", "latent_mean", "fidelity"):
        np.testing.assert_array_equal(buffers[name], np.asarray(v["buffers"][name]))
    for collection, tree in (("codebook", codebook), ("batch_stats", stats)):
        assert (tree is None) == (collection not in v), collection
        if tree is not None:
            g, w = flat(tree), flat(v[collection])
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_array_equal(g[k].reshape(w[k].shape), w[k], err_msg=k)


def test_both_routes_give_the_same_port_weights(case):
    """The JAX importer then `from_jax_variables`, and `load_reference_state`
    on the port's own template: the same port tensors, bit for bit; then the
    port model's encode and decode against the JAX model on the source."""
    v = case.variables
    params, buffers, codebook, stats = import_reference_checkpoint(
        case.np_sd, v["params"], v["buffers"], v.get("codebook"))
    routed = {"params": params, "buffers": buffers, "adain": v.get("adain", {})}
    routed.update({k: t for k, t in (("codebook", codebook), ("batch_stats", stats)) if t})
    via_jax = build_rave(case.cfg, seed=5, device="cpu")
    from_jax_variables(via_jax, routed)
    port = build_rave(case.cfg, seed=7, device="cpu")
    load_reference_state(port, case.np_sd)
    a, b = via_jax.state_dict(), port.state_dict()
    assert set(a) == set(b)
    for name in a:
        assert torch.equal(a[name], b[name]), name
    got = effective_state(port)
    for name, t in effective_state(case.source).items():  # the import moved every tensor
        assert torch.allclose(got[name], t, rtol=1e-5, atol=1e-6), name

    cfg, port = case.cfg, port.eval()
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, cfg.block_size() * 4, 1)) * 0.3).astype(np.float32)
    jv = {k: v[k] for k in v if k in ("params", "buffers", "batch_stats", "codebook", "adain")}
    z_j = np.asarray(case.jax_model.apply(jv, jnp.asarray(x), method="encode"))
    with torch.no_grad():
        z_p = port.encode(torch.from_numpy(x.transpose(0, 2, 1).copy())).numpy()
    assert rel_err(z_p.transpose(0, 2, 1), z_j) <= MODEL_TOL
    latent = rng.standard_normal((2, 8, cfg.augmented_latent_size())).astype(np.float32)
    drawn = []
    real = jax.random.uniform

    def uniform(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        u = real(key, shape, dtype, minval, maxval)
        if len(tuple(shape)) == 4:  # the noise synth's draw
            jax.debug.callback(lambda d: drawn.append(np.asarray(d)), u)
        return u

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", uniform)
        y_j = np.asarray(case.jax_model.apply(jv, jnp.asarray(latent), method="decode",
                                              rngs={"noise": jax.random.key(2)}))
    u = torch.from_numpy(drawn[0]) if drawn else None
    assert (u is None) == (cfg.noise_ratios() is None)
    with torch.no_grad():
        y_p = port.decode(torch.from_numpy(latent.transpose(0, 2, 1).copy()), u).numpy()
    assert rel_err(y_p.transpose(0, 2, 1), y_j) <= MODEL_TOL


def test_to_jax_variables_round_trips(case):
    """`to_jax_variables` of the model loaded from the JAX variables gives
    them back exactly, and loading its own output changes nothing."""
    back = to_jax_variables(case.source)
    assert set(back) == set(case.variables)
    got, want = flat(back), flat(case.variables)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and np.array_equal(got[k], want[k]), k
    before = {k: t.clone() for k, t in case.source.state_dict().items()}
    from_jax_variables(case.source, back)
    assert all(torch.equal(t, before[k]) for k, t in case.source.state_dict().items())


@pytest.mark.parametrize("names,overrides", [
    (["v2"], ["capacity=2", "discriminator.capacity=2"]),
    (["v2", "spectral_discriminator"], ["discriminator.capacity=2",
                                        "discriminator.spectral_scales=[512,256]",
                                        "discriminator.encodec_capacity=4"]),
    (["v3"], ["discriminator.descript_periods=[2]", "discriminator.descript_fft_sizes=[256]"]),
], ids=["combined", "spectral", "descript"])
def test_critic_to_jax_variables_round_trips(names, overrides):
    """The critics too: 1D, folded (K, 1) and 2D kernels back to their flax layouts."""
    x = np.zeros((2, 4096, 1), np.float32)
    variables = jax.jit(jax_build_discriminator(jax_compose(names, overrides)).init)(
        {"params": jax.random.key(0)}, jnp.asarray(x))
    critic = build_discriminator(compose(names, overrides), device="cpu")
    from_jax_variables(critic, variables)
    got, want = flat(to_jax_variables(critic)), flat(dict(variables))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and np.array_equal(got[k], want[k]), k


# ---------------------------------------------------------------------------
# cli import_torch
# ---------------------------------------------------------------------------

RUN_GIN = """include "configs/v2.gin"
CAPACITY = 2
LATENT_SIZE = 4
RATIOS = [4, 4, 2]
DILATIONS = [[1, 3], [1, 3], [1]]
"""


def run(args):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        try:
            code = cli.main([str(a) for a in args])
        except SystemExit as e:
            code, _ = 1, err.write(str(e.code))
    return code, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def imported(tmp_path_factory):
    """A v2 run's weights (scrambled JAX ones) as a reference `.ckpt` with an
    EMA entry (the weights of another seed), its `.gin`, and `cli
    import_torch` of it with and without `--ema_weights`."""
    root = tmp_path_factory.mktemp("import_torch")
    gin = root / "run.gin"
    gin.write_text(RUN_GIN)
    cfg = compose([str(gin)])
    assert cfg.name == "run" and (cfg.capacity, cfg.latent_size) == (2, 4)
    jcfg = jax_compose([str(gin)])
    x0 = jnp.zeros((1, cfg.block_size() * 2, 1), jnp.float32)
    sources, sds = [], []
    for seed in (0, 1):
        init = jax_build_rave(jcfg, train=True).init(
            {"params": jax.random.key(seed), "noise": jax.random.key(1)}, x0)
        variables = scrambled({k: v for k, v in init.items() if k != "cache"}, seed)
        model = build_rave(cfg, device="cpu")
        from_jax_variables(model, variables)
        sources.append(model)
        sds.append(reference_state_dict(variables, transposed=transposed_paths(model)))
    save_reference_ckpt(root / "run.ckpt", sds[0], ema=sds[1])
    save_reference_ckpt(root / "no_ema.ckpt", sds[0])
    runs = {}
    for kind, extra in (("live", []), ("ema", ["--ema_weights"])):
        code, out, err = run(["import_torch", "--device", "cpu", "--ckpt", root / "run.ckpt",
                              "--config", gin, "--name", kind, "--out_path", root / "runs",
                              *extra])
        assert code == 0, err
        runs[kind] = Path(out.strip().splitlines()[-1].removeprefix("imported into: "))
    return {"root": root, "gin": gin, "cfg": cfg, "sources": sources, "runs": runs}


@pytest.mark.parametrize("kind", ["live", "ema"])
def test_cli_import_torch_writes_a_run(imported, kind):
    """The run directory: its config (the gin's), a step-0 checkpoint whose
    model is the source's (the EMA's with `--ema_weights`) and whose critic
    and Adams are a fresh train state's."""
    run_dir = imported["runs"][kind]
    assert run_dir.name.startswith(f"{kind}_")
    saved = config.from_dict(json.loads((run_dir / "config.json").read_text()))
    assert config.snapshot(saved) == config.snapshot(imported["cfg"])
    ckpts = sorted((run_dir / "checkpoints").iterdir())
    assert [p.name for p in ckpts] == ["step_0000000000.pt"]
    ckpt = torch.load(ckpts[0], weights_only=True)
    assert ckpt["step"] == 0 and ckpt["ema"] is None
    model = build_rave(imported["cfg"], device="cpu")
    model.load_state_dict(ckpt["model"])
    got = effective_state(model)
    for name, t in effective_state(imported["sources"][kind == "ema"]).items():
        assert torch.allclose(got[name], t, rtol=1e-5, atol=1e-6), name
    fresh = create_train_state(imported["cfg"], device="cpu")
    assert all(torch.equal(t, fresh.discriminator.state_dict()[k])
               for k, t in ckpt["discriminator"].items())


def test_cli_import_torch_without_ema_entry_fails(imported):
    root = imported["root"]
    code, _, err = run(["import_torch", "--device", "cpu", "--ckpt", root / "no_ema.ckpt",
                        "--config", imported["gin"], "--name", "x", "--out_path",
                        root / "none", "--ema_weights"])
    assert code != 0 and "no EMA" in err
    assert not (root / "none").exists()


def test_cli_import_export_generate_reproduces_the_source(imported, tmp_path):
    """`export` then `generate` on the imported run against the artifact of
    the source weights saved as a port run: the same wav within float32's
    weight-norm rounding."""
    from rave_tpu_torch.export.artifact import ExportedRAVE

    cfg, root = imported["cfg"], imported["root"]
    source_run = tmp_path / "source_run"
    source_run.mkdir()
    (source_run / "config.json").write_text(config.snapshot(cfg))
    state = create_train_state(cfg, device="cpu")
    state.model.load_state_dict(imported["sources"][0].state_dict())
    save_checkpoint(str(source_run), state)
    sr = cfg.sampling_rate
    t = np.arange(3 * cfg.block_size() * 4) / sr
    wav = tmp_path / "in.wav"
    wavfile.write(wav, sr, (0.4 * np.sin(2 * np.pi * 330 * t) * 32767).astype(np.int16))
    outs = {}
    for kind, run_dir in (("imported", imported["runs"]["live"]), ("source", source_run)):
        art = tmp_path / f"art_{kind}"
        code, _, err = run(["export", "--device", "cpu", "--run", run_dir, "--output", art])
        assert code == 0, err
        code, _, err = run(["generate", "--device", "cpu", "--model", art / "run.rtpu",
                            "--input", wav, "--out_path", tmp_path / f"gen_{kind}",
                            "--seed", 3])
        assert code == 0, err
        outs[kind] = wavfile.read(tmp_path / f"gen_{kind}" / "in_reconstructed.wav")[1]
        x = torch.from_numpy(wavfile.read(wav)[1].astype(np.float32) / 32768)[None, None]
        with torch.no_grad():
            outs[kind + "_forward"] = ExportedRAVE(str(art / "run.rtpu"), device="cpu",
                                                   seed=3).forward(x)
    assert outs["imported"].shape == outs["source"].shape == (t.size,)
    assert np.abs(outs["imported"].astype(np.int32) - outs["source"]).max() <= 1
    assert rel_err(outs["imported_forward"], outs["source_forward"]) <= 1e-5
    assert np.abs(outs["imported"]).max() > 0


def test_cli_train_resumes_an_imported_run(imported, tmp_path):
    """An import given the training's data settings as overrides names the
    run directory `train` then resumes from its step-0 checkpoint."""
    root = imported["root"]
    (tmp_path / "corpus").mkdir()
    t = np.arange(20 * 8192) / 44100
    wavfile.write(tmp_path / "corpus" / "a.wav", 44100,
                  (0.3 * np.sin(2 * np.pi * 220 * t) * 32767).astype(np.int16))
    assert run(["preprocess", "--input_path", tmp_path / "corpus", "--output_path",
                tmp_path / "db", "--num_signal", 8192, "--workers", 2])[0] == 0
    shared = ["--config", imported["gin"], "--name", "resumed", "--out_path", tmp_path / "runs"]
    for o in ("train.valid_signal_crop=false", "distance.scales=[512,256]"):
        shared += ["--override", o]
    code, out, err = run(["import_torch", "--device", "cpu", "--ckpt", root / "run.ckpt",
                          "--override", "data.batch=2", "--override", "data.n_signal=8192",
                          *shared])
    assert code == 0, err
    run_dir = Path(out.strip().splitlines()[-1].removeprefix("imported into: "))
    code, out, err = run(["train", "--device", "cpu", "--db_path", tmp_path / "db", "--batch", 2,
                          "--n_signal", 8192, "--max_steps", 1, "--val_every", 100,
                          *shared])
    assert code == 0, err
    assert "resumed at step 0" in out
    assert Path(out.strip().splitlines()[-1].removeprefix("run dir: ")) == run_dir
    assert [p.name for p in sorted((run_dir / "checkpoints").iterdir())] == [
        "step_0000000000.pt", "step_0000000001.pt"]
