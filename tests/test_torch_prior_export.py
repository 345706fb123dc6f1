"""The prior in the artifact: `cli export --prior`, `ExportedRAVE.sample_prior`,
its `prior_step.pt2` program and `cli generate --prior_seconds`, on the CPU.

A tiny port v2 run (the JAX package's initial weights, a random PCA and a
fidelity curve) and a prior run beside it (the layout `train_prior`
writes: `prior_config.json` and a checkpoint of the prior and its Adam).
The artifact is exported at fidelity 0.99 (4 latent dimensions) and the
prior models 2 of them, so a sample is padded with normals.

  * the manifest's `prior` is the prior run's `prior_config.json`, as the
    JAX exporter writes it (rave_tpu/export/export.py:95-114); the
    artifact holds `prior.json`, `prior.pt` and `prior_step.pt2`;
  * `prior_step.pt2` (`torch.export`) against the eager `PriorStep`, chained
    over 16 steps on the same seeds: next frames and state bit-equal;
  * `sample_prior`: the argmax chain is the prior's own `generate(argmax=True)`
    from a zero frame; a sample is the shift-inverted dithered decode of its
    chain with the dither and padding drawn from its seed, the same seed
    giving the same sample and another seed another one; a sampled chain is
    the one that `PriorStep` calls (the `.pt2`'s eager twin) draw, bit-equal;
  * `generate --prior_seconds` writes `prior_sample_<i>.wav` of
    `round(seconds * sr / decimation)` frames, equal to decoding
    `sample_prior` with seed `seed + i`; without a prior, generation from
    it raises, as the JAX package's does.
"""
import io
import json
from contextlib import redirect_stderr, redirect_stdout

import jax
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from rave_tpu import config as jax_config
from rave_tpu.factory import build_rave as jax_build_rave
from rave_tpu.prior.model import Prior as JaxPrior
from rave_tpu_torch import cli, config
from rave_tpu_torch.export import artifact
from rave_tpu_torch.export.artifact import ExportedRAVE
from rave_tpu_torch.export.generate import generate
from rave_tpu_torch.prior.core import DiagonalShift, QuantizedNormal
from rave_tpu_torch.prior.model import Prior, generate as prior_generate
from rave_tpu_torch.train.state import create_train_state
from rave_tpu_torch.utils.checkpoint import save_checkpoint, save_prior_checkpoint
from rave_tpu_torch.utils.convert import from_jax_prior, from_jax_variables
from rave_tpu_torch.utils.rng import normal_from_seed, uniform_from_seed

TINY_V2 = ["capacity=2", "latent_size=4", "ratios=[4,4,2]", "dilations=[[1],[1],[1]]",
           "discriminator.capacity=2", "distance.scales=[512,256]"]
FIDELITY = [0.2, 0.4, 0.97, 1.0]
PRIOR = dict(latent_size=2, resolution=8, res_size=16, skp_size=8, kernel_size=3,
             cycle_size=4, n_layers=3)
N_STEPS = 16


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run_cli(args):
    out, err = io.StringIO(), io.StringIO()
    with redirect_stdout(out), redirect_stderr(err):
        code = cli.main([str(a) for a in args])
    return code, out.getvalue(), err.getvalue()


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """A port v2 run, a prior run, and `cli export --prior` of both."""
    root = tmp_path_factory.mktemp("torch_prior_export")
    jcfg = jax_config.compose(["v2"], TINY_V2)
    variables = jax.tree_util.tree_map(np.asarray, dict(jax_build_rave(jcfg, train=False).init(
        {"params": jax.random.key(0), "noise": jax.random.key(1)}, np.zeros((1, 4096, 1)))))
    r = np.random.default_rng(0)
    variables = {"params": variables["params"], "buffers": {
        **variables["buffers"], "fidelity": np.asarray(FIDELITY, np.float32),
        "latent_pca": np.linalg.qr(r.standard_normal((4, 4)))[0].astype(np.float32),
        "latent_mean": (r.standard_normal(4) * 0.1).astype(np.float32)}}
    cfg = config.compose(["v2"], TINY_V2)
    state = create_train_state(cfg, device="cpu")
    from_jax_variables(state.model, variables)
    vae_run = root / "v2_run"
    vae_run.mkdir()
    (vae_run / "config.json").write_text(config.snapshot(cfg))
    save_checkpoint(str(vae_run), state)

    # the prior run: the JAX prior's initial params, checkpointed as train_prior saves them
    jp = JaxPrior(**PRIOR)
    x0 = np.zeros((1, 8, PRIOR["latent_size"] * PRIOR["resolution"]), np.float32)
    prior = Prior(**PRIOR)
    from_jax_prior(prior, jax.tree_util.tree_map(
        np.asarray, jp.init({"params": jax.random.key(2)}, x0)["params"]))
    prior_run = root / "tiny_prior"
    prior_run.mkdir()
    pcfg = dict(vae_run=str(vae_run), **PRIOR, fidelity=0.95)
    (prior_run / "prior_config.json").write_text(json.dumps(pcfg, indent=2))
    save_prior_checkpoint(str(prior_run), 2, prior, torch.optim.Adam(prior.parameters()))

    code, out, err = run_cli(["export", "--device", "cpu", "--run", vae_run, "--prior",
                              prior_run, "--fidelity", 0.99, "--streaming", "--output",
                              root / "art"])
    assert code == 0, err
    path = out.strip().splitlines()[-1].removeprefix("exported: ")
    return {"root": root, "path": path, "pcfg": pcfg, "prior": prior, "vae_run": vae_run}


def test_manifest_and_files(exported):
    art = ExportedRAVE(exported["path"], device="cpu")
    assert art.has_prior and art.latent_size == 4
    assert art.manifest["prior"] == exported["pcfg"]
    assert json.loads((art.path / "prior.json").read_text()) == exported["pcfg"]
    entry = art.manifest["aot"]["prior_step"]
    assert entry["file"] == "prior_step.pt2" and (art.path / entry["file"]).exists()
    assert entry["device"] == "cpu" and entry["n_state"] == len(art.prior_step.slots) == 4
    assert entry["inputs"][-2] == {"shape": [1, 16, 1], "dtype": "float32"}
    assert entry["outputs"][0] == {"shape": [1, 16, 1], "dtype": "float32"}
    assert [leaf.split(".")[-1] for leaf in entry["state_leaves"]] == ["cache"] * 4
    for name, p in art.prior_step.prior.state_dict().items():
        assert torch.equal(p, exported["prior"].state_dict()[name]), name


def test_prior_step_program_bit_equal(exported):
    """`prior_step.pt2` in lockstep with the eager step over N_STEPS steps from a
    zero frame: the sampled frames and the state equal bit for bit."""
    art = ExportedRAVE(exported["path"], device="cpu")
    program = art.load_program("prior")
    x_e = x_p = torch.zeros(1, 16, 1)
    s_e, s_p = art.prior_state(), art.prior_state()
    frames = []
    with torch.no_grad():
        for i in range(N_STEPS):
            seed = torch.tensor(artifact.prior_step_seed(7, i), dtype=torch.int64)
            x_e, s_e = art.prior_step(s_e, x_e, seed)
            x_p, s_p = program(s_p, x_p, seed)
            assert torch.equal(x_e, x_p), i
            assert all(torch.equal(a, b) for a, b in zip(s_e, s_p)), i
            frames.append(x_e)
    codes = torch.cat(frames, -1).reshape(2, 8, N_STEPS).argmax(1)
    assert len(set(map(tuple, codes.T.tolist()))) > 1  # the chain moves


def test_sample_prior_decodes_its_chain(exported):
    art = ExportedRAVE(exported["path"], device="cpu")
    D, R, n = 2, 8, 12
    z = art.sample_prior(n, seed=11, argmax=True)
    assert z.shape == (1, 4, n) and bool(torch.isfinite(z).all())
    # the argmax chain is the prior's own argmax generation from a zero frame
    ys = prior_generate(art.prior_step.prior, torch.zeros(1, D * R, 1), n + D - 1, argmax=True)
    seed = torch.tensor(11, dtype=torch.int64)
    dither = uniform_from_seed(seed, (1, D, n + D - 1), artifact.PRIOR_DITHER_SALT)
    want = DiagonalShift().inverse(QuantizedNormal(R).decode(ys, dither))
    assert torch.equal(z[:, :D], want)
    assert torch.equal(z[:, D:], normal_from_seed(seed, (1, 2, n), artifact.PRIOR_PAD_SALT))
    # sampled: a seed gives one sample, another seed another
    a, b = art.sample_prior(n, seed=3), art.sample_prior(n, seed=3)
    assert torch.equal(a, b) and not torch.equal(a, art.sample_prior(n, seed=4))
    # and its chain is the one that chained `PriorStep` calls draw from the step seeds
    x, state, frames = torch.zeros(1, D * R, 1), art.prior_state(), []
    with torch.no_grad():
        for i in range(n + D - 1):
            step_seed = torch.tensor(artifact.prior_step_seed(3, i), dtype=torch.int64)
            x, state = art.prior_step(state, x, step_seed)
            frames.append(x)
    seed = torch.tensor(3, dtype=torch.int64)
    dither = uniform_from_seed(seed, (1, D, n + D - 1), artifact.PRIOR_DITHER_SALT)
    chained = DiagonalShift().inverse(QuantizedNormal(R).decode(torch.cat(frames, -1), dither))
    assert torch.equal(a[:, :D], chained)
    assert art.decode(a).shape == (1, 1, n * art.cfg.decimation())


def test_generate_prior_seconds(exported):
    root, path = exported["root"], exported["path"]
    code, out, err = run_cli(["generate", "--device", "cpu", "--model", path, "--prior_seconds",
                              0.5, "--prior_samples", 2, "--seed", 3, "--out_path",
                              root / "gen"])
    assert code == 0, err
    art = ExportedRAVE(path, device="cpu", seed=3)
    n_frames = round(0.5 * 44100 / art.cfg.decimation())
    for i in range(2):
        sr, y = wavfile.read(root / "gen" / f"prior_sample_{i}.wav")
        assert sr == 44100 and y.shape == (n_frames * art.cfg.decimation(),)
        want = art.decode(art.sample_prior(n_frames, seed=3 + i))[0, 0].clamp(-1, 1).numpy()
        assert np.abs(y / 32767 - want).max() <= 1 / 32767 + 1e-7
    assert "prior_sample_1.wav" in out


def test_generation_without_a_prior_raises(exported):
    """An artifact exported without `--prior` has none, and generating from it
    raises (rave_tpu/export/generate.py:103-107), through the CLI too."""
    root = exported["root"]
    code, out, _ = run_cli(["export", "--device", "cpu", "--run", exported["vae_run"],
                            "--output", root / "plain"])
    assert code == 0
    path = out.strip().splitlines()[-1].removeprefix("exported: ")
    art = ExportedRAVE(path, device="cpu")
    assert not art.has_prior and art.manifest["prior"] is None
    assert "prior_step" not in art.manifest["aot"]
    with pytest.raises(RuntimeError, match="without a prior"):
        art.sample_prior(4)
    with pytest.raises(RuntimeError, match="export --prior"):
        generate(path, [], prior_seconds=1.0, device="cpu")
    with pytest.raises(SystemExit):  # neither --input nor --prior_seconds
        run_cli(["generate", "--device", "cpu", "--model", path])
