"""Export and the artifact: rave_tpu_torch's against rave_tpu's, on the CPU.

One tiny v2 run is made in each package from the same weights (the JAX
train state's generator, bridged by `from_jax_variables`) and the same
analysis buffers (a fidelity curve that truncates 8 latent dimensions to
4, a PCA rotation and a mean). Both are exported stereo with a 2x target
rate, so the artifacts resample at both ends and stream two rows. Checks:

  * the manifests: equal key for key but `format` and `aot`; `config`
    holds the port's fields, each equal to the JAX package's;
  * the latent codecs and `ExportedRAVE` offline encode / decode / forward
    and 4 streaming forward blocks, with the JAX artifact's draws injected
    (the test replays its key chain: two splits per call, the second key
    draws): 1e-5 for the codecs, 1e-4 for the model (the serving path's
    tolerance since the port began);
  * the port's `.pt2` step programs, loaded with `torch.export.load`,
    against its eager steps on the same seeds: bit-equal outputs and state;
  * the seed sampler against a numpy copy of its hash, its determinism,
    and that a program draws from its seed input (no draw baked in);
  * the refusals (a prior the artifact does not hold or a prior run that
    does not exist, a program on the wrong device), and that each
    other latent family has its codec (tests/test_torch_families.py holds
    them to the JAX package).
"""
import json
import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu import config as jax_config
from rave_tpu.export.artifact import ExportedRAVE as JaxExportedRAVE
from rave_tpu.export.artifact import post_process_latent as jax_post
from rave_tpu.export.artifact import pre_process_latent as jax_pre
from rave_tpu.export.export import export_model as jax_export_model
from rave_tpu.factory import build_discriminator as jax_build_discriminator
from rave_tpu.factory import build_rave as jax_build_rave
from rave_tpu.train.state import create_train_state as jax_create_train_state
from rave_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from rave_tpu_torch import config
from rave_tpu_torch.export import artifact
from rave_tpu_torch.export.artifact import ExportedRAVE
from rave_tpu_torch.export.export import export_model
from rave_tpu_torch.export.generate import generate
from rave_tpu_torch.factory import build_rave
from rave_tpu_torch.train.state import create_train_state
from rave_tpu_torch.utils import rng
from rave_tpu_torch.utils.checkpoint import read_generator, save_checkpoint
from rave_tpu_torch.utils.convert import from_jax_variables

TINY = ["capacity=2", "discriminator.capacity=2", "latent_size=8", "ratios=[4,4,2]",
        "dilations=[[1],[1],[1]]", "train.ema=0.99"]
FIDELITY = [0.3, 0.6, 0.8, 0.9, 0.96, 0.98, 0.99, 1.0]  # 0.95 -> 4 dims of 8; 0.97 -> 8
CODEC_TOL, MODEL_TOL = 1e-5, 1e-4
N_BLOCKS = 4


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def to_port(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 2, 1)))


def from_port(y):
    return y.detach().cpu().numpy().transpose(0, 2, 1)


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A JAX run and a port run of the same tiny v2 generator."""
    root = tmp_path_factory.mktemp("torch_export")
    jcfg = jax_config.compose(["v2"], TINY)
    jcfg.data.n_signal = 8192
    jmodel = jax_build_rave(jcfg, train=True)
    state = jax_create_train_state(jcfg, jmodel, jax_build_discriminator(jcfg),
                                   jax.random.key(0), n_signal=8192)
    D = jcfg.latent_size
    r = np.random.default_rng(0)
    buffers = dict(state.model_state["buffers"])
    buffers["fidelity"] = jnp.asarray(FIDELITY, jnp.float32)
    buffers["latent_pca"] = jnp.asarray(np.linalg.qr(r.standard_normal((D, D)))[0], jnp.float32)
    buffers["latent_mean"] = jnp.asarray(r.standard_normal(D) * 0.1, jnp.float32)
    state = state.replace(model_state={**state.model_state, "buffers": buffers})
    jax_run = root / "jax_run"
    jax_run.mkdir()
    (jax_run / "config.json").write_text(jax_config.snapshot(jcfg))
    jax_save_checkpoint(str(jax_run), 1, jax.device_get(state))

    cfg = config.compose(["v2"], TINY)
    cfg.data.n_signal = 8192
    pstate = create_train_state(cfg, device="cpu")
    from_jax_variables(pstate.model, {"params": state.gen_params, "buffers": buffers})
    pstate.ema = {n: p.detach() * 0.5 for n, p in pstate.model.named_parameters()}
    port_run = root / "port_run"
    port_run.mkdir()
    (port_run / "config.json").write_text(config.snapshot(cfg))
    save_checkpoint(str(port_run), pstate)
    return {"root": root, "jax": jax_run, "port": port_run, "cfg": cfg, "jcfg": jcfg}


@pytest.fixture(scope="module")
def stereo(runs):
    """Both packages' stereo artifacts at twice the model's rate."""
    sr = 2 * runs["cfg"].sampling_rate
    kw = dict(streaming=True, stereo=True, target_sr=sr)
    jax_path = jax_export_model(run=str(runs["jax"]), output=str(runs["root"] / "jax_art"), **kw)
    port_path = export_model(run=str(runs["port"]), output=str(runs["root"] / "port_art"),
                             device="cpu", **kw)
    return JaxExportedRAVE(jax_path), ExportedRAVE(port_path, device="cpu")


@pytest.fixture(scope="module")
def mono(runs):
    """The port's mono artifact at the model's rate (its step programs)."""
    return export_model(run=str(runs["port"]), streaming=True, fidelity=0.97,
                        output=str(runs["root"] / "mono"), device="cpu")


def test_manifest_matches_jax(stereo):
    theirs, mine = stereo[0].manifest, stereo[1].manifest
    assert (mine["format"], theirs["format"]) == ("rtpu-torch-v1", "rtpu-v1")
    assert set(mine) == set(theirs)
    for key in set(mine) - {"format", "aot", "config"}:
        assert mine[key] == theirs[key], key
    assert mine["latent_size"] == 4 and mine["stream_batch"] == 2
    assert mine["target_sampling_rate"] == 2 * mine["sampling_rate"]

    def fields(port, ref, path="config"):
        for k, v in port.items():
            if isinstance(v, dict) and isinstance(ref[k], dict):
                fields(v, ref[k], f"{path}.{k}")
            else:
                want = ref[k]
                assert json.loads(json.dumps(v)) == json.loads(json.dumps(want)), f"{path}.{k}"

    fields(mine["config"], theirs["config"])
    assert set(mine["aot"]) == set(theirs["aot"]) == {"encode_step", "decode_step",
                                                      "forward_step"}
    for name, entry in mine["aot"].items():
        their = theirs["aot"][name]
        assert entry["file"] == f"{name}.pt2" and entry["device"] == "cpu"
        assert entry["n_state"] == their["n_state"] == len(entry["state_leaves"])
        assert entry["state_inputs"] == list(range(entry["n_state"]))
        assert entry["state_outputs"] == list(range(1, 1 + entry["n_state"]))
        # the port's x and y are [B, C, T], the JAX package's [B, T, C]
        x_mine, x_theirs = entry["inputs"][-2]["shape"], their["inputs"][-2]["shape"]
        assert x_mine == [x_theirs[0], x_theirs[2], x_theirs[1]]
        assert entry["outputs"][0]["shape"] == [their["outputs"][0]["shape"][i]
                                                for i in (0, 2, 1)]


def _peek_draws(art, n_calls):
    """The keys that the JAX artifact's next `n_calls` `_apply` calls draw
    their latent noise from: each takes two splits and draws from the second."""
    k, keys = art._rng, []
    for _ in range(n_calls):
        k, _ = jax.random.split(k)
        k, r2 = jax.random.split(k)
        keys.append(r2)
    return keys


def test_latent_codecs_match_jax(stereo):
    theirs, mine = stereo
    key = jax.random.key(7)
    B, T, D, L = 2, 5, 8, mine.latent_size
    z = np.random.default_rng(1).standard_normal((B, T, 2 * D)).astype(np.float32)
    want = jax_post(theirs.cfg, theirs.model, L, theirs.variables, jnp.asarray(z), key)
    eps = jax.random.normal(key, (B, T, D), jnp.float32)
    got = artifact.post_process_latent(mine.cfg, mine.encode_side, L, to_port(z),
                                       eps=to_port(eps))
    assert rel_err(from_port(got), want) <= CODEC_TOL

    zl = np.asarray(want)[..., :4]  # 4 of 8: the rest is noise
    want = jax_pre(theirs.cfg, theirs.model, D, theirs.variables, jnp.asarray(zl), key)
    noise = jax.random.normal(key, (B, T, D - 4), jnp.float32)
    got = artifact.pre_process_latent(mine.cfg, mine.decode_side, D, to_port(zl),
                                      noise=to_port(noise))
    assert rel_err(from_port(got), want) <= CODEC_TOL


def test_artifact_matches_jax(stereo):
    """Offline encode, decode and forward, and 4 streaming forward blocks."""
    theirs, mine = stereo
    D, L = mine.full_latent_size, mine.latent_size
    decim = mine.cfg.decimation()
    block = mine.block_size  # at the target rate: 2 x the model's
    assert block == theirs.block_size == 2 * mine.manifest["block_size"]
    x = (np.random.default_rng(2).standard_normal((2, N_BLOCKS * block, 1)) * 0.3)
    x = x.astype(np.float32)
    T_lat = x.shape[1] // mine.resampler.ratio // decim

    (k,) = _peek_draws(theirs, 1)
    eps = jax.random.normal(k, (2, T_lat, D), jnp.float32)
    z_want = np.asarray(theirs.encode(jnp.asarray(x)))
    z_got = mine.encode(to_port(x), eps=to_port(eps))
    assert z_got.shape == (2, L, T_lat)
    assert rel_err(from_port(z_got), z_want) <= MODEL_TOL

    (k,) = _peek_draws(theirs, 1)
    noise = jax.random.normal(k, (2, T_lat, D - L), jnp.float32)
    y_want = np.asarray(theirs.decode(jnp.asarray(z_want)))
    y_got = mine.decode(to_port(z_want), noise=to_port(noise))
    assert y_got.shape == (2, 1, x.shape[1])
    assert rel_err(from_port(y_got), y_want) <= MODEL_TOL

    k1, k2 = _peek_draws(theirs, 2)
    draws = (jax.random.normal(k1, (2, T_lat, D)), jax.random.normal(k2, (2, T_lat, D - L)))
    y_want = np.asarray(theirs.forward(jnp.asarray(x)))
    y_got = mine.forward(to_port(x), eps=to_port(draws[0]), noise=to_port(draws[1]))
    assert rel_err(from_port(y_got), y_want) <= MODEL_TOL

    theirs.reset_stream()
    mine.reset_stream()
    frames = block // mine.resampler.ratio // decim
    want, got = [], []
    for i in range(N_BLOCKS):
        xb = x[:, i * block:(i + 1) * block]
        k1, k2 = _peek_draws(theirs, 2)
        eps = to_port(jax.random.normal(k1, (2, frames, D)))
        noise = to_port(jax.random.normal(k2, (2, frames, D - L)))
        want.append(np.asarray(theirs.forward(jnp.asarray(xb), streaming=True)))
        got.append(from_port(mine.forward(to_port(xb), streaming=True, eps=eps, noise=noise)))
    want, got = np.concatenate(want, 1), np.concatenate(got, 1)
    assert got.shape == x.shape and np.isfinite(got).all()
    assert rel_err(got, want) <= MODEL_TOL


@pytest.mark.parametrize("method", ["encode", "decode", "forward"])
def test_step_programs_match_eager(mono, method):
    """The `.pt2` programs against the eager steps, 4 blocks in lockstep
    from the zero state, on the seeds of the artifact's chain: bit-equal."""
    art = ExportedRAVE(mono, device="cpu", seed=5)
    program = art.load_program(method)
    entry = art.manifest["aot"][f"{method}_step"]
    state = [torch.zeros(s["shape"]) for s in entry["inputs"][: entry["n_state"]]]
    x_shape = entry["inputs"][entry["n_state"]]["shape"]
    assert x_shape[-1] == (art.block_size if method != "decode"
                           else art.block_size // art.cfg.decimation())
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (N_BLOCKS, *x_shape)).astype(np.float32) * 0.3)
    for i in range(N_BLOCKS):
        seed = art.next_seed()
        y_eager = getattr(art, method)(x[i], streaming=True, seed=seed)
        y_prog, state = program(state, x[i], torch.tensor(seed))
        assert y_eager.shape == tuple(entry["outputs"][0]["shape"])
        assert torch.equal(y_prog, y_eager), (i, float((y_prog - y_eager).abs().max()))
        assert len(state) == len(art.state) == entry["n_state"]
        assert all(torch.equal(a, b) for a, b in zip(state, art.state)), i


def test_seeds_drive_the_draws(mono):
    """Two seeds give two latents, one seed the same latents twice, in the
    eager artifact and in its exported program: nothing is baked in."""
    art = ExportedRAVE(mono, device="cpu")
    program = art.load_program("encode")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (1, 1, art.block_size)).astype(np.float32))
    zero = [torch.zeros_like(s) for s in art.state]
    runs = {s: program(zero, x, torch.tensor(s))[0] for s in (1, 2)}
    assert torch.equal(runs[1], program(zero, x, torch.tensor(1))[0])
    assert not torch.allclose(runs[1], runs[2])
    assert torch.equal(art.encode(x, seed=1), art.encode(x, seed=1))
    assert not torch.allclose(art.encode(x, seed=1), art.encode(x, seed=2))
    a, b = art.encode(x), art.encode(x)  # two seeds of the chain
    assert not torch.allclose(a, b)
    assert torch.equal(ExportedRAVE(mono, device="cpu").encode(x), a)  # the chain restarts


def _numpy_bits(seed, salt, counter):
    """The sampler's hash in numpy uint64, as a plain copy."""
    m = np.uint64(0xFFFFFFFF)

    def h(x):
        x = x & m
        x ^= x >> np.uint64(16)
        x = (x * np.uint64(0x7FEB352D)) & m
        x ^= x >> np.uint64(15)
        x = (x * np.uint64(0x846CA68B)) & m
        return x ^ (x >> np.uint64(16))

    key = h(np.uint64(seed) ^ h(np.uint64(salt)))
    return h(h((counter + key) & m) ^ key)


@pytest.mark.parametrize("seed", [0, 1, 0xFFFFFFFF, 0x9E3779B9])
def test_normal_from_seed_matches_numpy_copy(seed):
    n, salt = 5000, 3
    i = np.arange(n, dtype=np.uint64)
    b1 = _numpy_bits(seed, salt, 2 * i)
    b2 = _numpy_bits(seed, salt, 2 * i + np.uint64(1))
    tb = rng.uniform_bits(torch.tensor(seed, dtype=torch.int64), salt,
                          2 * torch.arange(n, dtype=torch.int64))
    np.testing.assert_array_equal(tb.numpy().astype(np.uint64), b1)
    assert rng.hash32(12345) == _hash_int(12345)
    u1 = ((b1 >> np.uint64(8)).astype(np.float64) + 0.5) / 2.0**24
    u2 = (b2 >> np.uint64(8)).astype(np.float64) / 2.0**24
    want = (np.sqrt(-2 * np.log(u1)) * np.cos(2 * np.pi * u2)).astype(np.float32)
    got = rng.normal_from_seed(torch.tensor(seed, dtype=torch.int64), (50, 100), salt)
    assert got.dtype == torch.float32 and got.shape == (50, 100)
    np.testing.assert_allclose(got.numpy().ravel(), want, rtol=0, atol=1e-6)
    assert torch.equal(got, rng.normal_from_seed(seed, (50, 100), salt))
    assert not torch.allclose(got, rng.normal_from_seed(seed, (50, 100), salt + 1))
    assert abs(float(got.mean())) < 0.05 and abs(float(got.std()) - 1) < 0.05


def _hash_int(x):
    m = 0xFFFFFFFF
    x ^= x >> 16
    x = (x * 0x7FEB352D) & m
    x ^= x >> 15
    x = (x * 0x846CA68B) & m
    return x ^ (x >> 16)


def test_ema_weights_and_refusals(runs, mono, tmp_path):
    _, weights, _, _ = read_generator(str(runs["port"]))
    _, ema, _, _ = read_generator(str(runs["port"]), use_ema=True)
    name = "encoder.encoder.net.layers.0.v"
    assert torch.equal(ema[name], weights[name] * 0.5)
    assert torch.equal(ema["latent_pca"], weights["latent_pca"])

    art = ExportedRAVE(mono, device="cpu")
    assert art.manifest["latent_size"] == 8 and not art.has_prior
    for setter in (art.set_learn_target, art.set_learn_source):
        setter(True)  # v2 has no AdaIN: nothing to set, as in the JAX artifact
    art.reset_target()
    art.reset_source()
    with pytest.raises(RuntimeError, match="without a prior"):
        art.sample_prior(4)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        export_model(run=str(runs["port"]), prior=str(tmp_path / "no_prior"), device="cpu")
    with pytest.raises(RuntimeError, match="without a prior"):
        generate(mono, [], prior_seconds=1.0, device="cpu")
    for family in ("discrete", "spherical", "wasserstein"):  # each family has its codec
        cfg = config.compose(["v2"], TINY + [f'latent.family="{family}"',
                                             "latent.noise_augmentation=2"])
        side = artifact.DecodeSide(build_rave(cfg, device="cpu"), cfg, 4)
        width = {"discrete": cfg.latent.num_quantizers, "spherical": cfg.latent_size - 1,
                 "wasserstein": cfg.latent_size}[family]
        z = torch.zeros(1, width, 5)
        x = artifact.pre_process_latent(cfg, side, cfg.augmented_latent_size(), z, seed=1)
        assert x.shape == (1, cfg.augmented_latent_size(), 5), family
    with pytest.raises(ValueError, match="multiple"):
        art.forward(torch.zeros(1, 1, art.block_size + 1), streaming=True)
    art.manifest["aot"]["forward_step"]["device"] = "cuda:0"
    with pytest.raises(ValueError, match="exported on cuda"):
        art.load_program("forward")
    wrong = tmp_path / "jax.rtpu"
    shutil.copytree(mono, wrong)
    manifest = json.loads((wrong / "manifest.json").read_text())
    (wrong / "manifest.json").write_text(json.dumps({**manifest, "format": "rtpu-v1"}))
    with pytest.raises(ValueError, match="rtpu-v1"):
        ExportedRAVE(str(wrong), device="cpu")
    assert math.isclose(art.manifest["latent_rate_hz"], 44100 / 512)
