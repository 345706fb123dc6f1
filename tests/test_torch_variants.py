"""The v2 variants: rave_tpu_torch against rave_tpu on the CPU.

The noise synth (`noise`, `v2_small`), raw-waveform output (`v2_nopqmf`,
`v2_nopqmf_small`) and mel input (`v2_with_augs`, `hybrid` with its 2-layer
GRU) at tiny widths (TINY). Weights cross from the JAX package through
`from_jax_variables`, which is strict.

The JAX noise synth draws its uniforms inside the module
(`jax.random.uniform(self.make_rng("noise"), ...)`). The test wraps
`jax.random.uniform` (`record_uniforms`): each 4-D draw is recorded, from
inside `jit` too, by a debug callback, and the port is handed the same
numbers (`LatentDraws.uniform`, `uniform=`). Nothing in rave_tpu changes.

Tolerances, relative to the reference's max:
  * the DSP helpers (the crop branch of `amp_to_impulse_response`
    included) and the GRU, offline and step: 1e-5 (DSP_TOL);
  * `MelAnalysis` and `NoiseGeneratorV2`, offline and streaming, and
    `RAVE` encode / decode / streaming for all six presets: 1e-4
    (MODEL_TOL, the serving path's tolerance since the port began); a
    centered stream against the port's own offline output, past the delay:
    1e-3, as tests/test_torch_rave.py;
  * one step of each program for `v2_small`, `v2_nopqmf` and `hybrid`:
    every loss 1e-4 (LOSS_TOL); every gradient leaf against JAX's, 5e-3 in
    the pre-warmup step and 1e-3 in the adversarial and critic steps
    (GRAD_TOL, tests/test_torch_train.py's rule and reason), a critic step's
    against the JAX critic step run on the port's fake signal, the fake
    within 1e-5 of JAX's (FAKE_TOL; tests/test_torch_v3.py's rule: the
    critic's gradient is piecewise in its input); the receptive field
    exactly;
  * the artifacts of those three: the manifest equal to JAX's but `format`
    and `aot`, the `.pt2` step programs bit-equal to the eager steps, and
    the outputs within 1e-4 of the JAX artifact's on its draws.
"""
import contextlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from rave_tpu import config as jax_config
from rave_tpu.export.artifact import ExportedRAVE as JaxExportedRAVE
from rave_tpu.export.export import export_model as jax_export_model
from rave_tpu.factory import build_discriminator as jax_build_discriminator
from rave_tpu.factory import build_rave as jax_build_rave
from rave_tpu.models import blocks as jax_blocks
from rave_tpu.models.rave import MelAnalysis as JaxMelAnalysis
from rave_tpu.nn.gru import GRU as JaxGRU
from rave_tpu.ops import dsp as jax_dsp
from rave_tpu.train import analysis as jax_analysis
from rave_tpu.train import state as jax_state
from rave_tpu.train import steps as jax_steps
from rave_tpu.train.state import create_train_state as jax_create_train_state
from rave_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from rave_tpu_torch import config
from rave_tpu_torch.export.artifact import ExportedRAVE
from rave_tpu_torch.export.export import export_model
from rave_tpu_torch.factory import build_rave
from rave_tpu_torch.models.blocks import LatentDraws, NoiseGeneratorV2
from rave_tpu_torch.models.rave import MelAnalysis
from rave_tpu_torch.nn.gru import GRU
from rave_tpu_torch.nn.streaming import init_stream_state
from rave_tpu_torch.ops import dsp
from rave_tpu_torch.train.analysis import receptive_field
from rave_tpu_torch.train.state import create_train_state
from rave_tpu_torch.train.steps import autoencode, build_train_steps, draw_noise
from rave_tpu_torch.utils.checkpoint import save_checkpoint
from rave_tpu_torch.utils.convert import convert_tree, from_jax_variables

DSP_TOL, MODEL_TOL, STREAM_TOL, LOSS_TOL, FAKE_TOL = 1e-5, 1e-4, 1e-3, 1e-4, 1e-5
GRAD_TOL = {False: 5e-3, True: 1e-3}  # by `warmed` (tests/test_torch_train.py)
NOISE = ["decoder.noise_hidden=4"]
TINY = {
    "v2_small": ["capacity=2", "latent_size=4", "ratios=[4,2]", "dilations=[[1],[1]]"] + NOISE,
    "noise": ["capacity=2", "latent_size=4", "ratios=[4,4,2]", "dilations=[[1],[1],[1]]"]
    + NOISE,
    "v2_nopqmf": ["capacity=2", "latent_size=4", "encoder.ratios=[4,2]", "decoder.ratios=[16,8]",
                  "dilations=[[1],[1]]"],
    "v2_nopqmf_small": ["capacity=2", "latent_size=4", "encoder.ratios=[4,2]",
                        "decoder.ratios=[16,8]", "dilations=[[1],[1]]"],
    "hybrid": ["capacity=2", "latent_size=4", "n_mels=16", "mel_n_fft=512", "mel_hop=128",
               "encoder.ratios=[4]", "ratios=[4,4,2]", "dilations=[[1],[1],[1]]"],
    "v2_with_augs": ["capacity=2", "latent_size=4", "n_mels=16", "mel_n_fft=512", "mel_hop=128",
                     "encoder.ratios=[4]", "ratios=[4,4,2]", "dilations=[[1],[1],[1]]"],
}
NAMES = {"noise": ["v2", "noise"]}
TRAIN = ["discriminator.capacity=2", "distance.scales=[512,256]", "train.phase_1_duration=4",
         "train.update_discriminator_every=2", "train.beta_warmup_len=8"]
STEP_PRESETS = ["v2_small", "v2_nopqmf", "hybrid"]
PHASES = [("gen", 1, False, 11), ("gen", 5, True, 12), ("dis", 6, True, 13)]
CROP = (3, 2)
N_SIGNAL = 8192
N_BLOCKS = 4


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() or 1e-3))


def to_port(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 2, 1)))


def from_port(y):
    return y.detach().cpu().numpy().transpose(0, 2, 1)


def preset(name, extra=()):
    names, overrides = NAMES.get(name, [name]), TINY[name] + list(extra)
    return config.compose(names, overrides), jax_config.compose(names, overrides)


@contextlib.contextmanager
def record_uniforms():
    """Wrap `jax.random.uniform`: every 4-D draw (the noise synth's) is
    appended to the yielded list as numpy when it is computed (a debug
    callback, so under `jit` too)."""
    real, drawn = jax.random.uniform, []

    def wrapped(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        u = real(key, shape, dtype, minval, maxval)
        if len(tuple(shape)) == 4:
            jax.debug.callback(lambda v: drawn.append(np.asarray(v)), u)
        return u

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", wrapped)
        yield drawn


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------------
# modules
# --------------------------------------------------------------------------


@pytest.mark.parametrize("bins,target", [(5, 8), (32, 8), (9, 16)],
                         ids=["pad", "crop-v2_small", "pad-even"])
def test_dsp_helpers_match_jax(bins, target):
    amp = np.random.default_rng(bins).standard_normal((2, 3, 4, bins)).astype(np.float32)
    want = np.asarray(jax_dsp.mod_sigmoid(jnp.asarray(amp)))
    got = dsp.mod_sigmoid(torch.from_numpy(amp)).numpy()
    assert rel_err(got, want) <= DSP_TOL
    want_ir = np.asarray(jax_dsp.amp_to_impulse_response(jnp.asarray(want), target))
    got_ir = dsp.amp_to_impulse_response(torch.from_numpy(got), target)
    assert got_ir.shape == want_ir.shape == (2, 3, 4, target)
    assert rel_err(got_ir.numpy(), want_ir) <= DSP_TOL
    sig = np.random.default_rng(1).uniform(-1, 1, want_ir.shape).astype(np.float32)
    want_c = np.asarray(jax_dsp.fft_convolve(jnp.asarray(sig), jnp.asarray(want_ir)))
    got_c = dsp.fft_convolve(torch.from_numpy(sig), torch.from_numpy(want_ir)).numpy()
    assert got_c.shape == want_c.shape
    assert rel_err(got_c, want_c) <= DSP_TOL


@pytest.mark.parametrize("layers", [1, 2])
def test_gru_matches_jax(layers):
    H, B, T, chunk = 6, 2, 12, 3
    jgru = JaxGRU(latent_size=H, num_layers=layers, stream_batch=B)
    x = np.random.default_rng(layers).standard_normal((B, T, H)).astype(np.float32)
    variables = jgru.init(jax.random.key(0), jnp.asarray(x))
    gru = GRU(H, layers, stream_batch=B)
    from_jax_variables(gru, {"params": variables["params"]})
    want = np.asarray(jgru.apply({"params": variables["params"]}, jnp.asarray(x)))
    with torch.no_grad():
        got = from_port(gru(to_port(x)))
    assert rel_err(got, want) <= DSP_TOL

    v, want_s = {**variables, "cache": jax.tree_util.tree_map(jnp.zeros_like, variables["cache"])}, []
    for i in range(0, T, chunk):
        y, upd = jgru.apply(v, jnp.asarray(x[:, i:i + chunk]), method="step", mutable=["cache"])
        v = {**v, **upd}
        want_s.append(np.asarray(y))
    init_stream_state(gru, B)
    with torch.no_grad():
        got_s = [from_port(gru.step(to_port(x[:, i:i + chunk]))) for i in range(0, T, chunk)]
    assert rel_err(np.concatenate(got_s, 1), np.concatenate(want_s, 1)) <= DSP_TOL
    assert rel_err(np.concatenate(got_s, 1), want) <= DSP_TOL  # causal: the stream is offline
    h = np.asarray(v["cache"]["h"])  # [L, B, H]
    assert rel_err(gru.h.permute(2, 0, 1).numpy(), h) <= DSP_TOL


@pytest.mark.parametrize("n_channels", [1, 2])
def test_mel_analysis_matches_jax(n_channels):
    sr, n_fft, hop, n_mels, B = 44100, 512, 128, 16, 2
    jmel = JaxMelAnalysis(sampling_rate=sr, n_fft=n_fft, hop=hop, n_mels=n_mels,
                          n_channels=n_channels, stream_batch=B)
    mel = MelAnalysis(sr, n_fft, hop, n_mels, n_channels, stream_batch=B)
    assert mel.delay == jmel.delay == 1
    x = (np.random.default_rng(0).standard_normal((B, 16 * hop, n_channels)) * 0.3)
    x = x.astype(np.float32)
    variables = jmel.init(jax.random.key(0), jnp.asarray(x))
    want = np.asarray(jmel.apply(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = from_port(mel(to_port(x)))
    assert got.shape == want.shape == (B, 16, n_channels * n_mels)
    assert rel_err(got, want) <= MODEL_TOL

    chunk, v, want_s = 2 * hop, dict(variables), []
    for i in range(0, x.shape[1], chunk):
        y, upd = jmel.apply(v, jnp.asarray(x[:, i:i + chunk]), method="step", mutable=["cache"])
        v = {**v, **upd}
        want_s.append(np.asarray(y))
    init_stream_state(mel, B)
    with torch.no_grad():
        got_s = np.concatenate([from_port(mel.step(to_port(x[:, i:i + chunk])))
                                for i in range(0, x.shape[1], chunk)], 1)
    want_s = np.concatenate(want_s, 1)
    assert rel_err(got_s, want_s) <= MODEL_TOL
    # the stream lags the centred frames by `delay` frames; its first
    # (n_fft - hop) / hop frames read the zero cache, offline's edges the reflection
    k = (n_fft - hop) // hop
    assert rel_err(got_s[:, k:], got[:, k - mel.delay:got.shape[1] - mel.delay]) <= MODEL_TOL


@pytest.mark.parametrize("bands,n_channels", [(5, 1), (32, 2)], ids=["pad", "crop-stereo"])
def test_noise_generator_matches_jax(bands, n_channels):
    C, hidden, data, ratios, B, T, in_delay = 4, 3, 16, (2, 2, 2), 2, 64, 5
    kw = dict(in_size=C, hidden_size=hidden, data_size=data, ratios=ratios, noise_bands=bands,
              n_channels=n_channels, in_delay=in_delay, stream_batch=B)
    jng = jax_blocks.NoiseGeneratorV2(**kw)
    ng = NoiseGeneratorV2(C, hidden, data, ratios, bands, n_channels, in_delay=in_delay,
                          stream_batch=B)
    assert ng.delay == jng.delay == jax_blocks.noise_generator_v2_delay(in_delay, ratios)
    x = np.random.default_rng(bands).standard_normal((B, T, C)).astype(np.float32)
    rngs = {"params": jax.random.key(0), "noise": jax.random.key(1)}
    variables = jng.init(rngs, jnp.asarray(x))
    from_jax_variables(ng, {"params": variables["params"]})
    with record_uniforms() as drawn:
        want = np.asarray(jng.apply({"params": variables["params"]}, jnp.asarray(x),
                                    rngs={"noise": jax.random.key(2)}))
    (u,) = drawn
    assert u.shape == (B, T // 8, data * n_channels, 8)
    with torch.no_grad():
        got = from_port(ng(to_port(x), torch.from_numpy(u)))
    assert got.shape == want.shape == (B, T, data * n_channels)
    assert rel_err(got, want) <= MODEL_TOL

    chunk = 16
    cache = jax.tree_util.tree_map(jnp.zeros_like, jng.init(rngs, jnp.asarray(x[:, :chunk]),
                                                            method="step")["cache"])
    v, want_s, got_s = {"params": variables["params"], "cache": cache}, [], []
    init_stream_state(ng, B)
    for i in range(0, T, chunk):
        with record_uniforms() as drawn:
            y, upd = jng.apply(v, jnp.asarray(x[:, i:i + chunk]), method="step",
                               rngs={"noise": jax.random.key(10 + i)}, mutable=["cache"])
        v = {**v, **upd}
        want_s.append(np.asarray(y))
        with torch.no_grad():
            got_s.append(from_port(ng.step(to_port(x[:, i:i + chunk]),
                                           torch.from_numpy(drawn[0]))))
    assert rel_err(np.concatenate(got_s, 1), np.concatenate(want_s, 1)) <= MODEL_TOL


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------


class Pair:
    """A preset's model in both packages, JAX weights in the port."""

    def __init__(self, name, mode="centered"):
        extra = ['mode="causal"'] if mode == "causal" else []
        self.cfg, self.jcfg = preset(name, extra)
        self.jax_model = jax_build_rave(self.jcfg, train=False, stream_batch=1)
        self.block = self.cfg.block_size()
        x0 = jnp.zeros((1, self.block * 2, 1), jnp.float32)
        variables = jax.jit(self.jax_model.init)(
            {"params": jax.random.key(0), "noise": jax.random.key(1)}, x0)
        self.variables = {k: variables[k] for k in ("params", "buffers")}
        self.model = build_rave(self.cfg, seed=3, device="cpu")
        from_jax_variables(self.model, self.variables)
        self.model.eval()

    def jax_decode(self, latent, method="decode", key=0, cache=None):
        v = {**self.variables, **({"cache": cache} if cache is not None else {})}
        with record_uniforms() as drawn:
            out = self.jax_model.apply(v, jnp.asarray(latent), method=method,
                                       rngs={"noise": jax.random.key(key)},
                                       mutable=["cache"] if cache is not None else False)
        y, upd = out if cache is not None else (out, None)
        return np.asarray(y), (torch.from_numpy(drawn[0]) if drawn else None), upd


@pytest.fixture(scope="module", params=list(TINY))
def pair(request):
    return Pair(request.param)


def test_delays_and_sizes_match(pair):
    cfg, jcfg = pair.cfg, pair.jcfg
    assert cfg.block_size() == jcfg.block_size() and cfg.decimation() == jcfg.decimation()
    assert pair.model.encode_delay == pair.jax_model.encode_delay
    assert pair.model.decoder.delay == pair.jax_model.decoder_delay
    assert pair.model.decode_delay == pair.jax_model.decode_delay
    assert cfg.enc_data_size() == jcfg.enc_data_size()


def test_encode_decode_match(pair):
    cfg, rng = pair.cfg, np.random.default_rng(0)
    x = (rng.standard_normal((2, pair.block * 4, 1)) * 0.3).astype(np.float32)
    z_j = np.asarray(pair.jax_model.apply(pair.variables, jnp.asarray(x), method="encode"))
    with torch.no_grad():
        z_p = from_port(pair.model.encode(to_port(x)))
    assert z_p.shape == z_j.shape == (2, x.shape[1] // cfg.decimation(), 2 * cfg.latent_size)
    assert rel_err(z_p, z_j) <= MODEL_TOL

    latent = rng.standard_normal((2, 12, cfg.latent_size)).astype(np.float32)
    y_j, u, _ = pair.jax_decode(latent)
    assert (u is None) == (not cfg.decoder.use_noise)
    if u is not None:
        assert tuple(u.shape) == cfg.noise_shape(1, 2, 12)
    with torch.no_grad():
        y_p = from_port(pair.model.decode(to_port(latent), u))
    assert y_p.shape == y_j.shape == (2, 12 * cfg.decimation(), 1)
    assert rel_err(y_p, y_j) <= MODEL_TOL


def test_streaming_matches_jax_and_offline(pair):
    """step_encode and step_decode over blocks against the JAX streams (the
    same draws), and the port's stream against its own offline output past
    the delays (the noise synth's offline draws shifted by its delay)."""
    cfg, model, rng = pair.cfg, pair.model, np.random.default_rng(1)
    n_blocks = 8 + 2 * -(-model.encode_delay * cfg.decimation() // pair.block)
    x = (rng.standard_normal((1, pair.block * n_blocks, 1)) * 0.3).astype(np.float32)
    cache0 = jax.tree_util.tree_map(jnp.zeros_like, jax.eval_shape(
        lambda: pair.jax_model.init({"params": jax.random.key(0), "noise": jax.random.key(1)},
                                    jnp.asarray(x[:, :pair.block]), method="step_encode")
    )["cache"])
    cache, want_z = cache0, []
    for i in range(0, x.shape[1], pair.block):
        z, upd = pair.jax_model.apply({**pair.variables, "cache": cache},
                                      jnp.asarray(x[:, i:i + pair.block]), method="step_encode",
                                      mutable=["cache"])
        cache = upd["cache"]
        want_z.append(np.asarray(z))
    init_stream_state(model, 1)
    with torch.no_grad():
        got_z = np.concatenate([from_port(model.step_encode(to_port(x[:, i:i + pair.block])))
                                for i in range(0, x.shape[1], pair.block)], 1)
    assert rel_err(got_z, np.concatenate(want_z, 1)) <= MODEL_TOL
    with torch.no_grad():
        z_off = from_port(model.encode(to_port(x)))
    De = model.encode_delay
    assert rel_err(got_z[:, 2 * De:], z_off[:, De:z_off.shape[1] - De]) <= STREAM_TOL

    frames = pair.block // cfg.decimation()
    n_lat = frames * (4 + 2 * -(-model.decode_delay // pair.block))
    latent = rng.standard_normal((1, n_lat, cfg.latent_size)).astype(np.float32)
    dcache = jax.tree_util.tree_map(jnp.zeros_like, jax.eval_shape(
        lambda: pair.jax_model.init({"params": jax.random.key(0), "noise": jax.random.key(1)},
                                    jnp.asarray(latent[:, :frames]), method="step_decode")
    )["cache"])
    cache, want_y, draws = dcache, [], []
    for j, i in enumerate(range(0, n_lat, frames)):
        y, u, upd = pair.jax_decode(latent[:, i:i + frames], "step_decode", key=20 + j,
                                    cache=cache)
        cache = upd["cache"]
        want_y.append(y)
        draws.append(u)
    init_stream_state(model, 1)
    with torch.no_grad():
        got_y = np.concatenate([from_port(model.step_decode(to_port(latent[:, i:i + frames]), u))
                                for u, i in zip(draws, range(0, n_lat, frames))], 1)
    assert rel_err(got_y, np.concatenate(want_y, 1)) <= MODEL_TOL

    # the port's stream against its own offline decode
    shape = cfg.noise_shape(1, 1, n_lat)
    u_off, u_stream = None, [None] * len(draws)
    if shape is not None:
        noise = model.decoder.synth.branches[1]
        lag = noise.delay // noise.target_size  # noise frames
        u_off = torch.from_numpy(rng.uniform(size=shape).astype(np.float32))
        shifted = torch.cat([torch.zeros_like(u_off[:, :lag]), u_off[:, : shape[1] - lag]], 1)
        u_stream = shifted.split(shape[1] // len(draws), dim=1)
    init_stream_state(model, 1)
    with torch.no_grad():
        y_off = from_port(model.decode(to_port(latent), u_off))
        ys = np.concatenate([from_port(model.step_decode(to_port(latent[:, i:i + frames]), u))
                             for u, i in zip(u_stream, range(0, n_lat, frames))], 1)
    D = model.decode_delay
    assert rel_err(ys[:, 2 * D:], y_off[:, D:y_off.shape[1] - D]) <= STREAM_TOL


def test_forward_takes_the_draws():
    """The noise synth's draws are an input: none refuses, and the model's
    forward is decode(reparametrize(encode)) on `draws`."""
    cfg, _ = preset("v2_small")
    model = build_rave(cfg, device="cpu").eval()
    x = torch.randn(1, 1, 4 * cfg.block_size(), generator=torch.Generator().manual_seed(0))
    draws = draw_noise(cfg, x, torch.Generator().manual_seed(1))
    assert tuple(draws.uniform.shape) == cfg.noise_shape(1, 1, x.shape[-1] // cfg.decimation())
    with torch.no_grad():
        zs, _ = model.reparametrize(model.encode(x), draws)
        with pytest.raises(ValueError, match="uniform draws"):
            model.decode(zs)
        assert torch.equal(model(x, draws), model.decode(zs, draws.uniform))
    # the uniforms come after the other draws: those of v2 stay as they were
    base = draw_noise(config.compose(["v2"], TINY["v2_small"][:4]), x,
                      torch.Generator().manual_seed(1))
    assert torch.equal(base.eps, draws.eps) and base.uniform is None


# --------------------------------------------------------------------------
# the training steps
# --------------------------------------------------------------------------


def grad_stash():
    """An optax transform that updates nothing and keeps the gradient as its state."""
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, grads), grads

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module", params=STEP_PRESETS)
def jax_run(request):
    name = request.param
    cfg, jcfg = preset(name, TRAIN)
    model = jax_build_rave(jcfg, n_channels=1, train=True)
    dis = jax_build_discriminator(jcfg, n_channels=1)
    state = jax_state.create_train_state(jcfg, model, dis, jax.random.key(0), n_signal=N_SIGNAL)
    x = (np.random.default_rng(0).standard_normal((2, N_SIGNAL, 1)) * 0.1).astype(np.float32)
    variables = {"params": state.gen_params, **state.model_state}
    T_lat = N_SIGNAL // jcfg.decimation()

    def eps(rng):
        """The step's eps: reparametrize a zero latent (mean 0, std s) with its rng."""
        z0 = jnp.zeros((2, T_lat, 2 * jcfg.latent_size), jnp.float32)
        zs, _ = model.apply(variables, z0, rngs={"noise": rng},
                            method=lambda m, z: m.reparametrize(z))
        return np.asarray(zs / (jax.nn.softplus(0.0) + 1e-4))

    out, fakes = {}, []
    autoencode = jax_steps._autoencode

    def recording(*args, **kwargs):  # the fake signal of each step, as it is computed
        result = autoencode(*args, **kwargs)
        jax.debug.callback(lambda v: fakes.append(np.asarray(v)), result[0]["y_raw"])
        return result

    with pytest.MonkeyPatch.context() as mp, record_uniforms() as drawn:
        mp.setattr(jax_steps, "make_optimizers", lambda c: (grad_stash(), grad_stash()))
        mp.setattr(jax_steps, "_autoencode", recording)
        steps = jax_steps.build_train_steps(jcfg, model, dis, crop_frames=CROP)
        for which, step, warmed, seed in PHASES:
            s0 = jax.tree_util.tree_map(jnp.array, state.replace(step=jnp.asarray(step, jnp.int32)))
            rng = jax.random.key(seed)
            drawn.clear()
            fakes.clear()
            if which == "gen":
                s1, m = steps["gen"](s0, jnp.asarray(x), rng, warmed=warmed, quantize=False)
                grads = s1.gen_opt
            else:
                s1, m = steps["dis"](s0, jnp.asarray(x), rng, quantize=False)
                grads = s1.dis_opt
            jax.block_until_ready(m)
            out[(which, warmed)] = {
                "metrics": {k: float(v) for k, v in m.items()},
                "grads": jax.tree_util.tree_map(np.asarray, grads),
                "eps": eps(rng),
                "uniform": drawn[-1] if drawn else None,
                "n_uniform": len(drawn),
                "y_raw": fakes[-1],
                "step": int(s1.step),
            }
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    return {"name": name, "cfg": cfg, "jcfg": jcfg, "x": x, "model": model, "dis": dis,
            "state": state,
            "gen_params": as_np(state.gen_params),
            "buffers": as_np(state.model_state["buffers"]),
            "dis_params": as_np(state.dis_params), "phases": out}


@pytest.mark.parametrize("which,step,warmed,seed", PHASES,
                         ids=["gen-prewarmup", "gen-adversarial", "dis"])
def test_step_matches_jax(jax_run, which, step, warmed, seed):
    ref = jax_run["phases"][(which, warmed)]
    cfg = jax_run["cfg"]
    st = create_train_state(cfg, seed=0, device="cpu")
    from_jax_variables(st.model, {"params": jax_run["gen_params"], "buffers": jax_run["buffers"]})
    from_jax_variables(st.discriminator, {"params": jax_run["dis_params"]})
    st.step = step
    uniform = None if ref["uniform"] is None else torch.from_numpy(ref["uniform"])
    assert (uniform is None) == (not cfg.decoder.use_noise)
    if uniform is not None:
        assert ref["n_uniform"] >= 1
        assert tuple(uniform.shape) == cfg.noise_shape(1, 2, N_SIGNAL // cfg.decimation())
    x = to_port(jax_run["x"])
    draws = LatentDraws(eps=to_port(ref["eps"]), uniform=uniform)
    steps = build_train_steps(cfg, CROP)
    if which == "dis":  # the port's fake signal, which its critic step computes
        st.model.train()
        with torch.no_grad():
            fake = from_port(autoencode(st.model, x, draws, True)["y_raw"])
        assert rel_err(fake, ref["y_raw"]) <= FAKE_TOL
    metrics = (steps["gen"](st, x, warmed, draws=draws) if which == "gen"
               else steps["dis"](st, x, draws=draws))
    assert st.step == ref["step"] == step + 1
    assert set(metrics) == set(ref["metrics"])
    for k, want in ref["metrics"].items():
        got = float(metrics[k])
        assert abs(got - want) <= LOSS_TOL * max(abs(want), 1e-2), (k, got, want)
    module = st.model if which == "gen" else st.discriminator
    grads = ref["grads"] if which == "gen" else jax_critic_grads(jax_run, step, seed, fake)
    want = convert_tree(module, grads)
    got = {n: p.grad for n, p in module.named_parameters()}
    assert set(got) == set(want)
    for name, g in got.items():
        assert g is not None, name
        assert rel_err(g.numpy(), want[name]) <= GRAD_TOL[warmed], name


def jax_critic_grads(jax_run, step, seed, y_raw):
    """The JAX critic step's gradients with its fake signal replaced by the
    port's `y_raw` [B, T, 1]: the critic's gradient is piecewise in its input
    (hinge, leaky ReLU), so it is held on the same input (as
    tests/test_torch_v3.py)."""
    autoencode = jax_steps._autoencode

    def with_fake(*args, **kwargs):
        out, new_state = autoencode(*args, **kwargs)
        return {**out, "y_raw": jnp.asarray(y_raw)}, new_state

    state = jax_run["state"].replace(step=jnp.asarray(step, jnp.int32))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_steps, "make_optimizers", lambda c: (grad_stash(), grad_stash()))
        mp.setattr(jax_steps, "_autoencode", with_fake)
        dis_step = jax_steps.build_train_steps(jax_run["jcfg"], jax_run["model"], jax_run["dis"],
                                               crop_frames=CROP)["dis"]
        s1, _ = dis_step(jax.tree_util.tree_map(jnp.array, state), jnp.asarray(jax_run["x"]),
                         jax.random.key(seed), quantize=False)
    return jax.tree_util.tree_map(np.asarray, s1.dis_opt)


def test_receptive_field_matches_jax(jax_run):
    """The probe, on a clone without GRUs (hybrid's), and the loop's crop
    divisor: band frames by n_band under PQMF input, by the channels else."""
    from rave_tpu_torch.train.analysis import crop_dim

    cfg, jcfg = jax_run["cfg"], jax_run["jcfg"]
    rf = receptive_field(cfg, device="cpu")
    assert rf == jax_analysis.receptive_field(jcfg) and rf[0] > 0
    assert crop_dim(cfg, 2) == (2 * cfg.n_band if cfg.input_mode == "pqmf" else 2)


# --------------------------------------------------------------------------
# the artifact
# --------------------------------------------------------------------------


@pytest.fixture(scope="module", params=STEP_PRESETS)
def artifacts(request, tmp_path_factory):
    """Both packages' streaming artifacts of one generator (JAX weights)."""
    name = request.param
    root = tmp_path_factory.mktemp(f"variant_{name}")
    cfg, jcfg = preset(name, TRAIN)
    jcfg.data.n_signal = cfg.data.n_signal = N_SIGNAL
    jmodel = jax_build_rave(jcfg, train=True)
    state = jax_create_train_state(jcfg, jmodel, jax_build_discriminator(jcfg),
                                   jax.random.key(0), n_signal=N_SIGNAL)
    D = jcfg.latent_size
    r = np.random.default_rng(0)
    buffers = dict(state.model_state["buffers"])
    buffers["fidelity"] = jnp.asarray([0.5, 0.8, 0.99, 1.0], jnp.float32)  # 0.95 -> 4 dims
    buffers["latent_pca"] = jnp.asarray(np.linalg.qr(r.standard_normal((D, D)))[0], jnp.float32)
    buffers["latent_mean"] = jnp.asarray(r.standard_normal(D) * 0.1, jnp.float32)
    state = state.replace(model_state={**state.model_state, "buffers": buffers})
    jax_dir, port_dir = root / "jax_run", root / "port_run"
    jax_dir.mkdir()
    (jax_dir / "config.json").write_text(jax_config.snapshot(jcfg))
    jax_save_checkpoint(str(jax_dir), 1, jax.device_get(state))
    pstate = create_train_state(cfg, device="cpu")
    from_jax_variables(pstate.model, {"params": state.gen_params, "buffers": buffers})
    port_dir.mkdir()
    (port_dir / "config.json").write_text(config.snapshot(cfg))
    save_checkpoint(str(port_dir), pstate)
    jax_path = jax_export_model(run=str(jax_dir), streaming=True, output=str(root / "jax_art"))
    port_path = export_model(run=str(port_dir), streaming=True, output=str(root / "port_art"),
                             device="cpu")
    return JaxExportedRAVE(jax_path), port_path


def _next_keys(art, n_calls):
    """The (model, latent) keys of the JAX artifact's next `n_calls` calls."""
    k, keys = art._rng, []
    for _ in range(n_calls):
        k, r1 = jax.random.split(k)
        k, r2 = jax.random.split(k)
        keys.append((r1, r2))
    return keys


def test_artifact_manifest_matches_jax(artifacts):
    theirs, port_path = artifacts
    mine = ExportedRAVE(port_path, device="cpu")
    a, b = mine.manifest, theirs.manifest
    assert set(a) == set(b)
    for key in set(a) - {"format", "aot", "config"}:
        assert json.loads(json.dumps(a[key])) == json.loads(json.dumps(b[key])), key

    def fields(port, ref, path="config"):  # the port's fields, each equal to JAX's
        for k, v in port.items():
            if isinstance(v, dict) and isinstance(ref[k], dict):
                fields(v, ref[k], f"{path}.{k}")
            else:
                assert json.loads(json.dumps(v)) == json.loads(json.dumps(ref[k])), f"{path}.{k}"

    fields(a["config"], b["config"])
    assert a["block_size"] == mine.cfg.block_size()


def test_artifact_matches_jax(artifacts):
    """Offline encode and decode, and streaming forward blocks, on the JAX
    artifact's draws (its latent noise from the keys it will use, the noise
    synth's uniforms recorded as it draws them)."""
    theirs, port_path = artifacts
    mine = ExportedRAVE(port_path, device="cpu")
    D, L, decim, block = mine.full_latent_size, mine.latent_size, mine.cfg.decimation(), \
        mine.block_size
    x = (np.random.default_rng(2).standard_normal((1, N_BLOCKS * block, 1)) * 0.3)
    x = x.astype(np.float32)
    T_lat = x.shape[1] // decim
    ((_, k),) = _next_keys(theirs, 1)
    eps = jax.random.normal(k, (1, T_lat, D), jnp.float32)
    z_want = np.asarray(theirs.encode(jnp.asarray(x)))
    z_got = mine.encode(to_port(x), eps=to_port(eps))
    assert rel_err(from_port(z_got), z_want) <= MODEL_TOL

    ((_, k),) = _next_keys(theirs, 1)
    noise = jax.random.normal(k, (1, T_lat, D - L), jnp.float32)
    with record_uniforms() as drawn:
        y_want = np.asarray(theirs.decode(jnp.asarray(z_want)))
    u = torch.from_numpy(drawn[0]) if drawn else None
    y_got = mine.decode(to_port(z_want), noise=to_port(noise), uniform=u)
    assert y_got.shape == (1, 1, x.shape[1])
    assert rel_err(from_port(y_got), y_want) <= MODEL_TOL

    theirs.reset_stream()
    mine.reset_stream()
    frames = block // decim
    want, got = [], []
    for i in range(N_BLOCKS):
        xb = x[:, i * block:(i + 1) * block]
        (_, k1), (_, k2) = _next_keys(theirs, 2)
        eps = to_port(jax.random.normal(k1, (1, frames, D)))
        noise = to_port(jax.random.normal(k2, (1, frames, D - L)))
        with record_uniforms() as drawn:
            want.append(np.asarray(theirs.forward(jnp.asarray(xb), streaming=True)))
        u = torch.from_numpy(drawn[0]) if drawn else None
        got.append(from_port(mine.forward(to_port(xb), streaming=True, eps=eps, noise=noise,
                                          uniform=u)))
    want, got = np.concatenate(want, 1), np.concatenate(got, 1)
    assert got.shape == x.shape and np.isfinite(got).all()
    assert rel_err(got, want) <= MODEL_TOL


@pytest.mark.parametrize("method", ["encode", "decode", "forward"])
def test_step_programs_match_eager(artifacts, method):
    """The `.pt2` programs against the eager steps from the zero state on the
    artifact's seeds: bit-equal outputs and state (the GRU's hidden state,
    the mel cache and the noise synth's draws from the seed included)."""
    art = ExportedRAVE(artifacts[1], device="cpu", seed=5)
    program = art.load_program(method)
    entry = art.manifest["aot"][f"{method}_step"]
    state = [torch.zeros(s["shape"]) for s in entry["inputs"][: entry["n_state"]]]
    x_shape = entry["inputs"][entry["n_state"]]["shape"]
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, *x_shape)).astype(np.float32) * 0.3)
    for i in range(3):
        seed = art.next_seed()
        y_eager = getattr(art, method)(x[i], streaming=True, seed=seed)
        y_prog, state = program(state, x[i], torch.tensor(seed))
        assert torch.equal(y_prog, y_eager), (i, float((y_prog - y_eager).abs().max()))
        assert all(torch.equal(a, b) for a, b in zip(state, art.state)), i
    if art.cfg.decoder.use_noise and method != "encode":  # the seed drives the noise synth
        zero = [torch.zeros_like(s) for s in art.state]
        a, b = (program(zero, x[0], torch.tensor(s))[0] for s in (1, 2))
        assert not torch.equal(a, b)
