"""The spectral critic and the other distances: rave_tpu_torch against rave_tpu.

The same seeded numpy signals go through the JAX package's distances and
the port's, and the same JAX weights (through `from_jax_variables`) through
both packages' critics; layouts differ (the port is channels-first), so
feature maps are transposed before comparing. Tolerances: 1e-5 relative to
the reference's max for every distance's value and for every feature map
(float32 FFTs and conv stacks summed in other orders), and for the gradient
with respect to the prediction, except where a distance takes the log of
magnitudes (AudioDistanceV1, mel or not, and the instantaneous distance's
log1p and phases): there float32 itself is further off, since
1 / (|S| + eps) amplifies the rounding of near-empty bins, so the port's
gradient is held to the port's float64 gradient instead, no further from it
than twice the JAX package's float32 gradient is (floor 1e-5). Measured at
these sizes: the JAX float32 gradient errs by up to 4.8e-4 (v1, two
channels) and 2.5e-4 (v1 with 16 mels), the instantaneous distance's by up
to 2.6e-5, against the float64 one.

The training steps with these: tests/test_torch_spectral_steps.py.

Where a bin of the prediction's spectrum is exactly zero (a silent
prediction), the instantaneous distance's gradient is NaN in both packages
(`jnp.angle`'s rule, mirrored: ROADMAP C19) and AudioDistanceV1's finite in
both.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.config import compose as jax_compose
from rave_tpu.factory import build_audio_distance as jax_build_audio_distance
from rave_tpu.factory import build_discriminator as jax_build_discriminator
from rave_tpu.models import discriminators as jax_disc
from rave_tpu.ops import distances as jax_dist
from rave_tpu.ops import dsp as jax_dsp
from rave_tpu.ops import stft as jax_stft
from rave_tpu_torch.config import compose
from rave_tpu_torch.factory import build_audio_distance, build_discriminator
from rave_tpu_torch.models import discriminators
from rave_tpu_torch.ops import distances, dsp, stft
from rave_tpu_torch.utils.convert import convert_tree, from_jax_variables

TOL = 1e-5
SR = 44100
SCALES = (512, 256)


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() or 1e-3))


def signal(shape, seed=0, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def to_port(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 2, 1)))


# ---------------------------------------------------------------------------
# distances
# ---------------------------------------------------------------------------

DISTANCES = {
    "v1": lambda m: (m.AudioDistanceV1(MS[m](SCALES, SR))),
    "v1-mel": lambda m: m.AudioDistanceV1(MS[m](SCALES, SR, num_mels=16)),
    "instantaneous": lambda m: m.WeightedInstantaneousSpectralDistance(
        MS[m](SCALES, SR, magnitude=False)),
    "instantaneous-weighted": lambda m: m.WeightedInstantaneousSpectralDistance(
        MS[m](SCALES, SR, magnitude=False), weighted=True),
    **{f"spectral-{mel or 'lin'}-p{power:g}-{norm}": (
        lambda m, mel=mel, power=power, norm=norm: m.SpectralDistance(
            512, SR, norm=(norm,), power=power, mel=mel))
       for mel in (None, 16) for power in (1.0, 2.0) for norm in ("L1", "L2")},
    "waveform-L1": lambda m: m.WaveformDistance("L1"),
    "waveform-L2": lambda m: m.WaveformDistance("L2"),
    "encodec": lambda m: m.EncodecAudioDistance(SCALES, SR),
    "encodec-mel": lambda m: m.EncodecAudioDistance(SCALES, SR, n_mels=(16, 8)),
}
MS = {jax_dist: jax_stft.MultiScaleSTFT, distances: stft.MultiScaleSTFT}


LOG_TERMS = ("v1", "v1-mel", "instantaneous", "instantaneous-weighted")


def total(d):
    return sum(d.values()) if isinstance(d, dict) else d


def both(name, x, y):
    """(JAX value dict, JAX gradient, port value dict, port gradient) of the
    distance between target x and prediction y, the gradients with respect
    to y in the JAX layout."""
    jd, pd = DISTANCES[name](jax_dist), DISTANCES[name](distances)
    want = jd(jnp.asarray(x), jnp.asarray(y))
    g_want = np.asarray(jax.grad(lambda p: total(jd(jnp.asarray(x), p)))(jnp.asarray(y)))
    yp = to_port(y).requires_grad_()
    got = pd(to_port(x), yp)
    total(got).backward()
    return want, g_want, got, yp.grad.numpy().transpose(0, 2, 1)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("name", list(DISTANCES))
def test_distance_and_gradient_match_jax(name, channels):
    x = signal((2, 4096, channels), seed=1)
    y = x + signal((2, 4096, channels), seed=2, scale=0.05)
    want, g_want, got, g_got = both(name, x, y)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert rel_err(float(got[k]), float(want[k])) < TOL, k
    else:
        assert rel_err(float(got), float(want)) < TOL
    if name not in LOG_TERMS:
        assert rel_err(g_got, g_want) < TOL
        return
    yp = to_port(y).double().requires_grad_()
    total(DISTANCES[name](distances)(to_port(x).double(), yp)).backward()
    g64 = yp.grad.numpy().transpose(0, 2, 1)
    assert rel_err(g_got, g64) <= max(2 * rel_err(g_want, g64), TOL), (
        rel_err(g_got, g64), rel_err(g_want, g64))


@pytest.mark.parametrize("name", ["v1", "v1-mel", "instantaneous", "instantaneous-weighted",
                                  "encodec"])
def test_zero_bins_gradients_finite_alike(name):
    """A silent prediction: every bin of its spectrum is exactly zero."""
    x = signal((1, 2048, 1), seed=3)
    for target, pred in ((np.zeros_like(x), x), (x, np.zeros_like(x))):
        _, g_want, _, g_got = both(name, target, pred)
        assert np.isfinite(g_got).all() == np.isfinite(g_want).all()
        assert np.isnan(g_got).sum() == np.isnan(g_want).sum()
    assert name.startswith("instantaneous") or np.isfinite(g_got).all()


def test_multiscale_stft_complex_and_mel_match_jax():
    """`magnitude=False` gives [B*C, bins, frames, 2]; `num_mels` projects the
    complex spectrum before the magnitude; without either, the magnitudes
    the port's AudioDistanceV1 always took, bit for bit."""
    x = signal((2, 3000, 3), seed=4)
    for kw in ({}, {"magnitude": False}, {"num_mels": 16}, {"normalized": True},
               {"magnitude": False, "num_mels": 16}):
        want = jax_stft.MultiScaleSTFT(SCALES, SR, **kw)(jnp.asarray(x))
        got = stft.MultiScaleSTFT(SCALES, SR, **kw)(to_port(x))
        for a, b in zip(got, want):
            assert a.shape == b.shape and rel_err(a.numpy(), b) < TOL, kw
    for a, scale in zip(stft.MultiScaleSTFT(SCALES, SR)(to_port(x)), SCALES):
        old = stft.stft(to_port(x).reshape(-1, 3000), scale, scale // 4).abs().transpose(-1, -2)
        assert torch.equal(a, old)


def test_build_audio_distance_kinds():
    for overrides, cls in (([], distances.AudioDistanceV1),
                           (["distance.num_mels=64"], distances.AudioDistanceV1),
                           (['distance.kind="instantaneous"'],
                            distances.WeightedInstantaneousSpectralDistance),
                           (['distance.kind="encodec"'], distances.EncodecAudioDistance)):
        got = build_audio_distance(compose(["v2"], overrides))
        want = type(jax_build_audio_distance(jax_compose(["v2"], overrides)))
        assert type(got) is cls and cls.__name__ == want.__name__
    with pytest.raises(ValueError, match="unknown distance kind"):
        build_audio_distance(compose(["v2"], ['distance.kind="mel"']))


@pytest.mark.parametrize("fn", ["get_beta_kl", "get_beta_kl_cyclic",
                                "get_beta_kl_cyclic_annealed"])
def test_beta_kl_schedules_match_jax(fn):
    args = {"get_beta_kl": (1000, 1e-6, 5e-2), "get_beta_kl_cyclic": (400, 1e-4, 1.0),
            "get_beta_kl_cyclic_annealed": (400, 1000, 1e-6, 0.1)}[fn]
    for step in (0, 1, 7, 199, 200, 201, 399, 400, 999, 1000, 1001, 5000):
        want = float(getattr(jax_dsp, fn)(step, *args))
        got = getattr(dsp, fn)(step, *args)
        assert torch.is_tensor(got) and got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-6 * abs(want), (step, float(got), want)
    got = getattr(dsp, fn)(torch.tensor([3.0, 300.0]), *args)
    assert got.shape == (2,)


# ---------------------------------------------------------------------------
# critics
# ---------------------------------------------------------------------------


def jax_init(module, x, seed=0):
    return jax.jit(module.init)({"params": jax.random.key(seed)}, jnp.asarray(x))


def assert_features_close(got, want):
    assert len(got) == len(want)
    for gs, ws in zip(got, want):
        assert len(gs) == len(ws)
        for g, w in zip(gs, ws):
            g = g.detach().numpy()
            g = g.transpose(0, 2, 1) if g.ndim == 3 else g.transpose(0, 2, 3, 1)
            assert g.shape == np.asarray(w).shape
            assert rel_err(g, w) < TOL


def test_encodec_convnet_matches_jax():
    """The five dilated (bins, frames) convs and conv_out on a channels-last
    image [B, bins, frames, 2C] in JAX, [B, 2C, bins, frames] in the port."""
    img = signal((2, 65, 40, 4), seed=5)
    jax_net = jax_disc.EncodecConvNet(capacity=4)
    variables = jax_init(jax_net, img)
    net = discriminators.EncodecConvNet(4, 4)
    from_jax_variables(net, variables)
    got = net(torch.from_numpy(np.ascontiguousarray(img.transpose(0, 3, 1, 2))))
    assert_features_close([got], [jax_net.apply(variables, jnp.asarray(img))])
    assert [tuple(f.shape[2:]) for f in got] == [(65, 40), (33, 40), (17, 40), (9, 40),
                                                (9, 40), (9, 40)]


@pytest.mark.parametrize("channels", [1, 2])
def test_spectral_critic_matches_jax(channels):
    """The image's channels are the real parts then the imaginary parts."""
    x = signal((2, 4096, channels), seed=6)
    jax_d = jax_disc.MultiScaleSpectralDiscriminator(scales=SCALES, capacity=4)
    variables = jax_init(jax_d, x)
    port = discriminators.MultiScaleSpectralDiscriminator(channels, SCALES, 4)
    from_jax_variables(port, variables)
    assert_features_close(port(to_port(x)), jax_d.apply(variables, jnp.asarray(x)))


@pytest.mark.parametrize("channels", [1, 2])
def test_spectral_critic_1d_matches_jax(channels):
    """Two channels: both packages interleave time and channels alike
    (rave_tpu's reshape of [B, T, C], mirrored: ROADMAP C18)."""
    x = signal((2, 4096, channels), seed=7)
    jax_d = jax_disc.MultiScaleSpectralDiscriminator1d(scales=SCALES, capacity=4, n_layers=3)
    variables = jax_init(jax_d, x)
    port = discriminators.MultiScaleSpectralDiscriminator1d(SCALES, 4, 3)
    from_jax_variables(port, variables)
    assert_features_close(port(to_port(x)), jax_d.apply(variables, jnp.asarray(x)))


def test_period_critic_with_a_2d_kernel_matches_jax():
    """A (5, 3) period kernel runs unfolded as in JAX's `packed=False`; the
    fold, exact only for (k, 1), refuses it."""
    x = signal((2, 990, 1), seed=8)
    jax_d = jax_disc.MultiPeriodDiscriminator(periods=(5, 7), capacity=2, n_layers=2,
                                              kernel_size=(5, 3), packed=False)
    variables = jax_init(jax_d, x)
    port = discriminators.MultiPeriodDiscriminator(1, (5, 7), 2, 2, (5, 3), fold=False)
    from_jax_variables(port, variables)
    assert_features_close(port(to_port(x)), jax_d.apply(variables, jnp.asarray(x)))
    with pytest.raises(ValueError, match=r"\(k, 1\)"):
        discriminators.MultiPeriodDiscriminator(1, (3,), 2, 2, (5, 3))


SPECTRAL = ["discriminator.spectral_scales=[512,256]", "discriminator.encodec_capacity=4"]


def test_build_spectral_critic_matches_jax():
    """`spectral`: the multiscale critic and the spectral one, with the JAX
    factory's parameters (count, names, shapes) and features."""
    tiny = ["discriminator.capacity=2"] + SPECTRAL
    x = signal((2, 4096, 1), seed=9)
    jax_d = jax_build_discriminator(jax_compose(["v2", "spectral_discriminator"], tiny))
    variables = jax_init(jax_d, x)
    port = build_discriminator(compose(["v2", "spectral_discriminator"], tiny), device="cpu")
    leaves = jax.tree_util.tree_map(np.asarray, variables["params"])
    assert sum(p.numel() for p in port.parameters()) == sum(
        v.size for v in jax.tree_util.tree_leaves(leaves))
    shapes = {k: v.shape for k, v in convert_tree(port, leaves).items()}
    assert shapes == {n: tuple(p.shape) for n, p in port.named_parameters()}
    from_jax_variables(port, variables)
    got = port(to_port(x))
    assert len(got) == 3 + 2
    assert_features_close(got, jax_d.apply(variables, jnp.asarray(x)))
    with pytest.raises(ValueError, match="unknown discriminator kind"):
        build_discriminator(compose(["v2"], ['discriminator.kind="spectral1d"']), device="cpu")
