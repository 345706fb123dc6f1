"""The training step's losses and critics: rave_tpu_torch against rave_tpu.

The same numpy inputs (seeded) go through the JAX function and the port's.
Layouts differ (the port is channels-first, its period critics folded as
[B*p, C, T/p]), so arrays are transposed before comparing. Tolerance: 1e-5
relative to the reference's max (float32 FFTs and conv stacks summed in
other orders); the folded critic against its unfolded 2D oracle in the
port: 1e-5 as well (the same products, a 1D against a 2D convolution).
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
from rave_tpu.ops import dsp as jax_dsp
from rave_tpu.ops import stft as jax_stft
from rave_tpu_torch.config import compose
from rave_tpu_torch.factory import build_audio_distance, build_discriminator, build_gan_loss
from rave_tpu_torch.models.discriminators import MultiPeriodDiscriminator, MultiScaleDiscriminator
from rave_tpu_torch.ops import dsp, stft
from rave_tpu_torch.utils.convert import convert_tree, from_jax_variables

TOL = 1e-5
TINY = ["capacity=2", "discriminator.capacity=2", "latent_size=4", "ratios=[4,4,2]",
        "dilations=[[1],[1],[1]]", "distance.scales=[512,256]"]


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def signal(shape, seed=0, scale=0.3):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_hann_window_matches():
    for n in (128, 512, 2048):
        np.testing.assert_array_equal(stft.hann_window(n), jax_stft.hann_window(n))


@pytest.mark.parametrize("center,normalized", [(True, False), (True, True), (False, True)])
@pytest.mark.parametrize("n_fft", [256, 512])
def test_stft_matches_jax(n_fft, center, normalized):
    x = signal((3, 2000), seed=n_fft)
    s_j = np.asarray(jax_stft.stft(jnp.asarray(x), n_fft, n_fft // 4, center=center,
                                   normalized=normalized))
    s_p = stft.stft(t(x), n_fft, n_fft // 4, center=center, normalized=normalized).numpy()
    assert s_p.shape == s_j.shape
    assert rel_err(s_p, s_j) < TOL
    for power in (None, 1.0, 2.0):
        m_j = np.asarray(jax_stft.spectrogram(jnp.asarray(x), n_fft, n_fft // 4, power=power,
                                              center=center, normalized=normalized))
        m_p = stft.spectrogram(t(x), n_fft, n_fft // 4, power=power, center=center,
                               normalized=normalized).numpy()
        assert rel_err(m_p, m_j) < TOL, power


@pytest.mark.parametrize("channels", [1, 16])
def test_multiscale_stft_and_distance_match_jax(channels):
    cfg_j, cfg_p = jax_compose(["v2"], TINY), compose(["v2"], TINY)
    x = signal((2, 4096, channels), seed=1)
    y = x + signal((2, 4096, channels), seed=2, scale=0.05)
    ms_j = jax_build_audio_distance(cfg_j).multiscale_stft(jnp.asarray(x))
    ms_p = build_audio_distance(cfg_p).multiscale_stft(t(x.transpose(0, 2, 1)))
    assert len(ms_p) == len(ms_j) == 2
    for a, b in zip(ms_p, ms_j):
        assert a.shape == b.shape
        assert rel_err(a.numpy(), b) < TOL
    d_j = jax_build_audio_distance(cfg_j)(jnp.asarray(x), jnp.asarray(y))
    d_p = build_audio_distance(cfg_p)(t(x.transpose(0, 2, 1)), t(y.transpose(0, 2, 1)))
    assert set(d_p) == set(d_j) == {"spectral_distance"}
    assert rel_err(float(d_p["spectral_distance"]), float(d_j["spectral_distance"])) < TOL


@pytest.mark.parametrize("norm,relative", [("L1", False), ("L1", True), ("L2", False),
                                           ("L2", True)])
def test_mean_difference_matches_jax(norm, relative):
    a, b = signal((4, 5, 6), seed=3), signal((4, 5, 6), seed=4)
    want = float(jax_dsp.mean_difference(jnp.asarray(a), jnp.asarray(b), norm, relative))
    got = float(dsp.mean_difference(t(a), t(b), norm, relative))
    assert rel_err(got, want) < TOL


@pytest.mark.parametrize("kind", ["hinge", "ls", "nonsaturating"])
def test_gan_losses_match_jax(kind):
    real, fake = signal((4, 1, 30), seed=5, scale=2.0), signal((4, 1, 30), seed=6, scale=2.0)
    cfg = compose(["v2"], [f'train.gan_loss="{kind}"'])
    got = build_gan_loss(cfg)(t(real), t(fake))
    want = jax_dsp.GAN_LOSSES[kind](jnp.asarray(real), jnp.asarray(fake))
    for g, w in zip(got, want):
        assert rel_err(float(g), float(w)) < TOL


def test_unported_losses_raise():
    """The `encodec` distance and `distance.num_mels`, once refused (A11),
    build as the JAX factory's and give its value on one pair
    (tests/test_torch_spectral.py holds every distance and its gradient)."""
    x = signal((2, 4096, 1), seed=12)
    y = x + signal((2, 4096, 1), seed=13, scale=0.05)
    for overrides in (['distance.kind="encodec"'], ["distance.num_mels=64"]):
        want = jax_build_audio_distance(jax_compose(["v2"], TINY + overrides))(
            jnp.asarray(x), jnp.asarray(y))
        got = build_audio_distance(compose(["v2"], TINY + overrides))(
            t(x.transpose(0, 2, 1)), t(y.transpose(0, 2, 1)))
        assert set(got) == set(want)
        for k in want:
            assert rel_err(float(got[k]), float(want[k])) < TOL, (overrides, k)
    # the descript critic (A10) was refused too and is ported: it builds as
    # the JAX factory's, parameter for parameter (tests/test_torch_descript.py
    # holds its maps to the JAX critic's)
    small = ['discriminator.kind="descript"', "discriminator.descript_periods=[2]",
             "discriminator.descript_fft_sizes=[256]"]
    variables = jax_params(jax_build_discriminator(jax_compose(["v2"], small)),
                           signal((2, 1024, 1), seed=11))
    port = build_discriminator(compose(["v2"], small), device="cpu")
    from_jax_variables(port, variables)
    assert {n for n, _ in port.named_parameters()} == set(
        convert_tree(port, jax.tree_util.tree_map(np.asarray, variables["params"])))


# ---------------------------------------------------------------------------
# critics
# ---------------------------------------------------------------------------


def jax_params(module, x, seed=0):
    return jax.jit(module.init)({"params": jax.random.key(seed)}, jnp.asarray(x))


def port_feature(f):
    """A port feature map in the JAX package's channels-last layout."""
    f = f.detach().numpy()
    return f.transpose(0, 2, 1) if f.ndim == 3 else f.transpose(0, 2, 3, 1)


def assert_features_close(got, want):
    assert len(got) == len(want)
    for gs, ws in zip(got, want):
        assert len(gs) == len(ws)
        for g, w in zip(gs, ws):
            g = port_feature(g)
            assert g.shape == np.asarray(w).shape
            assert rel_err(g, w) < TOL


@pytest.mark.parametrize("T", [1000, 1001])  # odd: the pool drops the last sample
def test_multiscale_critic_matches_jax(T):
    x = signal((2, T, 1), seed=7)
    jax_d = jax_disc.MultiScaleDiscriminator(n_discriminators=3, capacity=2, n_layers=3)
    variables = jax_params(jax_d, x)
    port = MultiScaleDiscriminator(1, 3, capacity=2, n_layers=3)
    from_jax_variables(port, variables)
    assert_features_close(port(t(x.transpose(0, 2, 1))), jax_d.apply(variables, jnp.asarray(x)))


@pytest.mark.parametrize("T", [990, 997])  # 997: every period pads the tail
def test_period_critic_folded_matches_unfolded_and_jax(T):
    periods = (2, 3, 5)
    x = signal((2, T, 1), seed=8)
    xp = t(x.transpose(0, 2, 1))
    jax_d = jax_disc.MultiPeriodDiscriminator(periods=periods, capacity=2, n_layers=3)
    variables = jax_params(jax_d, x)
    folded = MultiPeriodDiscriminator(1, periods, capacity=2, n_layers=3)
    unfolded = MultiPeriodDiscriminator(1, periods, capacity=2, n_layers=3, fold=False)
    from_jax_variables(folded, variables)
    unfolded.load_state_dict(folded.state_dict())
    f_fold, f_unfold = folded(xp), unfolded(xp)
    # the fold is a batch-major permutation: [B, C, H, p] -> [B*p, C, H]
    for p, fs, us in zip(periods, f_fold, f_unfold):
        for f, u in zip(fs, us):
            u = u.permute(0, 3, 1, 2).reshape(-1, *u.shape[1:3])
            assert f.shape == u.shape
            assert rel_err(f.detach().numpy(), u.detach().numpy()) < TOL
    # the JAX package's packed critic (its default) and its unpacked 2D one
    assert_features_close(f_fold, jax_d.apply(variables, jnp.asarray(x)))
    jax_2d = jax_disc.MultiPeriodDiscriminator(periods=periods, capacity=2, n_layers=3,
                                               packed=False)
    assert_features_close(f_unfold, jax_2d.apply(variables, jnp.asarray(x)))


def test_combined_critic_matches_jax():
    """The v2 critic from both factories: periods first, then scales; the
    real/fake halves of the batch stay halves after the fold."""
    cfg_j, cfg_p = jax_compose(["v2"], TINY), compose(["v2"], TINY)
    x = signal((4, 4096, 1), seed=9)
    jax_d = jax_build_discriminator(cfg_j)
    variables = jax_params(jax_d, x)
    port = build_discriminator(cfg_p, device="cpu")
    from_jax_variables(port, variables)
    got = port(t(x.transpose(0, 2, 1)))
    assert len(got) == 5 + 3
    assert_features_close(got, jax_d.apply(variables, jnp.asarray(x)))
    half = port(t(x[:2].transpose(0, 2, 1)))
    for gs, hs in zip(got, half):
        torch.testing.assert_close(gs[-1].chunk(2, dim=0)[0], hs[-1], rtol=1e-5, atol=1e-6)


def test_critic_convert_is_strict():
    cfg = compose(["v2"], TINY)
    x = signal((2, 512, 1), seed=10)
    variables = jax_params(jax_build_discriminator(jax_compose(["v2"], TINY)), x)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    missing = {"discriminators_0": params["discriminators_0"]}
    with pytest.raises(KeyError, match="not set"):
        from_jax_variables(build_discriminator(cfg, device="cpu"), {"params": missing})
    wide = jax.tree_util.tree_map(np.asarray, params)
    wide["discriminators_0"]["period_2_0"]["WNConv_0"]["v"] = np.zeros((5, 2, 1, 2), np.float32)
    with pytest.raises(ValueError, match=r"\(K, 1\)"):
        from_jax_variables(build_discriminator(cfg, device="cpu"), {"params": wide})
