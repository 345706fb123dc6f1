"""The descript critic of v3: rave_tpu_torch.models.descript against rave_tpu.models.descript.

Each JAX critic is initialized from a seed and its variables go into the
port through `from_jax_variables`; the same numpy signal goes through both.
Feature maps are compared in the JAX package's channels-last layout at
1e-4 relative to their max (float32 through up to six convolutions summed
in other orders):

  * `MPD` folded (the default: the period axis in the batch, 1D convs)
    against its unfolded 2D form, and against the JAX MPD (packed, its
    default); lengths that do and do not divide the period;
  * `MSD` at scales 1 and 2 (kaiser downsampling, grouped convs);
  * `MRD` per band against the JAX MRD's default frequency-packed form,
    at the stock FFT sizes on one short signal and at 256 elsewhere;
  * the whole `DescriptDiscriminator` from both factories' v3 critic (MPDs
    then MRDs; v3 builds no MSD);
  * the v3 critic's `packed_fmaps` case (`train.feature_matching_relative`):
    the JAX maps keep the packed, zero-padded geometry, and the relative
    feature-matching loss over them equals the port's over its per-band maps
    (1e-5);
  * `train.bf16_dis`: a bf16 input keeps every feature map in bf16 (the
    STFT in fp32 between), each no further from the JAX fp32 critic than
    twice the JAX bf16 critic is (tests/test_torch_bf16.py's rule).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.config import compose as jax_compose
from rave_tpu.factory import build_discriminator as jax_build_discriminator
from rave_tpu.models import descript as jax_descript
from rave_tpu.ops.dsp import mean_difference as jax_mean_difference
from rave_tpu_torch.config import compose
from rave_tpu_torch.factory import build_discriminator
from rave_tpu_torch.models.descript import MPD, MRD, MSD, DescriptDiscriminator
from rave_tpu_torch.ops.dsp import mean_difference
from rave_tpu_torch.utils.convert import from_jax_variables

TOL, LOSS_TOL = 1e-4, 1e-5
SMALL = ["discriminator.descript_periods=[2,3]", "discriminator.descript_fft_sizes=[256]"]


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def signal(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.3).astype(np.float32)


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1)))


def port_feature(f):
    """A port feature map in the JAX package's channels-last layout."""
    f = f.detach().float().numpy()
    return f.transpose(0, 2, 1) if f.ndim == 3 else f.transpose(0, 2, 3, 1)


def jax_init(module, x, seed=0):
    return jax.jit(module.init)({"params": jax.random.key(seed)}, jnp.asarray(x))


def jax_apply(module, variables, x):
    return jax.jit(module.apply)(variables, jnp.asarray(x))


def assert_maps_close(got, want, tol=TOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = port_feature(g)
        assert g.shape == np.asarray(w).shape
        assert rel_err(g, w) < tol


@pytest.mark.parametrize("period,T", [(2, 990), (3, 997)])  # 997: the tail is padded
def test_mpd_folded_matches_unfolded_and_jax(period, T):
    x = signal((2, T, 1), seed=period)
    jax_mpd = jax_descript.MPD(period=period)
    variables = jax_init(jax_mpd, x)
    folded, unfolded = MPD(1, period), MPD(1, period, fold=False)
    from_jax_variables(folded, variables)
    unfolded.load_state_dict(folded.state_dict())
    with torch.no_grad():
        f_fold, f_unfold = folded(t(x)), unfolded(t(x))
    assert len(f_fold) == 6
    # the fold is a batch-major permutation: [B, C, H, p] -> [B*p, C, H]
    for f, u in zip(f_fold, f_unfold):
        u = u.permute(0, 3, 1, 2).reshape(-1, *u.shape[1:3])
        assert f.shape == u.shape
        assert rel_err(f.numpy(), u.numpy()) < TOL
    assert_maps_close(f_fold, jax_apply(jax_mpd, variables, x))
    jax_2d = jax_descript.MPD(period=period, packed=False)
    assert_maps_close(f_unfold, jax_apply(jax_2d, variables, x))


@pytest.mark.parametrize("scale", [1, 2])
def test_msd_matches_jax(scale):
    x = signal((2, 2048, 1), seed=10 + scale)
    jax_msd = jax_descript.MSD(scale=scale)
    variables = jax_init(jax_msd, x)
    port = MSD(1, scale)
    from_jax_variables(port, variables)
    with torch.no_grad():
        got = port(t(x))
    assert len(got) == 7
    assert_maps_close(got, jax_apply(jax_msd, variables, x))


def test_descript_critic_takes_msd_rates():
    """With `rates` (the JAX critic's field; v3 passes none) the MSDs sit
    between the MPDs and the MRDs, named as the flax modules."""
    port = DescriptDiscriminator(1, (2,), (1, 2), (256,))
    assert [n for n, _ in port.named_children()] == ["mpd_2", "msd_1", "msd_2", "mrd_256"]
    with torch.no_grad():
        feats = port(t(signal((2, 1024, 1), seed=34)))
    assert [len(f) for f in feats] == [6, 7, 7, 26]


@pytest.mark.parametrize("windows,shape", [((2048, 1024, 512), (1, 4096, 1)),
                                           ((256,), (2, 2000, 2))], ids=["stock", "small-stereo"])
def test_mrd_matches_jax_packed(windows, shape):
    """Per band against the JAX MRD's default packed form (stereo: the
    channels' real and imaginary parts are the image's 2C channels)."""
    x = signal(shape, seed=20)
    for window in windows:
        jax_mrd = jax_descript.MRD(window_length=window)
        assert jax_mrd.packed
        variables = jax_init(jax_mrd, x)
        port = MRD(shape[-1], window)
        from_jax_variables(port, variables)
        with torch.no_grad():
            got = port(t(x))
        assert len(got) == 5 * 5 + 1
        assert_maps_close(got, jax_apply(jax_mrd, variables, x))


@pytest.fixture(scope="module")
def v3_critic():
    """Both factories' v3 critic (MPDs then MRDs, no MSD) from one set of
    weights, and their maps of one batch; the JAX one has `packed_fmaps`
    (v3 sets `train.feature_matching_relative`)."""
    cfg_j = jax_compose(["v3"], SMALL)
    assert cfg_j.train.feature_matching_relative
    jax_d = jax_build_discriminator(cfg_j)
    x = signal((4, 2048, 1), seed=30)
    x[1] += 0.5  # a DC offset to remove
    variables = jax_init(jax_d, x)
    port = build_discriminator(compose(["v3"], SMALL), device="cpu")
    from_jax_variables(port, variables)
    with torch.no_grad():
        got = port(t(x))
    return jax_d, variables, x, got


def test_descript_critic_matches_jax(v3_critic):
    """The whole v3 critic: DC removal and peak normalization, then MPDs and
    MRDs, against the JAX one's per-band maps."""
    jax_d, variables, x, got = v3_critic
    want = jax_apply(jax_d.clone(packed_fmaps=False), variables, x)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_maps_close(g, w)


def test_packed_fmaps_relative_loss_matches(v3_critic):
    """The JAX v3 critic's MRD maps stay packed with zero pad bins
    (`packed_fmaps`); the relative L1 distance (sum / sum) over the
    real/fake halves is the same over them as over the port's per-band maps."""
    jax_d, variables, x, got = v3_critic
    assert jax_d.packed_fmaps
    want = jax_apply(jax_d, variables, x)
    mrd_j, mrd_p = want[-1], got[-1]
    assert any(np.asarray(w).shape != port_feature(g).shape for g, w in zip(mrd_p, mrd_j))
    for gs, ws in zip(got, want):
        for g, w in zip(gs, ws):
            real, fake = np.split(np.asarray(w), 2, axis=0)
            loss_j = float(jax_mean_difference(jnp.asarray(real), jnp.asarray(fake), norm="L1",
                                               relative=True))
            r, f = g.chunk(2, dim=0)
            loss_p = float(mean_difference(r, f, norm="L1", relative=True))
            assert abs(loss_p - loss_j) <= LOSS_TOL * abs(loss_j)


def test_bf16_dis_keeps_the_critic_in_bf16(v3_critic):
    """A bf16 input keeps every map in bf16 (the STFT in fp32 between), each
    no further from the JAX fp32 critic than twice the JAX bf16 critic is
    (relative to its max; floor 1e-3), tests/test_torch_bf16.py's rule."""
    jax_d, variables, x, _ = v3_critic
    port = build_discriminator(compose(["v3"], SMALL + ["train.bf16_dis=true"]), device="cpu")
    from_jax_variables(port, variables)
    unpacked = jax_d.clone(packed_fmaps=False)
    ref = jax_apply(unpacked, variables, x)
    jax16 = jax_apply(unpacked, variables, jnp.asarray(x, jnp.bfloat16))
    with torch.no_grad():
        got = port(t(x).to(torch.bfloat16))
    assert all(p.dtype == torch.float32 for p in port.parameters())  # the masters
    for gs, ws, js in zip(got, ref, jax16):
        for g, w, j in zip(gs, ws, js):
            assert g.dtype == torch.bfloat16 and j.dtype == jnp.bfloat16
            mine, theirs = rel_err(port_feature(g), w), rel_err(np.asarray(j, np.float32), w)
            assert mine <= max(2 * theirs, 1e-3), (mine, theirs)
