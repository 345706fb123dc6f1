"""The port's gin reader against the JAX package's.

rave_tpu_torch/config_gin.py is a copy of rave_tpu/config_gin.py that reads
the port's config. A corpus of gin texts, written here (the repo holds no
reference gin file), goes through both readers: each must give equal
configs (every field, as tests/test_torch_config.py compares presets),
equal augmentation specs and transforms, equal prior arguments, and raise
`GinParseError` where the other does. `compose` reads a `.gin` path in its
place in a stack of presets and overrides, in both packages alike.
"""
import dataclasses

import numpy as np
import pytest

from rave_tpu import config as jax_config
from rave_tpu import config_gin as jax_gin
from rave_tpu.data import transforms as jax_T
from rave_tpu_torch import config, config_gin
from rave_tpu_torch.data import transforms as T


def assert_fields_equal(port, ref, path="cfg"):
    for f in dataclasses.fields(port):
        mine, theirs = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(mine):
            assert_fields_equal(mine, theirs, f"{path}.{f.name}")
        else:
            assert mine == theirs, f"{path}.{f.name}: {mine!r} != {theirs!r}"


def write(tmp_path, text, name="model.gin"):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def both_configs(path, strict=False):
    return (config_gin.config_from_gin(path, strict=strict),
            jax_gin.config_from_gin(path, strict=strict))


@pytest.mark.parametrize("stock", sorted(jax_gin._STOCK_MACROS))
def test_stock_includes_match_jax(tmp_path, stock):
    """`include "configs/<stock>.gin"` resolves to the preset, with the
    stock file's macros in scope for the including file's references."""
    assert config_gin._STOCK_MACROS == jax_gin._STOCK_MACROS
    text = f'include "configs/{stock}.gin"\ndiscriminator.ConvNet.n_layers = 3\n'
    if "PHASE_1_DURATION" in jax_gin._STOCK_MACROS[stock]:
        text += "rave.RAVE.phase_1_duration = %PHASE_1_DURATION\n"
    path = write(tmp_path, text, f"{stock}_run.gin")
    port, ref = both_configs(path)
    assert_fields_equal(port, ref)
    assert port.name == f"{stock}_run" and port.discriminator.n_layers == 3


CUSTOM = """
from __gin__ import dynamic_registration
import rave
from rave import blocks

include "configs/v2.gin"

CAPACITY = 32            # smaller model
LATENT_SIZE = 16
RATIOS = [4, 4, 2]

blocks.EncoderV2:
    dilations = [[1, 3], [1, 3], [1]]

rave.RAVE:
    update_discriminator_every = 2
    weights = {'feature_matching': 5}

rave.BetaWarmupCallback:
    initial_value = 1e-4
    target_value = 0.2
    warmup_len = 1000
"""

CORPUS = {
    # tests/test_config_gin.py::test_custom_gin's user model
    "custom": CUSTOM,
    # the overlays: zero-lookahead convs, Snake activations
    "causal": 'cc.get_padding.mode = "causal"\n',
    "snake": "blocks.EncoderV2.activation = @blocks.Snake\n"
             "blocks.GeneratorV2.activation = @blocks.Snake\n"
             "blocks.DilatedUnit.activation = @blocks.Snake\n",
    # the spectral critic in a combine list, its scales and capacity
    "spectral": 'include "configs/v2.gin"\n'
                "rave.RAVE.discriminator = @discriminator.CombineDiscriminators\n"
                "discriminator.CombineDiscriminators.discriminators = [\n"
                "    @discriminator.MultiScaleDiscriminator,\n"
                "    @discriminator.MultiScaleSpectralDiscriminator,\n"
                "]\n"
                "discriminator.MultiScaleSpectralDiscriminator.scales = [2048, 1024, 512]\n"
                "discriminator.EncodecConvNet.capacity = 16\n",
    # the 1d spectral critic maps to kind `spectral` too (ROADMAP C18)
    "spectral1d": 'include "configs/v2.gin"\n'
                  "discriminator.CombineDiscriminators.discriminators = "
                  "[@discriminator.MultiScaleDiscriminator, "
                  "@discriminator.MultiScaleSpectralDiscriminator1d]\n"
                  "rave.RAVE.discriminator = @discriminator.CombineDiscriminators\n",
    # a mel-projected reconstruction distance, the least-squares GAN
    "mel": 'include "configs/v2.gin"\ncore.MultiScaleSTFT.num_mels = 64\n'
           "rave.RAVE.gan_loss = @core.ls_gan\n",
    # a gin macro chain, a block binding's bracket-continued value
    "macros": "CAPACITY = 8\nLATENT_SIZE = 8\nNOISE_AUGMENTATION = 4\n"
              'include "configs/discrete.gin"\n'
              "blocks.DiscreteEncoder:\n    num_quantizers = 4\n"
              "    noise_augmentation = %NOISE_AUGMENTATION\n"
              "vector_quantize.ResidualVectorQuantization.codebook_size = 64\n",
}


@pytest.mark.parametrize("name", list(CORPUS))
def test_corpus_matches_jax(tmp_path, name):
    port, ref = both_configs(write(tmp_path, CORPUS[name], f"{name}.gin"))
    assert_fields_equal(port, ref)
    if name.startswith("spectral"):
        assert port.discriminator.kind == "spectral"
    if name == "mel":
        assert port.distance.num_mels == 64


@pytest.mark.parametrize("placement", ["between", "first", "last"])
def test_compose_stacks_a_gin_path_as_jax(tmp_path, placement):
    """A `.gin` path in the middle of a stack of presets, then overrides:
    each package applies the file in its place."""
    gin = write(tmp_path, "CAPACITY = 24\nrave.RAVE.update_discriminator_every = 3\n",
                "tweak.gin")
    names = {"between": ["v2", gin, "causal"], "first": [gin, "v2"],
             "last": ["v2.gin", "spectral_discriminator", gin]}[placement]
    overrides = ["latent_size=32", "discriminator.encodec_capacity=8"]
    port, ref = config.compose(names, overrides), jax_config.compose(names, overrides)
    assert_fields_equal(port, ref)
    assert port.latent_size == 32


def test_errors_raise_in_both(tmp_path):
    """An undefined macro that a rule consumes, an include that is neither
    a stock config nor a file, and (strict mode) a binding with no rule."""
    cases = [("blocks.EncoderV2:\n    ratios = %UNDEFINED_THING\n", False),
             ('include "configs/not_a_config.gin"\n', False),
             ("some.unknown.Thing:\n    param = 3\n", True)]
    for i, (text, strict) in enumerate(cases):
        path = write(tmp_path, text, f"bad{i}.gin")
        with pytest.raises(config_gin.GinParseError):
            config_gin.config_from_gin(path, strict=strict)
        with pytest.raises(jax_gin.GinParseError):
            jax_gin.config_from_gin(path, strict=strict)
    port, ref = both_configs(write(tmp_path, cases[2][0], "lenient.gin"))  # skipped
    assert_fields_equal(port, ref)


AUGMENTATIONS = {
    "gain": "transforms.RandomGain.gain_range = (-12, 0)\ntransforms.RandomGain.prob = 0.9\n"
            "add_augmentation:\n    aug = @augmentations/transforms.RandomGain()\n",
    "compress": "add_augmentation.aug = @augmentations/transforms.RandomCompress()\n"
                "transforms.RandomCompress.prob = 1.0\ntransforms.RandomCompress.threshold = -30\n",
    "mute": "add_augmentation.aug = @augmentations/transforms.RandomMute()\n",
}


@pytest.mark.parametrize("name", list(AUGMENTATIONS))
def test_augmentation_gin_matches_jax(tmp_path, name):
    """Equal specs, and `get_augmentations` of the file gives transforms
    that agree on one signal under the same generator."""
    path = write(tmp_path, AUGMENTATIONS[name], f"{name}_aug.gin")
    specs = config_gin.augmentations_from_gin(path)
    assert specs == jax_gin.augmentations_from_gin(path) and len(specs) == 1
    (got,), (want,) = T.get_augmentations([path], 44100), jax_T.get_augmentations([path], 44100)
    assert type(got).__name__ == type(want).__name__
    x = (np.random.default_rng(1).standard_normal((8192, 1)) * 0.3).astype(np.float32)
    for seed in range(3):
        np.testing.assert_array_equal(got(np.random.default_rng(seed), x.copy()),
                                      want(np.random.default_rng(seed), x.copy()))
    stacked = config.compose(["v2", path])  # an augmentation gin as --config: --augment
    assert stacked.data.augmentations == jax_config.compose(["v2", path]).data.augmentations


def test_prior_gin_matches_jax(tmp_path):
    path = write(tmp_path, "from __gin__ import dynamic_registration\n"
                           "VariationalPrior:\n    resolution = 16\n    res_size = 128\n"
                           "    skp_size = 64\n    kernel_size = 5\n    cycle_size = 2\n"
                           "    n_layers = 6\n    sr = @get_model_sr()\n", "prior.gin")
    kw = config_gin.prior_kwargs_from_gin(path)
    assert kw == jax_gin.prior_kwargs_from_gin(path) == dict(
        resolution=16, res_size=128, skp_size=64, kernel_size=5, cycle_size=2, n_layers=6)
    empty = write(tmp_path, "# nothing here\n", "empty.gin")
    for reader in (config_gin, jax_gin):
        with pytest.raises(reader.GinParseError):
            reader.prior_kwargs_from_gin(empty)
