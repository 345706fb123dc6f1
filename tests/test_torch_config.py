"""The port's own model configuration against the JAX package's.

rave_tpu_torch.config carries the fields of rave_tpu.config that the
serving path and training step of v1, v2, v3 and their latent families read (model, critic, distance, train and
data fields), so that the port needs nothing of the JAX package. Every
field it has, and every resolved accessor, must equal the JAX package's
for the same presets and overrides (exact: these are ints, floats, tuples,
dicts and strings).
"""
import dataclasses

import pytest

from rave_tpu import config as jax_config
from rave_tpu_torch import config

ACCESSORS = ["enc_capacity", "dec_capacity", "enc_ratios", "dec_ratios", "enc_data_size",
             "dec_data_size", "num_latent_out", "augmented_latent_size", "decimation",
             "block_size"]
TINY = ["capacity=2", "latent_size=4", "ratios=[4,4,2]", "dilations=[[1,3],[1,3],[1]]"]
TRAIN = ["discriminator.capacity=2", "distance.scales=[512,256]", "train.phase_1_duration=4",
         "train.update_discriminator_every=2", "train.beta_warmup_len=8", "train.ema=0.99",
         'train.weights={"adversarial": 2.0}', 'train.gan_loss="ls"', "data.n_signal=8192",
         'discriminator.kind="multiscale"', "discriminator.periods=[2,3]"]


def assert_fields_equal(port, ref, path="cfg"):
    for f in dataclasses.fields(port):
        mine, theirs = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(mine):
            assert_fields_equal(mine, theirs, f"{path}.{f.name}")
        else:
            assert mine == theirs, f"{path}.{f.name}: {mine!r} != {theirs!r}"


@pytest.mark.parametrize("overrides", [
    [], TINY, ["encoder.capacity=8", "decoder.capacity=16", "encoder.dilations=[[1],[1],[1],[1]]"],
    ["encoder.ratios=[4,4,2,2]", "decoder.ratios=[4,4,2,2]", "n_band=8", "mode=\"causal\""],
    TINY + TRAIN,
], ids=["default", "tiny", "per-side", "ratios", "train"])
@pytest.mark.parametrize("names", [["v2"], ["v2", "causal"], ["discrete"], ["discrete", "causal"],
                                   ["v2", "wasserstein"], ["v2", "spherical"], ["v3"],
                                   ["v3", "causal"], ["discrete_v3"],
                                   ["v2", "snake", "adain", "descript_discriminator"]],
                         ids=["v2", "v2-causal", "discrete", "discrete-causal", "wasserstein",
                              "spherical", "v3", "v3-causal", "discrete-v3", "v2-options"])
def test_presets_match_jax(names, overrides):
    port, ref = config.compose(names, overrides), jax_config.compose(names, overrides)
    assert_fields_equal(port, ref)
    for name in ACCESSORS:
        assert getattr(port, name)() == getattr(ref, name)(), name


VARIANT_TINY = {
    "v2_small": ["capacity=2", "latent_size=4", "ratios=[4,2]", "dilations=[[1],[1]]",
                 "decoder.noise_hidden=4"],
    "noise": TINY + ["decoder.noise_ratios=[4,2]", "decoder.noise_bands=8"],
    "v2_nopqmf": ["capacity=2", "encoder.ratios=[4,2]", "decoder.ratios=[16,8]"],
    "v2_nopqmf_small": ["capacity=2", "encoder.ratios=[4,2]", "decoder.ratios=[16,8]"],
    "hybrid": ["n_mels=16", "mel_n_fft=512", "mel_hop=128", "encoder.ratios=[4,4]",
               "decoder.recurrent_layers=1"],
    "v2_with_augs": ["n_mels=16", "mel_n_fft=512", "mel_hop=128", "encoder.ratios=[4,4]",
                     'mode="causal"'],
}


V1_TINY = ["capacity=4", "latent_size=4", "n_band=4", "ratios=[4,2]"]
V1_PRESETS = {"v1": ["v1"], "onnx": ["onnx"], "raspberry": ["raspberry"],
              "normalize_ambient": ["normalize_ambient"], "v1-causal": ["v1", "causal"],
              "v2-normalize_ambient": ["v2", "normalize_ambient"]}
V1_OPTIONS = ["encoder.sample_norm=true", "encoder.repeat_layers=2",
              "encoder.recurrent_layers=1", "decoder.loud_stride=2",
              "decoder.v1_noise_ratios=[4,2]", "decoder.v1_noise_bands=8",
              "decoder.res_kernel_sizes=[3,5]", "decoder.res_dilations=[[1],[3]]"]


@pytest.mark.parametrize("overrides", [[], V1_TINY, V1_TINY + V1_OPTIONS],
                         ids=["default", "tiny", "options"])
@pytest.mark.parametrize("name", list(V1_PRESETS))
def test_v1_presets_match_jax(name, overrides):
    """The v1 family's presets and `normalize_ambient`: every field (the v1
    encoder and decoder fields, the Compress augmentation) and accessor (the
    noise synth's and the loudness stride's share of the block) as the JAX
    package's."""
    names = V1_PRESETS[name]
    port, ref = config.compose(names, overrides), jax_config.compose(names, overrides)
    assert_fields_equal(port, ref)
    for accessor in ACCESSORS:
        assert getattr(port, accessor)() == getattr(ref, accessor)(), accessor


@pytest.mark.parametrize("tiny", [False, True], ids=["default", "tiny"])
@pytest.mark.parametrize("name", list(VARIANT_TINY))
def test_variant_presets_match_jax(name, tiny):
    """The noise synth, raw output and mel input presets: every field
    (`noise_*`, `mel_*`, `n_mels`, the modes) and accessor (the mel input's
    data size and decimation, the noise stride in the block) as the JAX
    package's."""
    names = ["v2", "noise"] if name == "noise" else [name]
    overrides = VARIANT_TINY[name] if tiny else []
    port, ref = config.compose(names, overrides), jax_config.compose(names, overrides)
    assert_fields_equal(port, ref)
    for accessor in ACCESSORS:
        assert getattr(port, accessor)() == getattr(ref, accessor)(), accessor


def test_defaults_match_jax():
    assert_fields_equal(config.RaveConfig(), jax_config.RaveConfig())


def test_v2_training_fields():
    """What rave_tpu.config's `_v1` and `_v2` set for training (rave/configs/v2.gin)."""
    cfg = config.compose(["v2"])
    assert (cfg.discriminator.kind, cfg.discriminator.capacity) == ("combined", 96)
    t = cfg.train
    assert t.valid_signal_crop and t.feature_matching_relative
    assert (t.num_skipped_features, t.update_discriminator_every) == (1, 4)
    assert t.weights["feature_matching"] == 20.0
    assert (t.beta_initial, t.beta_target, t.beta_warmup_len) == (1e-6, 5e-2, 20000)
    assert (cfg.data.n_signal, cfg.data.batch) == (131072, 8)
    assert cfg.distance.kind == "v1" and cfg.distance.num_mels is None


@pytest.mark.parametrize("flag", ["bf16", "bf16_dis", "remat"])
def test_unported_train_options_raise(flag):
    """The step's precision and memory options, once refused, now compose
    as the JAX package's do (the name is kept from when they raised)."""
    port = config.compose(["v2"], [f"train.{flag}=true"])
    assert getattr(port.train, flag) is True
    assert_fields_equal(port, jax_config.compose(["v2"], [f"train.{flag}=true"]))


def test_refusals():
    """Presets and fields once refused compose as the JAX package's: the
    spectral critic's `spectral_discriminator` and its `encodec_capacity`
    and `spectral_scales` (A11, refused here until ported), `discrete_v3`
    (A10), `hybrid` (A11's mel input and GRU) and the v1 family's presets
    and fields. A field the port does not have raises."""
    assert_fields_equal(config.compose(["discrete_v3"]), jax_config.compose(["discrete_v3"]))
    assert_fields_equal(config.compose(["hybrid"]), jax_config.compose(["hybrid"]))
    for name in ("v1", "onnx", "raspberry"):
        assert_fields_equal(config.compose([name]), jax_config.compose([name]))
    for names in (["spectral_discriminator"], ["v2", "spectral_discriminator"]):
        assert_fields_equal(config.compose(names), jax_config.compose(names))
    assert config.compose(["v2", "spectral_discriminator"]).discriminator.kind == "spectral"
    spectral = ["discriminator.encodec_capacity=8", "discriminator.spectral_scales=[1024,512]"]
    assert_fields_equal(config.compose(["v2"], spectral), jax_config.compose(["v2"], spectral))
    assert set(config.PRESETS) == set(jax_config.PRESETS)
    assert_fields_equal(config.compose(["v2"], ["decoder.loud_stride=2"]),
                        jax_config.compose(["v2"], ["decoder.loud_stride=2"]))
    with pytest.raises(AttributeError, match="frobnicate"):
        config.compose(["v2"], ["discriminator.frobnicate=8"])
    for compose in (config.compose, jax_config.compose):
        with pytest.raises(ValueError, match="rate-preserving"):
            compose(["v2"], ["decoder.ratios=[4,4,2]"])
