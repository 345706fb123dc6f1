"""The port's own model configuration against the JAX package's.

rave_tpu_torch.config carries the fields of rave_tpu.config that the v2
serving path reads, so that the port needs nothing of the JAX package.
Every field it has, and every resolved accessor, must equal the JAX
package's for the same presets and overrides (exact: these are ints,
tuples and strings).
"""
import dataclasses

import pytest

from rave_tpu import config as jax_config
from rave_tpu_torch import config

ACCESSORS = ["enc_capacity", "dec_capacity", "enc_ratios", "dec_ratios", "enc_data_size",
             "dec_data_size", "num_latent_out", "augmented_latent_size", "decimation",
             "block_size"]
TINY = ["capacity=2", "latent_size=4", "ratios=[4,4,2]", "dilations=[[1,3],[1,3],[1]]"]


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
], ids=["default", "tiny", "per-side", "ratios"])
@pytest.mark.parametrize("names", [["v2"], ["v2", "causal"]], ids=["v2", "v2-causal"])
def test_presets_match_jax(names, overrides):
    port, ref = config.compose(names, overrides), jax_config.compose(names, overrides)
    assert_fields_equal(port, ref)
    for name in ACCESSORS:
        assert getattr(port, name)() == getattr(ref, name)(), name


def test_defaults_match_jax():
    assert_fields_equal(config.RaveConfig(), jax_config.RaveConfig())


def test_refusals():
    with pytest.raises(KeyError, match="ROADMAP"):
        config.compose(["v2", "discrete"])
    with pytest.raises(AttributeError, match="mel_hop"):
        config.compose(["v2"], ["mel_hop=128"])
    for compose in (config.compose, jax_config.compose):
        with pytest.raises(ValueError, match="rate-preserving"):
            compose(["v2"], ["decoder.ratios=[4,4,2]"])
