"""rave_tpu_torch's kaiser resampler against rave_tpu's.

The filter design is the JAX package's, copied (its module imports jax):
both designs must be equal. The same numpy signal, made from a seed, goes
through both packages' `Resampler` down (target -> model rate) and up
(model -> target rate), offline and streamed in chunks with each one's
stream state carried, at ratios 2 and 3, with 2 streams of 2 channels;
relative error 1e-5 of the output's max (float32 convolutions summed in
different orders). The streaming delays must be equal too.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.ops import resampler as jax_resampler
from rave_tpu_torch.ops import resampler

MODEL_SR, BATCH, CHANNELS, CHUNKS = 22050, 2, 2, 4
TOL = 1e-5


def rel_err(a, b):
    return np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max()


@pytest.mark.parametrize("ratio", [2, 3])
def test_design_matches_jax(ratio):
    for mine, theirs in zip(resampler._design(ratio), jax_resampler._design(ratio)):
        np.testing.assert_array_equal(np.asarray(mine), np.asarray(theirs))


@pytest.mark.parametrize("direction", ["down", "up"])
@pytest.mark.parametrize("ratio", [2, 3])
def test_resampler_matches_jax(ratio, direction):
    target = ratio * MODEL_SR
    mine = resampler.Resampler(target, MODEL_SR, stream_batch=BATCH, n_channels=CHANNELS)
    theirs = jax_resampler.Resampler(target_sr=target, model_sr=MODEL_SR, stream_batch=BATCH,
                                     n_channels=CHANNELS)
    assert (mine.ratio, mine.down_delay, mine.up_delay) == (
        theirs.ratio, theirs.down_delay, theirs.up_delay)
    offline, step = {"down": ("to_model_sampling_rate", "step_to_model"),
                     "up": ("from_model_sampling_rate", "step_from_model")}[direction]
    chunk = 64 * ratio if direction == "down" else 64
    x = np.random.default_rng(ratio).standard_normal((BATCH, chunk * CHUNKS, CHANNELS))
    x = x.astype(np.float32)
    xt = torch.from_numpy(x.transpose(0, 2, 1).copy())

    cache = jax.jit(lambda: theirs.init({"params": jax.random.key(0)}, jnp.asarray(x),
                                        method=offline))()["cache"]
    want = np.asarray(theirs.apply({}, jnp.asarray(x), method=offline))
    got = getattr(mine, offline)(xt).numpy().transpose(0, 2, 1)
    assert got.shape == want.shape
    assert rel_err(got, want) <= TOL

    want_st, got_st = [], []
    cache = jax.tree_util.tree_map(jnp.zeros_like, cache)
    for i in range(0, x.shape[1], chunk):
        y, upd = theirs.apply({"cache": cache}, jnp.asarray(x[:, i:i + chunk]), method=step,
                              mutable=["cache"])
        cache = upd["cache"]
        want_st.append(np.asarray(y))
        got_st.append(getattr(mine, step)(xt[..., i:i + chunk]).numpy().transpose(0, 2, 1))
    want_st, got_st = np.concatenate(want_st, 1), np.concatenate(got_st, 1)
    assert got_st.shape == want.shape
    assert rel_err(got_st, want_st) <= TOL


def test_resampler_refuses_a_ratio_that_is_not_whole():
    with pytest.raises(ValueError, match="integer multiple"):
        resampler.Resampler(48000, 44100)
    with pytest.raises(ValueError, match="integer multiple"):
        resampler.Resampler(44100, 44100)
