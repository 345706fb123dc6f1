"""rave_tpu_torch.nn.conv against rave_tpu.nn.conv, offline and streaming.

The same numpy input and the same weights (moved with the port's weight
bridge) go through the JAX module and its port; the port works in
[B, C, T], the JAX package in [B, T, C]. Streaming runs both packages over
the same chunks with their own stream state. Tolerance: 1e-5 relative to
the output's max, the float32 rounding of two convolution implementations
that sum in different orders (the JAX side pins 'highest' matmul precision).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.nn import Conv1d as JConv1d
from rave_tpu.nn import ConvTranspose1d as JConvTranspose1d
from rave_tpu.nn import stream_chunks as jax_stream_chunks
from rave_tpu_torch.nn.conv import Conv1d, ConvTranspose1d, conv_delay, freeze_weights, tconv_delay
from rave_tpu_torch.nn.streaming import init_stream_state, stream_chunks
from rave_tpu_torch.utils.convert import from_jax_variables

TOL = 1e-5


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def to_port(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 2, 1)))


def from_port(y):
    return y.detach().numpy().transpose(0, 2, 1)


def check_pair(jmod, pmod, chunk, C_in, T=96, seed=0):
    x = np.random.default_rng(seed).standard_normal((2, T, C_in)).astype(np.float32)
    variables = jmod.init(jax.random.key(seed), jnp.asarray(x))
    from_jax_variables(pmod, {"params": variables["params"]})
    params = variables["params"]

    y_j = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        y_p = from_port(pmod(to_port(x)))
    assert y_p.shape == y_j.shape
    assert rel_err(y_p, y_j) < TOL

    s_j, _ = jax_stream_chunks(jmod, params, variables.get("cache", {}), jnp.asarray(x), chunk)
    init_stream_state(pmod, 2)
    with torch.no_grad():
        s_p = from_port(stream_chunks(pmod, to_port(x), chunk))
    assert s_p.shape == np.asarray(s_j).shape
    assert rel_err(s_p, s_j) < TOL
    return y_p, s_p


@pytest.mark.parametrize(
    "kernel,stride,dilation,mode,in_delay,weight_norm",
    [
        (3, 1, 1, "centered", 0, True),
        (3, 1, 1, "causal", 0, True),
        (3, 1, 9, "centered", 0, True),
        (3, 1, 3, "causal", 0, False),
        (7, 1, 1, "centered", 0, True),
        (8, 4, 1, "centered", 3, True),
        (8, 4, 1, "causal", 0, True),
        (5, 2, 1, "centered", 1, True),
        (3, 4, 1, "centered", 0, True),  # pad-free fat stride: the dropped frame
    ],
)
def test_conv1d_matches_jax(kernel, stride, dilation, mode, in_delay, weight_norm):
    kw = dict(stride=stride, dilation=dilation, mode=mode, in_delay=in_delay,
              weight_norm=weight_norm, stream_batch=2)
    jmod = JConv1d(in_features=3, features=5, kernel_size=kernel, **kw)
    pmod = Conv1d(3, 5, kernel, **kw)
    assert (pmod.delay, pmod.cache_len, pmod.extra_delay) == (
        jmod.delay, jmod.cache_len, jmod.extra_delay)
    assert pmod.delay == conv_delay(in_delay, kernel, stride, dilation, mode)
    y, s = check_pair(jmod, pmod, chunk=4 * stride * 3, C_in=3)
    if mode == "causal" and in_delay == 0:
        np.testing.assert_allclose(s, y, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("ratio,mode,in_delay", [
    (2, "centered", 0), (4, "centered", 2), (4, "causal", 0), (8, "causal", 0),
])
def test_conv_transpose1d_matches_jax(ratio, mode, in_delay):
    kw = dict(mode=mode, weight_norm=True, in_delay=in_delay, stream_batch=2)
    jmod = JConvTranspose1d(in_features=4, features=3, ratio=ratio, **kw)
    pmod = ConvTranspose1d(4, 3, ratio, **kw)
    assert pmod.delay == jmod.delay == tconv_delay(in_delay, ratio, mode)
    y, s = check_pair(jmod, pmod, chunk=6, C_in=4, T=36)
    if mode == "causal":
        np.testing.assert_allclose(s, y, rtol=1e-5, atol=1e-6)


def test_weight_norm_is_per_output_channel():
    """g = ||v|| per output channel at init for both kinds, so w == v."""
    for m in (Conv1d(3, 5, 3, weight_norm=True), ConvTranspose1d(4, 3, 2, weight_norm=True)):
        with torch.no_grad():
            torch.testing.assert_close(m.weight(), m.v, rtol=1e-6, atol=1e-6)
        assert m.g.shape == (m.features,)


@pytest.mark.parametrize("kind", ["conv", "transpose"])
def test_freeze_weights_fixes_the_kernel(kind):
    """`freeze_weights` (the artifact's serving) replaces (v, g) by the
    effective kernel: the same outputs bit for bit, offline and streaming,
    and no weight-norm op per call."""
    torch.manual_seed(0)
    conv = Conv1d(3, 5, 3, weight_norm=True) if kind == "conv" else ConvTranspose1d(
        3, 5, 2, weight_norm=True)
    x = torch.randn(2, 3, 16)
    with torch.no_grad():
        want, w = conv(x), conv.weight()
        init_stream_state(conv, 2)
        want_step = conv.step(x)
        freeze_weights(conv)
        init_stream_state(conv, 2)
        assert torch.equal(conv(x), want) and torch.equal(conv.step(x), want_step)
    assert set(conv.state_dict()) == {"w", "b"} and torch.equal(conv.w, w)
    assert not conv.weight_norm and not conv.w.requires_grad
