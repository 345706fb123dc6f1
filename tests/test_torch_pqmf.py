"""rave_tpu_torch PQMF against rave_tpu's: filter design, offline bank,
and the dual-mode modules, offline and chunked `step`.

The port re-implements the numpy/scipy design, so its kernels must equal
the JAX package's to float32 rounding (1e-7 absolute; the taps are below
1 in magnitude). Runtime outputs are compared at 1e-5 relative to the
output's max: two float32 convolution implementations summing in
different orders.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.models.pqmf_module import PQMFAnalysis as JAnalysis
from rave_tpu.models.pqmf_module import PQMFSynthesis as JSynthesis
from rave_tpu.nn import stream_chunks as jax_stream_chunks
from rave_tpu.ops.pqmf import PQMFBank as JBank
from rave_tpu.ops.pqmf import reverse_half as j_reverse_half
from rave_tpu_torch.models.pqmf_module import PQMFAnalysis, PQMFSynthesis
from rave_tpu_torch.nn.streaming import init_stream_state, stream_chunks
from rave_tpu_torch.ops.pqmf import PQMFBank, reverse_half

TOL = 1e-5


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


@pytest.fixture(scope="module")
def banks():
    return {M: (JBank.build(100, M), PQMFBank.build(100, M)) for M in (4, 16)}


@pytest.mark.parametrize("M", [4, 16])
def test_filter_design_matches(banks, M):
    jb, pb = banks[M]
    assert pb.taps == jb.taps
    np.testing.assert_allclose(pb.analysis_kernel, jb.analysis_kernel, rtol=0, atol=1e-7)
    np.testing.assert_allclose(pb.synthesis_kernel, jb.synthesis_kernel, rtol=0, atol=1e-7)


@pytest.mark.parametrize("offset", [0, 1])
def test_reverse_half_matches(offset):
    x = np.random.default_rng(3).standard_normal((2, 9, 4)).astype(np.float32)  # [B, F, M]
    y_j = np.asarray(j_reverse_half(jnp.asarray(x), offset))
    y_p = reverse_half(torch.from_numpy(x.transpose(0, 2, 1).copy()), offset).numpy()
    np.testing.assert_array_equal(y_p.transpose(0, 2, 1), y_j)


@pytest.mark.parametrize("M", [4, 16])
def test_analyze_synthesize_match(banks, M):
    jb, pb = banks[M]
    x = np.random.default_rng(0).standard_normal((2, 2048)).astype(np.float32)
    z_j = np.asarray(jb.analyze(jnp.asarray(x)))          # [B, F, M]
    z_p = pb.analyze(torch.from_numpy(x)).numpy()          # [B, M, F]
    assert rel_err(z_p.transpose(0, 2, 1), z_j) < TOL
    y_j = np.asarray(jb.synthesize(jnp.asarray(z_j)))
    y_p = pb.synthesize(torch.from_numpy(z_p)).numpy()
    assert y_p.shape == y_j.shape == x.shape
    assert rel_err(y_p, y_j) < TOL


@pytest.mark.parametrize("mode", ["centered", "causal"])
@pytest.mark.parametrize("n_channels", [1, 2])
def test_pqmf_modules_match(banks, mode, n_channels):
    jb, pb = banks[16]
    T, chunk = 4096, 512
    x = np.random.default_rng(1).standard_normal((2, T, n_channels)).astype(np.float32)
    x_p = torch.from_numpy(x.transpose(0, 2, 1).copy())

    ja = JAnalysis(bank=jb, n_channels=n_channels, mode=mode, stream_batch=2)
    pa = PQMFAnalysis(pb, n_channels, mode, stream_batch=2)
    va = ja.init(jax.random.key(0), jnp.asarray(x))
    assert pa.delay == ja.delay
    z_j = np.asarray(ja.apply({}, jnp.asarray(x)))        # [B, F, C*M]
    z_p = pa(x_p)
    assert rel_err(z_p.numpy().transpose(0, 2, 1), z_j) < TOL
    zs_j, _ = jax_stream_chunks(ja, {}, va["cache"], jnp.asarray(x), chunk)
    init_stream_state(pa, 2)
    zs_p = stream_chunks(pa, x_p, chunk)
    assert rel_err(zs_p.numpy().transpose(0, 2, 1), zs_j) < TOL

    js = JSynthesis(bank=jb, n_channels=n_channels, mode=mode, in_delay=3, stream_batch=2)
    ps = PQMFSynthesis(pb, n_channels, mode, in_delay=3, stream_batch=2)
    vs = js.init(jax.random.key(0), jnp.asarray(z_j))
    assert ps.delay == js.delay
    y_j = np.asarray(js.apply({}, jnp.asarray(z_j)))       # [B, T, C]
    y_p = ps(z_p)
    assert rel_err(y_p.numpy().transpose(0, 2, 1), y_j) < TOL
    ys_j, _ = jax_stream_chunks(js, {}, vs["cache"], jnp.asarray(z_j), chunk // 16)
    init_stream_state(ps, 2)
    ys_p = stream_chunks(ps, z_p, chunk // 16)
    assert rel_err(ys_p.numpy().transpose(0, 2, 1), ys_j) < TOL


def test_port_stream_equals_offline(banks):
    """Within the port: stream[2D:] == offline[D:-D] (the JAX package's
    own oracle, tests/test_model_streaming.py::test_pqmf_module_stream)."""
    _, pb = banks[16]
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((1, 1, 8192)).astype(np.float32))
    pa = PQMFAnalysis(pb, mode="centered")
    z_off = pa(x)
    init_stream_state(pa, 1)
    z_st = stream_chunks(pa, x, 2048)
    D = pa.delay
    assert rel_err(z_st[..., 2 * D:], z_off[..., D: z_off.shape[-1] - D]) < 1e-4
