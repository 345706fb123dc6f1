"""The fused dilated residual unit: the port's plain version against the
JAX package's, and the module that calls it.

On the CPU the Pallas kernel cannot run outside interpret mode, so the JAX
side is its own plain path, `dilated_unit._reference_impl` (the function
the Pallas kernel's backward differentiates). The CUDA kernel is held
against `fused_dilated_unit_reference` on the card by chip_smoke.py.
Tolerance: 1e-5 relative to the output's max (float32, two conv stacks).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.ops.kernels import dilated_unit as jax_unit
from rave_tpu_torch.models.blocks import FusedDilatedResidual, residual_unit
from rave_tpu_torch.nn.conv import get_padding
from rave_tpu_torch.ops.kernels import dilated_unit

TOL = 1e-5


def rel_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


@pytest.mark.parametrize("mode", ["centered", "causal"])
@pytest.mark.parametrize("d", [1, 3, 9])
@pytest.mark.parametrize("C", [4, 8, 16])
def test_reference_matches_jax(C, d, mode):
    rng = np.random.default_rng(C * 100 + d)
    K, B, T = 3, 2, 53  # T not a multiple of any tile
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    w1 = (rng.standard_normal((K, C, C)) / np.sqrt(K * C)).astype(np.float32)  # [K, I, O]
    w2 = (rng.standard_normal((C, C)) / np.sqrt(C)).astype(np.float32)        # [I, O]
    left, right = get_padding(K, 1, d, mode)
    y_j = np.asarray(jax_unit._reference_impl(
        jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2), d, left, right))
    y_p = dilated_unit.fused_dilated_unit_reference(
        torch.from_numpy(x.transpose(0, 2, 1).copy()),
        torch.from_numpy(w1.transpose(2, 1, 0).copy()),  # [O, I, K]
        torch.from_numpy(w2.T.copy()),                   # [O, I]
        d, left, right,
    ).numpy().transpose(0, 2, 1)
    assert rel_err(y_p, y_j) < TOL


@pytest.mark.parametrize("mode", ["centered", "causal"])
def test_fused_residual_on_cpu_is_plain(mode):
    """On CPU tensors the fused module takes the plain path: it equals the
    unfused Residual (x + DilatedUnit(x)) and launches no kernel."""
    torch.manual_seed(0)
    unit = residual_unit(8, 3, 3, mode, True, "leaky_relu", 1)
    assert isinstance(unit, FusedDilatedResidual)
    x = torch.randn(2, 8, 40)
    before = dilated_unit.launches
    with torch.no_grad():
        y = unit(x)
        y_plain = x + unit.inner(x)
    assert dilated_unit.launches == before
    torch.testing.assert_close(y, y_plain, rtol=1e-5, atol=1e-5)


def test_wrapper_refuses_other_devices():
    x = torch.empty(1, 4, 8, device="meta")
    w1, w2 = torch.empty(4, 4, 3, device="meta"), torch.empty(4, 4, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        dilated_unit.fused_dilated_unit(x, w1, w2, 1, 1, 1)
