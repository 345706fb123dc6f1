"""The fused dilated residual unit: the port's plain version and its
gradient against the JAX package's, and the module that calls it.

On the CPU the Pallas kernel cannot run outside interpret mode, so the JAX
side is its own plain path, `dilated_unit._reference_impl` (the function
the Pallas kernel's backward differentiates, through `jax.vjp`). The CUDA
kernel and the autograd.Function's kernel forward are held against
`fused_dilated_unit_reference` on the card by chip_smoke.py. Tolerance:
1e-5 relative to each output's max (float32, two conv stacks).
"""
import jax
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


def unit_inputs(C, d, mode, seed):
    rng = np.random.default_rng(seed)
    K, B, T = 3, 2, 53
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    w1 = (rng.standard_normal((K, C, C)) / np.sqrt(K * C)).astype(np.float32)  # [K, I, O]
    w2 = (rng.standard_normal((C, C)) / np.sqrt(C)).astype(np.float32)        # [I, O]
    g = rng.standard_normal((B, T, C)).astype(np.float32)                      # upstream grad
    return x, w1, w2, g, get_padding(K, 1, d, mode)


@pytest.mark.parametrize("mode", ["centered", "causal"])
@pytest.mark.parametrize("d", [1, 3, 9])
def test_gradient_matches_jax_vjp(d, mode):
    """The autograd.Function (plain forward on the CPU, recompute backward)
    against jax.vjp of `_reference_impl`: y, dx, dw1, dw2."""
    x, w1, w2, g, (left, right) = unit_inputs(8, d, mode, seed=d)
    y_j, vjp = jax.vjp(lambda a, b, c: jax_unit._reference_impl(a, b, c, d, left, right),
                       jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2))
    dx_j, dw1_j, dw2_j = vjp(jnp.asarray(g))

    xp = torch.from_numpy(x.transpose(0, 2, 1).copy()).requires_grad_()
    w1p = torch.from_numpy(w1.transpose(2, 1, 0).copy()).requires_grad_()  # [O, I, K]
    w2p = torch.from_numpy(w2.T.copy()).requires_grad_()                   # [O, I]
    before = dilated_unit.launches
    y_p = dilated_unit.fused_dilated_unit(xp, w1p, w2p, d, left, right)
    assert type(y_p.grad_fn).__name__ == "FusedDilatedUnitBackward"
    y_p.backward(torch.from_numpy(g.transpose(0, 2, 1).copy()))
    assert dilated_unit.launches == before  # CPU: the plain forward only
    assert rel_err(y_p.detach().numpy().transpose(0, 2, 1), y_j) < TOL
    assert rel_err(xp.grad.numpy().transpose(0, 2, 1), dx_j) < TOL
    assert rel_err(w1p.grad.numpy().transpose(2, 1, 0), dw1_j) < TOL
    assert rel_err(w2p.grad.numpy().T, dw2_j) < TOL


def test_gradient_only_for_inputs_that_need_it():
    x, w1, w2, g, (left, right) = unit_inputs(8, 3, "centered", seed=0)
    xp = torch.from_numpy(x.transpose(0, 2, 1).copy()).requires_grad_()
    w1p, w2p = torch.from_numpy(w1.transpose(2, 1, 0).copy()), torch.from_numpy(w2.T.copy())
    y = dilated_unit.fused_dilated_unit(xp, w1p, w2p, 3, left, right)
    (dx,) = torch.autograd.grad(y, xp, torch.from_numpy(g.transpose(0, 2, 1).copy()))
    xr = xp.detach().clone().requires_grad_()
    yr = dilated_unit.fused_dilated_unit_reference(xr, w1p, w2p, 3, left, right)
    (dx_r,) = torch.autograd.grad(yr, xr, torch.from_numpy(g.transpose(0, 2, 1).copy()))
    torch.testing.assert_close(dx, dx_r, rtol=1e-5, atol=1e-6)
    with torch.no_grad():  # no graph: straight to the forward, no Function node
        assert dilated_unit.fused_dilated_unit(xp, w1p, w2p, 3, left, right).grad_fn is None


def test_wrapper_refuses_other_devices():
    x = torch.empty(1, 4, 8, device="meta")
    w1, w2 = torch.empty(4, 4, 3, device="meta"), torch.empty(4, 4, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        dilated_unit.fused_dilated_unit(x, w1, w2, 1, 1, 1)
