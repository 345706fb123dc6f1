"""The fused dilated unit's gradient: its plain closed form against the JAX
package's and against autograd, and the autograd.Function on the CPU (the
host side of the gradient's kernel is tests/test_torch_dilated_unit_wgrad.py).

`fused_dilated_unit_backward_reference` computes (dx, dw1, dw2) from the
closed form (g recomputed, dh, the transposed convolution, the weight
gradients as sums over every frame). The JAX side is `jax.vjp` of
`rave_tpu`'s `_reference_impl`, the function whose vjp is the Pallas
kernel's `_bwd`. Tolerances: fp32 1e-5 of each gradient's max against JAX
(two conv stacks summed in other orders) and 1e-6 against autograd of the
port's own plain forward (the same sums, other order); bf16 no further
from an fp32 referee (JAX's fp32 vjp on the same bf16 numbers) than twice
the JAX bf16 vjp's own distance from it, or 1e-3 (the rule of
tests/test_torch_bf16.py), as relative L2 distances. The CUDA kernel is
held against the plain version on the card by chip_smoke.py (phase `grad`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rave_tpu.ops.kernels import dilated_unit as jax_unit
from rave_tpu_torch.nn.conv import get_padding
from rave_tpu_torch.ops.kernels import dilated_unit

TOL_JAX, TOL_AUTOGRAD = 1e-5, 1e-6
BF16_FLOOR = 1e-3


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.sqrt(np.sum((a - b) ** 2) / np.sum(b ** 2))


def inputs(C, T, d, mode, seed, B=2, K=3):
    """Seeded numpy inputs in the JAX layouts: x [B, T, C], w1 [K, I, O],
    w2 [I, O], gy [B, T, C]; and the pads."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, T, C)).astype(np.float32)
    w1 = (rng.standard_normal((K, C, C)) / np.sqrt(K * C)).astype(np.float32)
    w2 = (rng.standard_normal((C, C)) / np.sqrt(C)).astype(np.float32)
    gy = rng.standard_normal((B, T, C)).astype(np.float32)
    return x, w1, w2, gy, get_padding(K, 1, d, mode)


def to_port(x, w1, w2, gy, dtype=torch.float32):
    """The same numbers in the port's layouts: x, gy [B, C, T], w1 [O, I, K], w2 [O, I]."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dtype)  # noqa: E731
    return (t(x.transpose(0, 2, 1)), t(w1.transpose(2, 1, 0)), t(w2.T),
            t(gy.transpose(0, 2, 1)))


def from_port(dx, dw1, dw2):
    """The port's gradients in the JAX layouts, as float32 numpy."""
    f = lambda t: t.float().numpy()  # noqa: E731
    return f(dx).transpose(0, 2, 1), f(dw1).transpose(2, 1, 0), f(dw2).T


def jax_vjp(x, w1, w2, gy, d, left, right, dtype=jnp.float32):
    _, vjp = jax.vjp(lambda a, b, c: jax_unit._reference_impl(a, b, c, d, left, right),
                     *(jnp.asarray(t, dtype) for t in (x, w1, w2)))
    return [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(gy, dtype))]


@pytest.mark.parametrize("T", [64, 53], ids=["aligned", "ragged"])
@pytest.mark.parametrize("mode", ["centered", "causal"])
@pytest.mark.parametrize("d", [1, 3, 9])
@pytest.mark.parametrize("C", [8, 16, 48])
def test_plain_backward_matches_jax_vjp(C, d, mode, T):
    x, w1, w2, gy, (left, right) = inputs(C, T, d, mode, seed=C * 100 + d * 10 + T)
    want = jax_vjp(x, w1, w2, gy, d, left, right)
    got = from_port(*dilated_unit.fused_dilated_unit_backward_reference(
        *to_port(x, w1, w2, gy), d, left, right))
    for name, a, b in zip(("dx", "dw1", "dw2"), got, want):
        assert rel_err(a, b) < TOL_JAX, name


@pytest.mark.parametrize("T", [64, 53], ids=["aligned", "ragged"])
@pytest.mark.parametrize("mode", ["centered", "causal"])
@pytest.mark.parametrize("d", [1, 3, 9])
@pytest.mark.parametrize("C", [16, 48])
def test_plain_backward_bf16_against_jax(C, d, mode, T):
    """bf16: the closed form (fp32 inside, each output rounded once, as the
    kernel) no further from the fp32 referee than twice JAX's bf16 vjp.

    The closed form rounds leaky(x) to bf16, as the kernel's bf16 operands
    are; where that moves h across 0, leaky'(h) jumps by 0.8 at that element
    (a 0.8 dg step in dh), which says on which side of the kink a rounded h
    fell and nothing of the arithmetic. So the closed form takes the
    branch from the fp32 h of the same numbers (`g_sign`), as the referee."""
    x, w1, w2, gy, (left, right) = inputs(C, T, d, mode, seed=C * 100 + d * 10 + T + 1)
    # the same bf16 numbers for every party
    x, w1, w2, gy = (np.asarray(jnp.asarray(t, jnp.bfloat16).astype(jnp.float32))
                     for t in (x, w1, w2, gy))
    ref = jax_vjp(x, w1, w2, gy, d, left, right)
    jax16 = jax_vjp(x, w1, w2, gy, d, left, right, jnp.bfloat16)
    xp, w1p, _, _ = to_port(x, w1, w2, gy)
    h = torch.nn.functional.conv1d(torch.nn.functional.pad(dilated_unit._leaky(xp),
                                                           (left, right)), w1p, dilation=d)
    grads = dilated_unit.fused_dilated_unit_backward_reference(
        *to_port(x, w1, w2, gy, torch.bfloat16), d, left, right, g_sign=h)
    assert all(g.dtype == torch.bfloat16 for g in grads)
    for name, a, j, r in zip(("dx", "dw1", "dw2"), from_port(*grads), jax16, ref):
        assert rel_l2(a, r) <= max(2 * rel_l2(j, r), BF16_FLOOR), name


@pytest.mark.parametrize("mode", ["centered", "causal"])
@pytest.mark.parametrize("d", [1, 3, 9])
@pytest.mark.parametrize("C", [8, 48])
def test_plain_backward_matches_autograd(C, d, mode):
    """The closed form is autograd of the plain forward, in float32."""
    x, w1, w2, gy, (left, right) = inputs(C, 53, d, mode, seed=C + d)
    xp, w1p, w2p, gyp = to_port(x, w1, w2, gy)
    leaves = [t.requires_grad_() for t in (xp, w1p, w2p)]
    y = dilated_unit.fused_dilated_unit_reference(*leaves, d, left, right)
    want = torch.autograd.grad(y, leaves, gyp)
    got = dilated_unit.fused_dilated_unit_backward_reference(
        *(t.detach() for t in leaves), gyp, d, left, right)
    for name, a, b in zip(("dx", "dw1", "dw2"), got, want):
        assert rel_err(a.numpy(), b.numpy()) < TOL_AUTOGRAD, name


@pytest.mark.parametrize("needs", [(True, False, False), (False, True, False),
                                   (False, False, True), (True, False, True)])
def test_plain_backward_computes_what_is_asked(needs):
    x, w1, w2, gy, (left, right) = inputs(16, 40, 3, "centered", seed=5)
    args = (*to_port(x, w1, w2, gy), 3, left, right)
    full = dilated_unit.fused_dilated_unit_backward_reference(*args)
    some = dilated_unit.fused_dilated_unit_backward_reference(*args, needs=needs)
    for n, a, b in zip(needs, some, full):
        assert (a is None) != n and (a is None or torch.equal(a, b))


def test_g_sign_picks_the_branch_of_the_kink():
    """With its own g as `g_sign` the closed form is unchanged; with a g whose
    signs differ, dh takes the other branch of leaky'(h) there, and only there."""
    x, w1, w2, gy, (left, right) = inputs(8, 32, 1, "centered", seed=6, B=1)
    xp, w1p, w2p, gyp = to_port(x, w1, w2, gy)
    args = (xp, w1p, w2p, gyp, 1, left, right)
    h = torch.nn.functional.conv1d(torch.nn.functional.pad(dilated_unit._leaky(xp),
                                                           (left, right)), w1p)
    g = dilated_unit._leaky(h)
    base = dilated_unit.fused_dilated_unit_backward_reference(*args)
    same = dilated_unit.fused_dilated_unit_backward_reference(*args, g_sign=g)
    assert all(torch.equal(a, b) for a, b in zip(base, same))
    flipped = g.clone()
    flipped[0, 3, 10] = -g[0, 3, 10]  # one frame of one channel on the other side
    other = dilated_unit.fused_dilated_unit_backward_reference(*args, g_sign=flipped)
    assert torch.equal(other[2], base[2])  # dw2 does not read dh
    changed = (other[0] != base[0]).any(dim=1)[0]  # frames of dx that moved
    assert changed.nonzero().flatten().tolist() == [9, 10, 11]  # the taps around frame 10


@pytest.mark.parametrize("mode", ["centered", "causal"])
def test_function_on_cpu_runs_the_plain_backward(mode):
    """The autograd.Function on CPU tensors: its gradients are the closed
    form's to the bit, and no kernel launch is counted, forward or backward."""
    x, w1, w2, gy, (left, right) = inputs(16, 53, 9, mode, seed=7)
    xp, w1p, w2p, gyp = to_port(x, w1, w2, gy)
    leaves = [t.clone().requires_grad_() for t in (xp, w1p, w2p)]
    counts = (dilated_unit.launches, dilated_unit.launches_backward,
              dilated_unit.launches_backward_bf16)
    y = dilated_unit.fused_dilated_unit(*leaves, 9, left, right)
    assert type(y.grad_fn).__name__ == "FusedDilatedUnitBackward"
    got = torch.autograd.grad(y, leaves, gyp)
    want = dilated_unit.fused_dilated_unit_backward_reference(xp, w1p, w2p, gyp, 9, left, right)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (dilated_unit.launches, dilated_unit.launches_backward,
            dilated_unit.launches_backward_bf16) == counts
