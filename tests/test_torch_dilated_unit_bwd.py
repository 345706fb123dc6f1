"""The fused dilated unit's gradient: its plain closed form against the JAX
package's and against autograd, the autograd.Function on the CPU, and the
host side of the gradient's kernel (its plan).

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

import chip_smoke
from rave_tpu.ops.kernels import dilated_unit as jax_unit
from rave_tpu_torch.nn.conv import get_padding
from rave_tpu_torch.ops.kernels import dilated_unit

TOL_JAX, TOL_AUTOGRAD = 1e-5, 1e-6
BF16_FLOOR = 1e-3
H100_SMEM = 232448  # opt-in shared memory of an H100 block


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


# ---- host side of the gradient's kernel: the plan --------------------------

def plan_cases():
    """Every (C, T, d) of the v2 forward (UNIT_SHAPES) and of the variants
    (VARIANT_UNITS), as chip_smoke.py drives them."""
    shapes = {(C, T, d) for C, T, dils in chip_smoke.UNIT_SHAPES for d in dils}
    shapes |= {(C, T, d) for units in chip_smoke.VARIANT_UNITS.values() for C, T, dils in units
               for d in dils}
    return sorted(shapes)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("C,T,d", plan_cases())
def test_backward_plan_fits(C, T, d, bf16):
    """At every main-path and variant shape, B = 1, 8 and 16, full and ragged
    lengths, centered and causal: the data launches' split plan fits an H100
    block with 2-4 stages for the wider of the two windows (dx's convolution
    is padded by pad_right on the left) and within one TMA box; the weight
    gradients' blocks fit, in one wave of two per SM; each split has at least
    one 64-frame chunk; the partial sums are no larger than x, and absent
    when nothing is split."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    elem = 2 if bf16 else 4
    for B in (1, 8, 16):
        for length in (T, T - 21):
            Tp = dilated_unit.tma_length(length, dtype)
            for mode in ("centered", "causal"):
                left, right = get_padding(3, 1, d, mode)
                p = dilated_unit.backward_plan(B, C, Tp, 3, d, left, bf16, H100_SMEM)
                data = p.data
                assert not data.fused and data.flush == (not bf16)
                assert data.np in ((96, 192) if bf16 and C > 96 else (96,))
                assert 2 <= data.w_stages <= 4 and 2 <= data.x_stages <= 4
                assert data.smem <= H100_SMEM and p.wg_smem <= H100_SMEM
                for pad in (left, right):
                    assert dilated_unit.window(2 * d, pad, elem) <= dilated_unit.MAX_BOX
                chunks = B * -(-Tp // dilated_unit.WG_FRAMES)
                for splits, taps in ((p.splits_w1, 3), (p.splits_w2, 1)):
                    assert 1 <= splits <= max(1, chunks // dilated_unit.WG_MIN_CHUNKS)
                    tiles = (-(-C // dilated_unit.WG_TILE)) ** 2
                    assert splits == 1 or splits * tiles <= dilated_unit.WG_TARGET_BLOCKS
                    if splits > 1:
                        assert splits * taps * C * C <= B * C * Tp
                assert p.partials <= B * C * Tp
                assert (p.partials == 0) == (p.splits_w1 == 1 and p.splits_w2 == 1)


def test_backward_plan_fills_the_card_where_the_frames_allow():
    """Long reductions split until the weight gradients fill the card's two
    blocks per SM in one wave: v2's C=96 level (4 output tiles) takes 66
    splits; C=768 at T=128 (144 tiles, 16 chunks at B=8) is not split."""
    p = dilated_unit.backward_plan(8, 96, 8192, 3, 9, 9, False, H100_SMEM)
    assert (p.splits_w1, p.splits_w2) == (66, 66)
    p = dilated_unit.backward_plan(8, 768, 128, 3, 1, 1, False, H100_SMEM)
    assert (p.splits_w1, p.splits_w2, p.partials) == (1, 1, 0)


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("frames", [64, 64 + 2 + 3, 64 + 18 + 7, 64 + 120 + 3])
def test_wg_pitch_is_aligned_and_conflict_free(frames, elem):
    """A weight-gradient smem row holds the frames, is whole 16-byte TMA rows,
    and is 4 mod 32 words (8 rows x 4 words of a fragment load: 32 banks);
    its boxes stay within TMA's 256 and multiples of 1024 bytes per 64 rows."""
    w = dilated_unit.wg_pitch(frames, elem)
    assert w >= frames and (w * elem) % 16 == 0 and (w * elem // 4) % 32 == 4
    assert w <= dilated_unit.MAX_BOX and (dilated_unit.WG_TILE * w * elem) % 1024 == 0
