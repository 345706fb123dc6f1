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


# ---- host side of the Hopper kernel: the plan, the TMA geometry, the build ----

H100_SMEM = 232448  # opt-in shared memory of an H100 block (cudaDevAttrMaxSharedMemoryPerBlockOptin)


@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("B,C,T", [(16, 96, 8192), (16, 192, 2048), (16, 384, 512), (16, 768, 128),
                                   (8, 96, 8192), (8, 384, 512), (1, 768, 128), (2, 48, 1003)])
def test_plan_fits_and_picks_the_mode(B, C, T, bf16):
    """Every v2 unit shape gets a plan whose shared memory fits an H100
    block, with 2-4 weight stages; leaky(h) stays resident (fused) where it
    fits and the grid has enough tiles, and fp32 above C=192 never fuses
    (its 128-frame leaky(h) tile alone would take C * 512 bytes); bf16's
    split blocks take the wider N where that still fills the card; fp32
    always flushes its sums."""
    for d in (1, 3, 9):
        left, _ = get_padding(3, 1, d, "centered")
        p = dilated_unit.plan(B, C, T, 3, d, left, bf16, H100_SMEM)
        assert p.smem <= H100_SMEM and 2 <= p.w_stages <= dilated_unit.MAX_STAGES
        assert 2 <= p.x_stages <= dilated_unit.MAX_STAGES
        assert p.np in (96, 192) and p.flush == (not bf16)
        tiles = B * -(-T // dilated_unit.TILE)
        if not bf16 and C > 192:
            assert not p.fused
        if p.fused:
            assert tiles >= dilated_unit.FUSED_MIN_TILES
        elif p.np == 192:  # bf16's wider N only where it still gives enough blocks
            assert bf16 and tiles * -(-C // 192) >= dilated_unit.FUSED_MIN_TILES
    assert dilated_unit.plan(16, 96, 8192, 3, 1, 1, False, H100_SMEM).fused
    assert not dilated_unit.plan(16, 768, 128, 3, 1, 1, True, H100_SMEM).fused
    assert dilated_unit.plan(16, 384, 512, 3, 1, 1, True, H100_SMEM).np == 192  # 128 blocks
    assert dilated_unit.plan(16, 768, 128, 3, 1, 1, True, H100_SMEM).np == 96   # 128, not 64
    assert dilated_unit.plan(16, 384, 512, 3, 1, 1, False, H100_SMEM).np == 96  # fp32 flushes


@pytest.mark.parametrize("elem", [2, 4])
@pytest.mark.parametrize("K,d,mode", [(3, 1, "centered"), (3, 9, "centered"), (3, 9, "causal"),
                                      (1, 1, "centered"), (5, 20, "causal")])
def test_window_covers_the_tile_and_is_aligned(K, d, mode, elem):
    """The activation window starts `lead` frames before the tile, 16 bytes
    aligned (TMA's rule), holds every frame the tile's taps read, and its
    row is 8 mod 32 frames (conflict-free fragment loads)."""
    left, _ = get_padding(K, 1, d, mode)
    lead = dilated_unit.lead(left, elem)
    win = dilated_unit.window(d * (K - 1), left, elem)
    assert lead >= left and (lead * elem) % 16 == 0 and lead - left < 16 // elem
    assert lead - left + dilated_unit.TILE - 1 + d * (K - 1) < win  # last frame of the last tap
    assert win % 32 == 8


def test_tma_length_pads_rows_to_16_bytes():
    for T in (1, 3, 4, 7, 8, 53, 8171):
        f32, b16 = (dilated_unit.tma_length(T, t) for t in (torch.float32, torch.bfloat16))
        assert f32 >= T and f32 * 4 % 16 == 0 and f32 - T < 4
        assert b16 >= T and b16 * 2 % 16 == 0 and b16 - T < 8


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_checks_refuse_a_halo_wider_than_a_box(dtype):
    """The window of 128 frames plus the halo must fit one 256-frame TMA box:
    d=60 at K=3 (120 frames of halo) is refused before any launch, d=40 is
    taken (the wrapper's checks, run here on CPU tensors)."""
    C = 16
    x = torch.zeros(1, C, 64, dtype=dtype)
    w1, w2 = torch.zeros(C, C, 3, dtype=dtype), torch.zeros(C, C, dtype=dtype)
    with pytest.raises(ValueError, match="TMA box"):
        dilated_unit._check(x, w1, w2, 60, 60, 60)
    dilated_unit._check(x, w1, w2, 40, 40, 40)


def test_library_hash_covers_included_headers(tmp_path, monkeypatch):
    """An edit to a header of csrc/ that the source includes renames the
    library, so a stale build is never loaded."""
    from rave_tpu_torch.ops.kernels import build

    (tmp_path / "unit.cu").write_text('#include "unit_parts.cuh"\n#include <stdint.h>\n')
    (tmp_path / "unit_parts.cuh").write_text('#include "unit_more.cuh"\n')
    (tmp_path / "unit_more.cuh").write_text("// one\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert [p.name for p in build.sources("unit")] == ["unit.cu", "unit_parts.cuh", "unit_more.cuh"]
    before = build.library_path("unit")
    (tmp_path / "unit_more.cuh").write_text("// two\n")
    assert build.library_path("unit") != before
    assert build.library_path("unit").parent == build.BUILD_DIR
