"""The host side of the fused unit's weight-gradient kernel
(`wgrad_wgmma_kernel`, csrc/dilated_unit.cu): its plan, a model of how it
splits and reduces the work, its shared-memory windows and bf16's slope.

The kernel runs only on the card, where chip_smoke.py's phase `grad` holds
it to the plain closed form at every shape below. Here: the plan fits an
H100 block and TMA's boxes at every (C, T, d) that phase drives, for B = 1,
8 and 16, full and ragged lengths, centered and causal; a pure-Python model
of the kernel's shares covers every chunk of every tile exactly once, in
order, within the partial and counter buffers the wrapper allocates; the
model's sums, chunk by chunk and segment by segment in the kernel's order
and windows, are the closed form's weight gradients (float64, 1e-12); the
A-fragment loads from a Q window hit 32 distinct banks; and the kernel's
bf16 leaky (two bf16x2 products) rounds as the reference's leaky does.
"""
import math

import numpy as np
import pytest
import torch

import chip_smoke
from rave_tpu_torch.nn.conv import get_padding
from rave_tpu_torch.ops.kernels import dilated_unit as du

H100_SMEM = 232448  # opt-in shared memory of an H100 block
SMS = du.H100_SMS


def plan_cases():
    """Every (C, T, d) of the v2 forward (UNIT_SHAPES) and of the variants
    (VARIANT_UNITS), as chip_smoke.py drives them."""
    shapes = {(C, T, d) for C, T, dils in chip_smoke.UNIT_SHAPES for d in dils}
    shapes |= {(C, T, d) for units in chip_smoke.VARIANT_UNITS.values() for C, T, dils in units
               for d in dils}
    return sorted(shapes)


def plans(C, T, d, bf16):
    """(B, padded T, left pad, plan) for B = 1, 8, 16, the length and a ragged
    one (T - 21), centered and causal."""
    dtype = torch.bfloat16 if bf16 else torch.float32
    for B in (1, 8, 16):
        for length in (T, T - 21):
            Tp = du.tma_length(length, dtype)
            for mode in ("centered", "causal"):
                left, _ = get_padding(3, 1, d, mode)
                yield B, Tp, left, du.backward_plan(B, C, Tp, 3, d, left, bf16, H100_SMEM)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("C,T,d", plan_cases())
def test_backward_plan_fits(C, T, d, bf16):
    """The data launches' split plan fits an H100 block with 2-4 stages for the
    wider of the two windows (dx's convolution is padded by pad_right on the
    left) and within one TMA box; the weight gradients' block fits with 3-6
    stages, its stages keep the swizzled P boxes 1024-byte aligned, its P box
    is one 128-byte swizzle row of frames by N <= 256 channels, and its Q box
    16-byte rows of at most 256 frames by 128 channels."""
    elem = 2 if bf16 else 4
    for B, Tp, left, p in plans(C, T, d, bf16):
        right = 2 * d - left
        data = p.data
        assert not data.fused and data.flush == (not bf16)
        assert data.np in ((96, 192) if bf16 and C > 96 else (96,))
        assert 2 <= data.w_stages <= 4 and 2 <= data.x_stages <= 4
        assert data.smem <= H100_SMEM
        for pad in (left, right):
            assert du.window(2 * d, pad, elem) <= du.MAX_BOX
        assert p.wg_np in du.WG_WIDTHS[bf16] and p.wg_np <= du.MAX_BOX
        assert du.WG_MIN_STAGES <= p.wg_stages <= du.WG_MAX_STAGES
        assert p.wg_smem == du.wg_smem_bytes(p.wg_np, p.wg_stages, bf16) <= H100_SMEM
        assert du.wg_frames(bf16) * elem == 128  # P's box: one swizzle row of frames
        assert du.wg_stage_bytes(p.wg_np, bf16) % 1024 == 0 and (p.wg_np * 128) % 1024 == 0
        qp = du.wg_q_pitch(bf16)
        assert (qp * elem) % 16 == 0 and qp <= du.MAX_BOX and du.WG_ROWS <= du.MAX_BOX


def wg_segments(tiles: int, chunks: int, grid: int) -> list:
    """The kernel's shares of the units (`wg_lo`): tile t's chunk c is unit t
    chunks + c, and block b runs [floor(b U / grid), floor((b + 1) U /
    grid)). Per block, its (tile, first chunk, end chunk) segments in order."""
    units, out = tiles * chunks, []
    for b in range(grid):
        u, hi, segs = b * units // grid, (b + 1) * units // grid, []
        while u < hi:
            t, c0 = divmod(u, chunks)
            c1 = min(chunks, c0 + hi - u)
            segs.append((t, c0, c1))
            u += c1 - c0
        out.append(segs)
    return out


def wg_groups(nseg: int) -> tuple:
    """(R, groups): the kernel adds a tile's nseg segments in groups of R =
    ceil(sqrt(nseg)) consecutive segments, then the groups."""
    r = math.isqrt(nseg - 1) + 1 if nseg > 1 else 1
    return r, -(-nseg // r)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("C,T,d", plan_cases())
def test_wgrad_split_covers_every_chunk_once(C, T, d, bf16):
    """For every plan of `test_backward_plan_fits`: the blocks' segments, in
    block order, run every chunk of every tile exactly once and in order;
    every block has a unit; a block shares at most its first and its last
    tile (its two partial slots); the partial buffer holds two slots per
    block; each tile's two-level reduction fits its counters; the tiles are
    (K + 1) x 128-row q tiles x N-row p tiles and the chunks B x ceil(T /
    chunk frames)."""
    for B, Tp, left, p in plans(C, T, d, bf16):
        assert p.wg_tiles == du.wg_tiles(C, p.wg_np, 4) == 4 * -(-C // 128) * -(-C // p.wg_np)
        assert p.wg_chunks == B * -(-Tp // du.wg_frames(bf16))
        assert 1 <= p.wg_grid <= max(SMS, p.wg_tiles) and p.wg_grid <= p.wg_tiles * p.wg_chunks
        segs = wg_segments(p.wg_tiles, p.wg_chunks, p.wg_grid)
        assert all(segs), "a block without a unit"
        flat = [s for block in segs for s in block]
        nxt = (0, 0)  # the next unit expected: (tile, chunk)
        for t, c0, c1 in flat:
            assert (t, c0) == nxt and c0 < c1 <= p.wg_chunks
            nxt = (t, c1) if c1 < p.wg_chunks else (t + 1, 0)
        assert nxt == (p.wg_tiles, 0)
        nseg = {}
        for block in segs:
            shared = [s for s in block if s[2] - s[1] < p.wg_chunks]
            assert all(s in (block[0], block[-1]) for s in shared)  # slots 0 and 1
            for t, _, _ in block:
                nseg[t] = nseg.get(t, 0) + 1
        for n in nseg.values():
            r, groups = wg_groups(n)
            assert r * r >= n and 1 + groups <= du.WG_COUNTERS
        assert p.partials == 2 * p.wg_grid * du.WG_ROWS * p.wg_np
        assert p.counters == 2 * du.WG_COUNTERS * p.wg_tiles


def test_backward_plan_fills_the_card_where_the_frames_allow():
    """At v2's levels at B=8 the weight gradients keep at least 90% of the
    H100's SMs busy: C=96 splits its 4 tiles 33 ways, C=192 its 16 fp32
    tiles 8 ways and its 8 bf16 tiles (N=192) 16 ways, C=384 its 24 bf16
    tiles 5 ways; C=768 in bf16 runs one block per tile (96 tiles of N=192),
    and fp32's C=384 and 768 one block per SM (48 and 192 tiles of N=96). A
    short reduction is not split further than its chunks allow."""
    want = {(96, False): (96, 4, 132), (192, False): (96, 16, 128),
            (384, False): (96, 48, 132), (768, False): (96, 192, 132),
            (96, True): (96, 4, 132), (192, True): (192, 8, 128),
            (384, True): (192, 24, 120), (768, True): (192, 96, 96)}
    for C, T, dils in chip_smoke.UNIT_SHAPES:
        for bf16 in (False, True):
            p = du.backward_plan(8, C, T, 3, dils[-1], dils[-1], bf16, H100_SMEM)
            assert (p.wg_np, p.wg_tiles, p.wg_grid) == want[C, bf16]
            assert p.wg_grid >= 0.9 * SMS or p.wg_grid == p.wg_tiles >= SMS // 2
    p = du.backward_plan(1, 768, 32, 3, 1, 1, True, H100_SMEM)
    assert p.wg_grid == p.wg_tiles * p.wg_chunks == 96


@pytest.mark.parametrize("bf16,q_off", [(False, o) for o in range(4)]
                         + [(True, o) for o in (0, 1, 6, 7)])
def test_wg_q_window_is_aligned_and_conflict_free(bf16, q_off):
    """A Q window row holds the chunk from any tap's first frame q_off (its
    shift from the 16-byte aligned start), is whole 16-byte TMA rows within
    a 256-frame box, and the A-fragment loads of a warp (lanes 4 g + tig:
    rows g, at frames q_off + 8 ks + tig and + 4 in fp32; pairs at q_off +
    16 ks + 2 tig and + 8 in bf16, two 16-bit loads where q_off is odd) hit
    32 distinct banks, rows g + 8 too."""
    elem = 2 if bf16 else 4
    qp, frames = du.wg_q_pitch(bf16), du.wg_frames(bf16)
    assert qp >= q_off + frames and (qp * elem) % 16 == 0 and qp <= du.MAX_BOX
    assert q_off < 16 // elem
    lanes = [(g, t) for g in range(8) for t in range(4)]
    steps = frames // (16 if bf16 else 8)
    for ks in range(steps):
        for half in (0, 1):
            for row0 in (0, 8):
                first = [(row0 + g) * qp + q_off + (16 if bf16 else 8) * ks
                         + (2 * t if bf16 else t) + (8 if bf16 else 4) * half for g, t in lanes]
                for extra in ((0, 1) if bf16 and q_off % 2 else (0,)):
                    banks = {(e + extra) * elem // 4 % 32 for e in first}
                    assert len(banks) == 32


def rne_bf16(x):
    """float64 -> the nearest bf16 value (ties to even), as float64; for
    normal bf16 values."""
    m, e = np.frexp(np.asarray(x, np.float64))
    return np.ldexp(np.round(m * 256) / 256, e)


def test_bf16_leaky_two_term_slope_is_exact():
    """The kernel's bf16 leaky, max(v, fma(v, hi, bf16(v lo))) with hi =
    bf16(0.2f) and lo = bf16(0.2f - hi) in bf16x2 arithmetic (the product
    exact, the fma rounded once), equals the reference's: leaky_relu of v in
    float32, rounded to bf16, for every normal bf16 v whose leaky is
    normal."""
    bits = np.arange(0x0080, 0x7F80, dtype=np.uint32)  # positive normal bf16 values
    bits = np.concatenate([bits, bits | 0x8000])
    v32 = torch.from_numpy((bits << 16).view(np.float32))
    v32 = v32[v32.abs() >= 2.0 ** -120]  # 0.2 v stays normal
    want = torch.nn.functional.leaky_relu(v32, 0.2).bfloat16().double().numpy()
    hi = rne_bf16(np.float64(np.float32(0.2)))
    lo = rne_bf16(np.float64(np.float32(0.2)) - hi)
    assert (hi, lo) == (0.2001953125, -0.00019550323486328125)  # the kernel's constants
    v = v32.double().numpy()
    got = np.maximum(v, rne_bf16(v * hi + rne_bf16(v * lo)))
    assert np.array_equal(got, want)


def wgrad_model(Q, P, taps, d, left, slope, bf16, np_=None, grid=None):
    """The kernel's weight gradient of one convolution, in float64: tiles of
    (tap, 128 q rows, N p rows), chunks of the batch's frames sample-major,
    each chunk's P box [N][frames] and Q window [128][pitch] from its 16-byte
    aligned start (zero outside the tensor), the tap's frames from q_off in
    it; per block its segments, a shared tile's segments added in the two
    levels' order. Q, P [B, C, T] -> dw [C, C, taps]."""
    B, C, T = Q.shape
    frames, step = du.wg_frames(bf16), 16 // (2 if bf16 else 4)
    np_ = np_ or (192 if bf16 and C % 192 == 0 else 96)
    qp = du.wg_q_pitch(bf16)
    per_b = -(-T // frames)
    q_tiles, p_tiles = -(-C // 128), -(-C // np_)
    tiles, chunks = taps * q_tiles * p_tiles, B * per_b
    grid = grid or du.wg_grid(tiles, chunks)
    Qz = np.zeros((B, q_tiles * 128, T + 2 * qp + 2 * frames))  # zero fill around
    Qz[:, :C, qp:qp + T] = np.where(Q >= 0, Q, slope * Q)
    Pz = np.zeros((B, p_tiles * np_, per_b * frames))
    Pz[:, :C, :T] = P
    segments = {}  # tile -> [(block, sums)], in block order
    for b, block in enumerate(wg_segments(tiles, chunks, grid)):
        for t, c0, c1 in block:
            k, r = divmod(t, q_tiles * p_tiles)
            q0, p0 = r // p_tiles * 128, r % p_tiles * np_
            shift = k * d - left
            q_off = shift % step  # the tap's first frame in its window
            q_rel = shift - q_off  # the window's start from the chunk's: 16-byte aligned
            assert q_rel % step == 0 and 0 <= q_off and q_off + frames <= qp
            acc = np.zeros((128, np_))
            for c in range(c0, c1):
                s, t0 = divmod(c, per_b)
                t0 *= frames
                start = t0 + q_rel + qp  # the window's first frame in Qz
                window = Qz[s, q0:q0 + 128, start:start + qp]
                acc += window[:, q_off:q_off + frames] @ Pz[s, p0:p0 + np_, t0:t0 + frames].T
            segments.setdefault(t, []).append(acc)
    dw = np.zeros((C, C, taps))
    for t, parts in segments.items():
        r_, _ = wg_groups(len(parts))
        groups = [sum(parts[i:i + r_], np.zeros_like(parts[0]))
                  for i in range(0, len(parts), r_)]
        tile = sum(groups, np.zeros_like(parts[0]))
        k, r = divmod(t, q_tiles * p_tiles)
        q0, p0 = r // p_tiles * 128, r % p_tiles * np_
        qs, ps = slice(q0, min(C, q0 + 128)), slice(p0, min(C, p0 + np_))
        dw[ps, qs, k] = tile[:qs.stop - q0, :ps.stop - p0].T
    return dw


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
@pytest.mark.parametrize("C,T,d,mode,B,grid", [
    (16, 100, 3, "centered", 2, None), (16, 64, 9, "causal", 3, 7),
    (40, 37, 1, "centered", 2, 5), (200, 70, 9, "centered", 1, 3),
])
def test_wgrad_model_matches_closed_form(C, T, d, mode, B, grid, bf16):
    """The model's dw1 (Q = x under leaky, P = dh) and dw2 (Q = g, P = gy, one
    tap) are the closed form's, at lengths that are not whole chunks, with
    negative shifts, tiles wider than C, several samples per block and
    blocks that share tiles (`grid`)."""
    rng = np.random.default_rng(C + T + d)
    x, gy = rng.standard_normal((2, B, C, T))
    w1 = rng.standard_normal((C, C, 3)) / np.sqrt(3 * C)
    w2 = rng.standard_normal((C, C)) / np.sqrt(C)
    left, right = get_padding(3, 1, d, mode)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    _, dw1, dw2 = du.fused_dilated_unit_backward_reference(t(x), t(w1), t(w2), t(gy), d, left,
                                                           right)
    h = torch.nn.functional.conv1d(torch.nn.functional.pad(du._leaky(t(x)), (left, right)),
                                   t(w1), dilation=d)
    g = du._leaky(h).numpy()
    dh = du._leaky_grad(h, torch.nn.functional.conv1d(t(gy), t(w2).t()[:, :, None])).numpy()
    got1 = wgrad_model(x, dh, 3, d, left, du.NEG_SLOPE, bf16, grid=grid)
    got2 = wgrad_model(g, gy, 1, 1, 0, 1.0, bf16, grid=grid)[:, :, 0]
    assert np.abs(got1 - dw1.numpy()).max() <= 1e-12 * np.abs(dw1.numpy()).max()
    assert np.abs(got2 - dw2.numpy()).max() <= 1e-12 * np.abs(dw2.numpy()).max()
