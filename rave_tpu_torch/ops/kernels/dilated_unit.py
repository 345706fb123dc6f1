"""Fused dilated residual unit: the CUDA kernel's wrapper and its plain twin.

    y = leaky(leaky(x) (*)_d w1) . w2 + x        (LeakyReLU slope 0.2)

the v2 DilatedUnit plus its residual (rave_tpu/ops/kernels/dilated_unit.py,
which runs it as a Pallas TPU kernel). Layouts are the port's: x, y
[B, C, T]; w1 [C_out, C_in, K] and w2 [C_out, C_in], as `F.conv1d` takes
them, weight norm already applied.

`fused_dilated_unit` picks the implementation by the device of `x`: a CPU
tensor goes through `fused_dilated_unit_reference` (plain `F.conv1d`); a
CUDA tensor launches the hand-written kernel of csrc/dilated_unit.cu
(built by nvcc at first use, see build.py) or raises. The kernel has two
variants, chosen by dtype: float32 (3xTF32 `wgmma` products, fp32
accuracy) and bfloat16 (`train.bf16`: bf16 `wgmma` products with fp32
accumulation). x, w1 and w2 must share the dtype. `plan` picks how a shape
runs (leaky(h) resident in shared memory, or two launches through device
memory; output channels per pass; weight stages); `tma_length` pads a
length whose rows TMA cannot address. `launches` counts the wrapper's
calls that launched the kernel, of either variant, and `launches_bf16`
those of the bf16 one, so a run can show that its main path went through
them. Inside a CUDA graph capture a call records its launch into the graph
and is counted there; a replay of the graph runs no Python and counts
nothing (a device trace counts its kernels).

The gradient mirrors the JAX package's `custom_vjp` (`_fwd` / `_bwd`):
when autograd needs it, the forward runs inside `FusedDilatedUnit`, an
`autograd.Function` that saves only `x, w1, w2`. Its backward is the
closed form of the unit's gradient (`fused_dilated_unit_backward_reference`
on a CPU tensor, the kernel's `dilated_unit_backward` on a CUDA tensor:
g recomputed, dh, dx, and both weight gradients in one `wgmma` launch that
reduces over every frame in a fixed order), for the inputs that need a
gradient. `_bwd` computes the same function by differentiating
`_reference_impl` with XLA. `launches_backward` counts the backward's calls
(of either dtype), `launches_backward_bf16` the bf16 ones; `backward_plan`
picks how a shape runs.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from rave_tpu_torch.ops.kernels import build

NEG_SLOPE = 0.2

launches = 0  # kernel launches, both variants, since import (or since the caller reset it)
launches_bf16 = 0  # of which bf16
launches_backward = 0  # gradient kernel launches (one per backward call), both variants
launches_backward_bf16 = 0  # of which bf16
KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, NEG_SLOPE)


def fused_dilated_unit_reference(
    x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
    dilation: int, pad_left: int, pad_right: int,
) -> torch.Tensor:
    """Plain PyTorch formulation (the counterpart of `_reference_impl`)."""
    h = F.conv1d(F.pad(_leaky(x), (pad_left, pad_right)), w1, dilation=dilation)
    return F.conv1d(_leaky(h), w2[:, :, None]) + x


def _leaky_grad(t: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """leaky'(t) * v, as autograd's leaky_relu backward: v where t > 0,
    else v * slope."""
    return torch.where(t > 0, v, v * NEG_SLOPE)


def fused_dilated_unit_backward_reference(
    x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, gy: torch.Tensor,
    dilation: int, pad_left: int, pad_right: int, needs=(True, True, True),
    g_sign: torch.Tensor | None = None,
):
    """(dx, dw1, dw2) of the unit for the output gradient gy, in closed
    form (None where `needs` says no):

        a = leaky(x), h = conv_d(a, w1), g = leaky(h)
        dh  = leaky'(h) * (w2^T gy)
        dx  = gy + leaky'(x) * conv_d^T(dh, w1)
        dw2 = sum_{b,t} gy g^T,  dw1[:, :, k] = sum_{b,t} dh a[t + k d - pad_left]^T

    In float32 or wider it is exact autograd of the plain version. In bf16 it
    is what the kernel computes: float32 inside, bf16 where the kernel keeps
    bf16 (a and g, the products' operands; dh, which goes through device
    memory) and each output rounded once.

    leaky' jumps at h = 0, so two computations of h that differ by their
    rounding take the other branch wherever h is within that rounding of 0.
    `g_sign`, where given (another computation's g, as
    `backward_kernel_with_g` returns the kernel's), picks the branch by its sign
    instead of this computation's own, so that the two are compared on the
    same side of the kink."""
    dtype = x.dtype
    wide = torch.promote_types(dtype, torch.float32)
    rnd = (lambda t: t.to(dtype).to(wide)) if wide != dtype else (lambda t: t)
    x, w1, w2, gy = (t.to(wide) for t in (x, w1, w2, gy))
    T, K = x.shape[-1], w1.shape[-1]
    a = rnd(_leaky(x))
    ap = F.pad(a, (pad_left, pad_right))
    g = rnd(_leaky(F.conv1d(ap, w1, dilation=dilation)))
    dx = dw1 = dw2 = None
    if needs[0] or needs[1]:
        dh = rnd(_leaky_grad(g if g_sign is None else g_sign,
                             F.conv1d(gy, w2.t()[:, :, None])))
    if needs[0]:
        da = F.conv_transpose1d(dh, w1, dilation=dilation)[..., pad_left:pad_left + T]
        dx = (gy + _leaky_grad(x, da)).to(dtype)
    if needs[1]:
        dw1 = torch.stack([torch.einsum("bot,bit->oi", dh, ap[..., k * dilation:k * dilation + T])
                           for k in range(K)], -1).to(dtype)
    if needs[2]:
        dw2 = torch.einsum("bot,bit->oi", gy, g).to(dtype)
    return dx, dw1, dw2


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load_library("dilated_unit")
    lib.dilated_unit_smem_limit.argtypes = []
    lib.dilated_unit_smem_limit.restype = ctypes.c_int
    lib.dilated_unit_forward.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    )
    lib.dilated_unit_forward.restype = ctypes.c_int
    lib.dilated_unit_backward.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
    )
    lib.dilated_unit_backward.restype = ctypes.c_int
    return lib


@functools.cache
def smem_limit(device_index: int = 0) -> int:
    """Opt-in shared memory of a block on this card, asked once."""
    with torch.cuda.device(device_index):
        return _lib().dilated_unit_smem_limit()


# The kernel's tiling (csrc/dilated_unit.cu): blocks of 128 frames in two
# warpgroups of 64, pipeline steps of 128 bytes of input channels, rings of
# 2-4 activation-window and weight stages; TMA boxes span at most 256.
TILE, MAX_STAGES, MAX_BOX = 128, 4, 256
# below this many 128-frame tiles the fused mode (one block per tile) leaves
# most of the card idle, and the split mode's C / N blocks per tile are taken
FUSED_MIN_TILES = 128


class Plan(NamedTuple):
    fused: bool      # leaky(h) resident in shared memory; else two launches through device memory
    np: int          # output channels per pass (the N of each wgmma)
    w_stages: int    # weight stages in flight
    x_stages: int    # activation-window stages in flight
    flush: bool      # fp32: tensor-core sums flushed into fp32 registers every 3 groups
    smem: int        # bytes of shared memory per block


def lead(pad_left: int, elem: int) -> int:
    """Frames before a tile that its activation window starts at: the left
    padding rounded up to 16 bytes (a TMA box starts 16-byte aligned)."""
    step = 16 // elem
    return -(-pad_left // step) * step


def window(halo: int, pad_left: int, elem: int) -> int:
    """Frames of an activation window: the lead, the tile and the rest of
    the halo, a multiple of 8 and 8 mod 32 (conflict-free fragment loads)."""
    w = -(-(TILE + halo + lead(pad_left, elem) - pad_left) // 8) * 8
    while w % 32 != 8:
        w += 8
    return w


def smem_bytes(C: int, win: int, np: int, w_stages: int, x_stages: int, fused: bool,
               bf16: bool) -> int:
    """Shared memory of one block with activation windows of `win` frames
    (the kernel's `Layout`)."""
    kc, parts, elem = (64, 1, 2) if bf16 else (32, 2, 4)
    h = TILE * (-(-C // kc) * kc * elem // 4 + 4) * 4 if fused else 0
    return (1024 + w_stages * np * 128 * parts + x_stages * 128 * win + h
            + 16 * (w_stages + x_stages))


def plan(B: int, C: int, T: int, K: int, dilation: int, pad_left: int, bf16: bool,
         limit: int) -> Plan:
    """How the kernel runs this shape on a card whose blocks may have `limit`
    bytes of shared memory. Fused where leaky(h) fits beside two weight
    stages and the grid has FUSED_MIN_TILES tiles; otherwise split, with N =
    96 (bf16: 192 where that still gives FUSED_MIN_TILES blocks), and
    as many weight stages, then window stages, as fit (a window feeds one tap
    in conv2). fp32 always flushes: without it the forward's ~1e-5 error
    takes a v2 pre-warmup gradient 0.48 from float64 (PERF.md).
    (`_check` has refused a halo wider than a box.)"""
    win = window(dilation * (K - 1), pad_left, 2 if bf16 else 4)
    np = 96 if not bf16 or C <= 96 else 192
    if B * -(-T // TILE) >= FUSED_MIN_TILES and (f := _fit(C, win, np, True, 2, bf16, limit)):
        return Plan(True, np, f[0], 2, not bf16, f[1])
    return _split_plan(B, C, T, win, bf16, limit, f"C={C}, K={K}, d={dilation}")


def _fit(C: int, win: int, np: int, fused: bool, x_stages: int, bf16: bool, limit: int):
    """(weight stages, bytes) that fit beside x_stages windows, or None."""
    free = limit - smem_bytes(C, win, np, 0, x_stages, fused, bf16)
    n = min(MAX_STAGES, free // (np * 128 * (1 if bf16 else 2) + 16))
    return (n, smem_bytes(C, win, np, n, x_stages, fused, bf16)) if n >= 2 else None


def _split_plan(B: int, C: int, T: int, win: int, bf16: bool, limit: int, what: str,
                wide: bool = True) -> Plan:
    """The split mode's plan for windows of `win` frames (`wide`: bf16 may
    take N = 192)."""
    np = 192 if wide and bf16 and B * -(-T // TILE) * -(-C // 192) >= FUSED_MIN_TILES else 96
    fits = [(f[0], x_stages, f[1]) for x_stages in (MAX_STAGES, 2)
            if (f := _fit(C, win, np, False, x_stages, bf16, limit))]
    if not fits:
        raise ValueError(f"{what} needs more shared memory than a block can have")
    w_stages, x_stages, smem = max(fits)  # weight stages first, then window stages
    return Plan(False, np, w_stages, x_stages, not bf16, smem)


# The weight gradients' kernel (csrc/dilated_unit.cu, `wgrad_wgmma_kernel`):
# tiles of one tap x 128 input channels (two consumer warpgroups of 64) x N
# output channels, over chunks of one 128-byte TMA row of frames; a ring of
# WG_MIN_STAGES..WG_MAX_STAGES stages of P (and, fp32, its lo part) and a Q
# window of the chunk and 16 bytes; each block runs a share of the (tile,
# chunk) units. WG_WIDTHS: the N each variant instantiates.
WG_ROWS, WG_MIN_STAGES, WG_MAX_STAGES = 128, 3, 6
WG_WIDTHS = {False: (96,), True: (96, 192)}
WG_COUNTERS = 16  # int32 counters per tile and consumer warpgroup (`kWgCounters`)
H100_SMS = 132


class BackwardPlan(NamedTuple):
    data: Plan       # the split-mode plan of the three data-gradient launches
    wg_np: int       # output channels (N) of a weight-gradient tile
    wg_stages: int   # the weight gradients' ring stages
    wg_grid: int     # their blocks (`wg_grid`), each with an equal share of the units
    wg_tiles: int    # tiles of dw1 and dw2: (K + 1) x ceil(C / 128) x ceil(C / N)
    wg_chunks: int   # chunks of a tile: B x ceil(T / wg_frames)
    partials: int    # fp32 elements of the partial sums: 2 slots per block
    counters: int    # int32 tile counters: WG_COUNTERS per tile and consumer warpgroup
    wg_smem: int     # bytes of shared memory of a weight-gradient block


def wg_frames(bf16: bool) -> int:
    """Frames of a weight-gradient chunk: one 128-byte swizzle row of P."""
    return 64 if bf16 else 32


def wg_q_pitch(bf16: bool) -> int:
    """Frames of a Q window row (the kernel's `Wg::QP`): the chunk and TMA's
    16-byte start alignment, 144 bytes (36 words: 4 mod 8, conflict-free A
    fragment loads)."""
    return wg_frames(bf16) + (8 if bf16 else 4)


def wg_stage_bytes(np: int, bf16: bool) -> int:
    """One stage: P [np][128 bytes] (fp32 also its lo part), then Q [128][pitch]."""
    return (1 if bf16 else 2) * np * 128 + WG_ROWS * wg_q_pitch(bf16) * (2 if bf16 else 4)


def wg_smem_bytes(np: int, stages: int, bf16: bool) -> int:
    """Shared memory of a weight-gradient block (the kernel's `Wg::smem_bytes`):
    the stages, three barriers each, a flag per consumer warpgroup."""
    return 1024 + stages * (wg_stage_bytes(np, bf16) + 24) + 8


def wg_tiles(C: int, np: int, taps: int) -> int:
    """Tiles of the weight gradients of `taps` taps in all."""
    return taps * -(-C // WG_ROWS) * -(-C // np)


def wg_grid(tiles: int, chunks: int, sms: int = H100_SMS) -> int:
    """The weight gradients' blocks: one per tile where the tiles number sms /
    2 to sms (no tile is split); where they are fewer, a whole number of
    blocks per tile if that keeps 90% of the SMs busy (each block then runs
    one segment of one tile: fewer partials, measured faster), else one
    block per SM; never more blocks than units."""
    if sms // 2 <= tiles <= sms:
        return tiles
    if tiles < sms // 2 and tiles * (sms // tiles) * 10 >= 9 * sms:
        return min(tiles * (sms // tiles), tiles * chunks)
    return min(sms, tiles * chunks)


def backward_plan(B: int, C: int, T: int, K: int, dilation: int, pad_left: int, bf16: bool,
                  limit: int, sms: int = H100_SMS) -> BackwardPlan:
    """How the gradient runs this shape on a card of `sms` SMs whose blocks
    may have `limit` bytes of shared memory: the forward's split mode for g,
    dh and dx, sized for the wider of the two windows (dx's convolution is
    padded by pad_right on the left); for the weight gradients N = 192 in
    bf16 where it divides C, else 96 (the wider tile reads fewer bytes per
    product: faster at v2's C = 192, 384 and 768 in bf16, measured); the
    blocks of `wg_grid`, each with an equal share of the (tile, chunk) units;
    as many stages as fit, up to WG_MAX_STAGES."""
    elem, halo = (2 if bf16 else 4), dilation * (K - 1)
    win = max(window(halo, pad_left, elem), window(halo, halo - pad_left, elem))
    data = _split_plan(B, C, T, win, bf16, limit, f"the gradient at C={C}, K={K}, d={dilation}",
                       wide=C > 96)  # N = 192 would leave half of each product idle
    np = 192 if bf16 and C % 192 == 0 else 96
    stages = min(WG_MAX_STAGES, (limit - wg_smem_bytes(np, 0, bf16))
                 // (wg_stage_bytes(np, bf16) + 24))
    if stages < WG_MIN_STAGES:
        raise ValueError(f"the weight gradient at C={C} needs more shared memory than a block "
                         f"can have")
    tiles = wg_tiles(C, np, K + 1)
    chunks = B * -(-T // wg_frames(bf16))
    grid = wg_grid(tiles, chunks, sms)
    return BackwardPlan(data, np, stages, grid, tiles, chunks, 2 * grid * WG_ROWS * np,
                        2 * WG_COUNTERS * tiles, wg_smem_bytes(np, stages, bf16))


def tma_length(T: int, dtype: torch.dtype) -> int:
    """The length x is padded to (with zeros, which the convolution's right
    padding reads anyway): TMA wants each row's stride a multiple of 16 bytes."""
    step = 16 // (2 if dtype == torch.bfloat16 else 4)
    return -(-T // step) * step


@functools.cache
def kernel_plan(B: int, C: int, T: int, K: int, dilation: int, pad_left: int, bf16: bool,
                device_index: int = 0) -> Plan:
    """`plan` for this shape on this card, computed once per shape."""
    return plan(B, C, tma_length(T, torch.bfloat16 if bf16 else torch.float32), K, dilation,
                pad_left, bf16, smem_limit(device_index))


@functools.cache
def kernel_backward_plan(B: int, C: int, T: int, K: int, dilation: int, pad_left: int,
                         bf16: bool, device_index: int = 0) -> BackwardPlan:
    """`backward_plan` for this shape on this card, computed once per shape."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return backward_plan(B, C, tma_length(T, torch.bfloat16 if bf16 else torch.float32), K,
                         dilation, pad_left, bf16, smem_limit(device_index), sms)


COUNTER_CAPACITY = 16384  # int32 tile counters: every C up to 1152 at K = 3 (v2: 768)
_COUNTERS: dict = {}  # device index -> int32 zeros: the weight gradients' tile counters
_RETIRED: list = []  # buffers outgrown: a captured CUDA graph may still hold their address


def _counters(device: torch.device, n: int, shape: str = "") -> torch.Tensor:
    """The weight gradients' tile counters on `device`, at least `n`. Every
    launch that completes leaves them zero, so one buffer serves every call
    on the device (its stream orders the calls) and every replay of a graph
    that captured it. It is made at its full size, COUNTER_CAPACITY or `n`,
    at the first call on the device. A later call that needs more replaces
    it, keeping the old one alive for the graphs that hold its address; inside
    a CUDA graph capture it raises instead, naming the unit's `shape` (the
    buffer would come from the graph's pool, which other graphs overwrite)."""
    buf = _COUNTERS.get(device.index)
    if buf is not None and buf.numel() >= n:
        return buf
    if torch.cuda.is_current_stream_capturing():
        held = 0 if buf is None else buf.numel()
        raise RuntimeError(
            f"dilated_unit backward {shape}: needs {n} weight-gradient tile counters on "
            f"{device}, which holds {held}; the buffer cannot be made or grown inside a CUDA "
            f"graph capture: run the step eagerly first (a warm-up call)")
    if buf is not None:
        _RETIRED.append(buf)
    buf = _COUNTERS[device.index] = torch.zeros(max(n, COUNTER_CAPACITY), dtype=torch.int32,
                                                device=device)
    return buf


def launch_counts() -> tuple:
    """(launches, launches_bf16, launches_backward, launches_backward_bf16)."""
    return launches, launches_bf16, launches_backward, launches_backward_bf16


def _check(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
           dilation: int, pad_left: int, pad_right: int) -> None:
    if x.dim() != 3 or w1.dim() != 3 or w2.dim() != 2:
        raise ValueError(f"expected x [B,C,T], w1 [C,C,K], w2 [C,C]; got "
                         f"{tuple(x.shape)}, {tuple(w1.shape)}, {tuple(w2.shape)}")
    C, K = x.shape[1], w1.shape[2]
    if w1.shape[:2] != (C, C) or w2.shape != (C, C):
        raise ValueError(f"weights {tuple(w1.shape)}, {tuple(w2.shape)} do not match C={C}")
    if dilation < 1 or pad_left < 0 or pad_right < 0 or pad_left + pad_right != dilation * (K - 1):
        raise ValueError(f"'same' output needs pad_left + pad_right == dilation*(K-1); got "
                         f"d={dilation}, pads=({pad_left}, {pad_right}), K={K}")
    dtype, device = x.dtype, x.device
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16; x is {dtype}")
    if w1.device != device or w2.device != device:
        raise ValueError(f"w1 is on {w1.device}, w2 on {w2.device}, x on {device}")
    if w1.dtype != dtype or w2.dtype != dtype:
        raise TypeError(f"x, w1 and w2 must share a dtype; x is {dtype}, w1 {w1.dtype}, "
                        f"w2 {w2.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    step = 16 if dtype == torch.bfloat16 else 8  # the depth of one tensor-core product
    if C % step:
        raise ValueError(f"the {dtype} kernel takes C % {step} == 0 (whole k{step} "
                         f"tensor-core steps); C={C}")
    if window(dilation * (K - 1), pad_left, x.element_size()) > MAX_BOX:
        raise ValueError(f"(K-1)*dilation = {dilation * (K - 1)} frames of halo: the kernel's "
                         f"{TILE}-frame tile plus the halo must fit one {MAX_BOX}-frame TMA box")


def traced() -> bool:
    """Whether a `torch.jit.trace` or a `torch.export` is recording."""
    return torch.jit.is_tracing() or torch.compiler.is_exporting()


def _forward(
    x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
    dilation: int, pad_left: int, pad_right: int,
) -> torch.Tensor:
    """The forward alone: plain on the CPU, the kernel on a CUDA tensor. A
    trace of the launch would record an empty buffer and not the kernel that
    fills it: on a CUDA tensor under a trace it raises (the traced unit is
    ops/kernels/unit_op.py's registered op)."""
    if x.device.type == "cpu":
        return fused_dilated_unit_reference(x, w1, w2, dilation, pad_left, pad_right)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dilated_unit runs on cpu or cuda, not {x.device}")
    if traced():
        raise RuntimeError("fused_dilated_unit's ctypes launch cannot be traced or exported (the "
                           "program would return the unfilled buffer): trace through "
                           "ops/kernels/unit_op.py::unit_op, the registered op")
    _check(x, w1, w2, dilation, pad_left, pad_right)
    B, C, T = x.shape
    K = w1.shape[2]
    bf16 = x.dtype == torch.bfloat16
    p = kernel_plan(B, C, T, K, dilation, pad_left, bf16, x.device.index)
    Tp = tma_length(T, x.dtype)
    index = x.device.index
    with (contextlib.nullcontext() if index == torch.cuda.current_device()
          else torch.cuda.device(index)):
        xp = x if Tp == T else F.pad(x, (0, Tp - T))
        w1c, w2c = w1.contiguous(), w2.contiguous()
        # one workspace: the prepared weights, then (split) leaky(h) [B, C, Tp]
        weights = (K if bf16 else 2 * (K + 1)) * C * C
        work = torch.empty(weights + (0 if p.fused else B * C * Tp), dtype=x.dtype, device=x.device)
        y = torch.empty_like(xp)
        err = _lib().dilated_unit_forward(
            xp.data_ptr(), w1c.data_ptr(), w2c.data_ptr(), y.data_ptr(), work.data_ptr(),
            work[weights:].data_ptr() if not p.fused else 0,
            B, C, Tp, K, dilation, pad_left, int(bf16), int(p.fused), p.np, p.w_stages,
            p.x_stages, int(p.flush), torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"dilated_unit kernel launch failed: cudaError {err}")
    global launches, launches_bf16
    launches += 1
    launches_bf16 += bf16
    return y if Tp == T else y[..., :T].contiguous()


def _backward(
    x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, gy: torch.Tensor,
    dilation: int, pad_left: int, pad_right: int, needs,
):
    """(dx, dw1, dw2), None where `needs` says no: plain on the CPU, the
    kernel on a CUDA tensor."""
    if x.device.type == "cpu":
        return fused_dilated_unit_backward_reference(x, w1, w2, gy, dilation, pad_left,
                                                     pad_right, needs)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dilated_unit runs on cpu or cuda, not {x.device}")
    return _backward_kernel(x, w1, w2, gy, dilation, pad_left, pad_right, needs)[:3]


def backward_kernel_with_g(
    x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, gy: torch.Tensor,
    dilation: int, pad_left: int, pad_right: int,
):
    """For checks: the gradient kernel's (dx, dw1, dw2) and its recomputed
    g = leaky(h) [B, C, T] on a CUDA tensor, so that the plain version can
    be compared at the kernel's side of leaky'(h)'s kink
    (`fused_dilated_unit_backward_reference(..., g_sign=g)`)."""
    if x.device.type != "cuda":
        raise ValueError(f"the gradient kernel runs on cuda, not {x.device}")
    return _backward_kernel(x, w1, w2, gy, dilation, pad_left, pad_right, (True,) * 3)


def _backward_kernel(x, w1, w2, gy, dilation, pad_left, pad_right, needs):
    """One call of the gradient's kernels (five launches: the weights'
    preparation, g, dh, dx, and dw1 with dw2): (dx, dw1, dw2, g), g a view of
    its workspace."""
    _check(x, w1, w2, dilation, pad_left, pad_right)
    if gy.shape != x.shape or gy.dtype != x.dtype or gy.device != x.device:
        raise ValueError(f"the output gradient {tuple(gy.shape)} {gy.dtype} on {gy.device} does "
                         f"not match x {tuple(x.shape)} {x.dtype} on {x.device}")
    B, C, T = x.shape
    K = w1.shape[2]
    bf16 = x.dtype == torch.bfloat16
    p = kernel_backward_plan(B, C, T, K, dilation, pad_left, bf16, x.device.index)
    Tp = tma_length(T, x.dtype)
    index = x.device.index
    with (contextlib.nullcontext() if index == torch.cuda.current_device()
          else torch.cuda.device(index)):
        pad = (lambda t: t.contiguous()) if Tp == T else (lambda t: F.pad(t, (0, Tp - T)))
        xp, gyp = pad(x), pad(gy)
        w1c, w2c = w1.contiguous(), w2.contiguous()
        # one workspace: the three prepared weights, then g and dh [B, C, Tp]
        work = torch.empty((1 if bf16 else 2) * (2 * K + 1) * C * C + 2 * B * C * Tp,
                           dtype=x.dtype, device=x.device)
        part = torch.empty(p.partials, dtype=torch.float32, device=x.device)
        dx = torch.empty_like(xp) if needs[0] else None
        dw1 = torch.empty_like(w1c) if needs[1] else None
        dw2 = torch.empty_like(w2c) if needs[2] else None
        ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
        d = p.data
        err = _lib().dilated_unit_backward(
            xp.data_ptr(), w1c.data_ptr(), w2c.data_ptr(), gyp.data_ptr(), ptr(dx), ptr(dw1),
            ptr(dw2), work.data_ptr(), part.data_ptr(),
            _counters(x.device, p.counters, f"B={B} C={C} T={T} K={K} d={dilation}").data_ptr(),
            B, C, Tp, K, dilation, pad_left, int(bf16), d.np, d.w_stages, d.x_stages,
            int(d.flush), p.wg_np, p.wg_stages, p.wg_grid,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"dilated_unit backward launch failed: cudaError {err}")
    global launches_backward, launches_backward_bf16
    launches_backward += 1
    launches_backward_bf16 += bf16
    if dx is not None and Tp != T:
        dx = dx[..., :T].contiguous()
    weights = (1 if bf16 else 2) * (2 * K + 1) * C * C
    return dx, dw1, dw2, work[weights:weights + B * C * Tp].view(B, C, Tp)[..., :T]


class FusedDilatedUnit(torch.autograd.Function):
    """The unit under autograd: `_fwd` / `_bwd` of the JAX package's
    `custom_vjp`. Forward: `_forward` (the kernel on a CUDA tensor), saving
    only the inputs. Backward: `_backward` (the gradient's kernel on a CUDA
    tensor, its closed form on the CPU), for the inputs that need a
    gradient."""

    @staticmethod
    def forward(ctx, x, w1, w2, dilation: int, pad_left: int, pad_right: int):
        ctx.save_for_backward(x, w1, w2)
        ctx.conv = (dilation, pad_left, pad_right)
        return _forward(x, w1, w2, dilation, pad_left, pad_right)

    @staticmethod
    def backward(ctx, grad_y):
        x, w1, w2 = ctx.saved_tensors
        grads = _backward(x, w1, w2, grad_y, *ctx.conv, ctx.needs_input_grad[:3])
        return (*grads, None, None, None)


def fused_dilated_unit(
    x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
    dilation: int, pad_left: int, pad_right: int,
) -> torch.Tensor:
    """x [B, C, T]; w1 [C, C, K]; w2 [C, C] -> y [B, C, T].

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    Where autograd records (grad enabled and an input requires grad), the
    call goes through `FusedDilatedUnit`; otherwise straight to `_forward`.
    """
    args = (x, w1, w2, dilation, pad_left, pad_right)
    if torch.is_grad_enabled() and (x.requires_grad or w1.requires_grad or w2.requires_grad):
        return FusedDilatedUnit.apply(*args)
    return _forward(*args)
