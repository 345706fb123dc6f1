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
them.

The gradient mirrors the JAX package's `custom_vjp` (`_fwd` / `_bwd`):
when autograd needs it, the forward runs inside `FusedDilatedUnit`, an
`autograd.Function` that saves only `x, w1, w2`; its backward recomputes
the plain formulation and differentiates it with `torch.autograd.grad`,
as `_bwd` differentiates `_reference_impl` with XLA. The TPU kernel has no
backward kernel, so neither has this one (ROADMAP A16 keeps a fused CUDA
backward as a later item).
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


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load_library("dilated_unit")
    lib.dilated_unit_smem_limit.argtypes = []
    lib.dilated_unit_smem_limit.restype = ctypes.c_int
    lib.dilated_unit_forward.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    )
    lib.dilated_unit_forward.restype = ctypes.c_int
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
    frame_tiles = B * -(-T // TILE)

    def fit(np, fused, x_stages):
        """(weight stages, bytes) that fit beside x_stages windows, or None."""
        free = limit - smem_bytes(C, win, np, 0, x_stages, fused, bf16)
        n = min(MAX_STAGES, free // (np * 128 * (1 if bf16 else 2) + 16))
        return (n, smem_bytes(C, win, np, n, x_stages, fused, bf16)) if n >= 2 else None

    np = 96 if not bf16 or C <= 96 else 192
    if frame_tiles >= FUSED_MIN_TILES and (f := fit(np, True, 2)):
        return Plan(True, np, f[0], 2, not bf16, f[1])
    np = 192 if bf16 and frame_tiles * -(-C // 192) >= FUSED_MIN_TILES else 96
    fits = [(f[0], x_stages, f[1]) for x_stages in (MAX_STAGES, 2)
            if (f := fit(np, False, x_stages))]
    if not fits:
        raise ValueError(f"C={C}, K={K}, d={dilation} needs more shared memory than a block "
                         f"can have")
    w_stages, x_stages, smem = max(fits)  # weight stages first, then window stages
    return Plan(False, np, w_stages, x_stages, not bf16, smem)


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


def _forward(
    x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
    dilation: int, pad_left: int, pad_right: int,
) -> torch.Tensor:
    """The forward alone: plain on the CPU, the kernel on a CUDA tensor."""
    if x.device.type == "cpu":
        return fused_dilated_unit_reference(x, w1, w2, dilation, pad_left, pad_right)
    if x.device.type != "cuda":
        raise ValueError(f"fused_dilated_unit runs on cpu or cuda, not {x.device}")
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


class FusedDilatedUnit(torch.autograd.Function):
    """The unit under autograd: `_fwd` / `_bwd` of the JAX package's
    `custom_vjp`. Forward: `_forward` (the kernel on a CUDA tensor), saving
    only the inputs. Backward: the plain formulation recomputed in the
    inputs' dtype and differentiated, for the inputs that need a gradient."""

    @staticmethod
    def forward(ctx, x, w1, w2, dilation: int, pad_left: int, pad_right: int):
        ctx.save_for_backward(x, w1, w2)
        ctx.conv = (dilation, pad_left, pad_right)
        return _forward(x, w1, w2, dilation, pad_left, pad_right)

    @staticmethod
    def backward(ctx, grad_y):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n) for t, n in zip(saved, needs)]
            y = fused_dilated_unit_reference(*inputs, *ctx.conv)
            wanted = [t for t, n in zip(inputs, needs) if n]
            grads = iter(torch.autograd.grad(y, wanted, grad_y))
        return (*(next(grads) if n else None for n in needs), None, None, None)


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
