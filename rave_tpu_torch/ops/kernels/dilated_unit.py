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
variants, chosen by dtype: float32 (3xTF32 tensor-core products, fp32
accuracy) and bfloat16 (`train.bf16`: bf16 tensor-core products with fp32
accumulation). x, w1 and w2 must share the dtype. `launches` counts the
kernel's (forward) launches of either variant and `launches_bf16` those of
the bf16 one, so a run can show that its main path went through them.

The gradient mirrors the JAX package's `custom_vjp` (`_fwd` / `_bwd`):
when autograd needs it, the forward runs inside `FusedDilatedUnit`, an
`autograd.Function` that saves only `x, w1, w2`; its backward recomputes
the plain formulation and differentiates it with `torch.autograd.grad`,
as `_bwd` differentiates `_reference_impl` with XLA. The TPU kernel has no
backward kernel, so neither has this one (ROADMAP A16 keeps a fused CUDA
backward as a later item).
"""
from __future__ import annotations

import ctypes
import functools

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
    lib.dilated_unit_tile.argtypes = [ctypes.c_int] * 3
    lib.dilated_unit_tile.restype = ctypes.c_int
    lib.dilated_unit_forward.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    )
    lib.dilated_unit_forward.restype = ctypes.c_int
    lib.dilated_unit_bf16_tile.argtypes = [ctypes.c_int] * 5
    lib.dilated_unit_bf16_tile.restype = ctypes.c_int
    lib.dilated_unit_forward_bf16.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    )
    lib.dilated_unit_forward_bf16.restype = ctypes.c_int
    return lib


@functools.cache
def kernel_tile(C: int, K: int, dilation: int, device_index: int = 0) -> int:
    """Frames per block the fp32 kernel uses for this shape on this card (0:
    refused). It depends only on the shape and the card, so it is asked of
    the library once."""
    with torch.cuda.device(device_index):
        return _lib().dilated_unit_tile(C, K, dilation)


@functools.cache
def kernel_tile_bf16(B: int, C: int, T: int, K: int, dilation: int,
                     device_index: int = 0) -> int:
    """Frames per block the bf16 kernel uses (0: refused). Its tile also
    depends on how many blocks the grid has (B and T), so it is asked of the
    library once per shape."""
    with torch.cuda.device(device_index):
        return _lib().dilated_unit_bf16_tile(B, C, T, K, dilation)


def _check(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor,
           dilation: int, pad_left: int, pad_right: int) -> None:
    if x.dim() != 3 or w1.dim() != 3 or w2.dim() != 2:
        raise ValueError(f"expected x [B,C,T], w1 [C,C,K], w2 [C,C]; got "
                         f"{tuple(x.shape)}, {tuple(w1.shape)}, {tuple(w2.shape)}")
    C, K = x.shape[1], w1.shape[2]
    if tuple(w1.shape[:2]) != (C, C) or tuple(w2.shape) != (C, C):
        raise ValueError(f"weights {tuple(w1.shape)}, {tuple(w2.shape)} do not match C={C}")
    if dilation < 1 or pad_left < 0 or pad_right < 0 or pad_left + pad_right != dilation * (K - 1):
        raise ValueError(f"'same' output needs pad_left + pad_right == dilation*(K-1); got "
                         f"d={dilation}, pads=({pad_left}, {pad_right}), K={K}")
    if x.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the CUDA kernel takes float32 or bfloat16; x is {x.dtype}")
    for name, t in (("x", x), ("w1", w1), ("w2", w2)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if t.dtype != x.dtype:
            raise TypeError(f"x, w1 and w2 must share a dtype; x is {x.dtype}, {name} {t.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    step = 16 if x.dtype == torch.bfloat16 else 8  # the depth of one tensor-core product
    if C % step:
        raise ValueError(f"the {x.dtype} kernel takes C % {step} == 0 (whole k{step} "
                         f"tensor-core steps); C={C}")


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
    if bf16:
        tile = kernel_tile_bf16(B, C, T, K, dilation, x.device.index)
    else:
        tile = kernel_tile(C, K, dilation, x.device.index)
    if tile == 0:
        raise ValueError(f"C={C}, K={K}, d={dilation} needs more shared memory than a "
                         f"block can have")
    lib = _lib()
    with torch.cuda.device(x.device):
        if bf16:  # the B operands channel-in fastest: [K, C_out, C_in], [C_out, C_in]
            launch, w1k, w2k = lib.dilated_unit_forward_bf16, w1.permute(2, 0, 1), w2
        else:     # [K, C_in, C_out], [C_in, C_out]
            launch, w1k, w2k = lib.dilated_unit_forward, w1.permute(2, 1, 0), w2.t()
        w1k, w2k = w1k.contiguous(), w2k.contiguous()
        y = torch.empty_like(x)
        err = launch(
            x.data_ptr(), w1k.data_ptr(), w2k.data_ptr(), y.data_ptr(),
            B, C, T, K, dilation, pad_left, tile,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"dilated_unit kernel launch failed: cudaError {err}")
    global launches, launches_bf16
    launches += 1
    launches_bf16 += bf16
    return y


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
