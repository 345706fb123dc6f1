"""Streaming state for dual-mode modules, and helpers to run them in chunks.

Every module that carries left context between streaming steps derives
from `StreamingModule` and declares each piece of state with
`add_stream_state`. The state is a non-persistent buffer: it follows the
module's device and dtype under `.to()`, stays out of `state_dict`, and
`init_stream_state(module, batch)` zeroes it for a given batch size, in
place where the buffer already has that size (a CUDA graph of the step
keeps reading the same addresses: nn/graphs.py).

The contract (the port of rave_tpu/nn/streaming.py, tested against the
JAX package): for a module with cumulative delay D (output-rate samples),

    stream(x chunked)[..., D:]  ==  offline(x)[..., :-D]

exactly in 'causal' mode (D == 0), within float tolerance in 'centered'.
"""
from __future__ import annotations

import warnings
from typing import Dict, Tuple

import torch
from torch import nn


class StreamingModule(nn.Module):
    """A module with `[batch, channels, length]` streaming state buffers."""

    def __init__(self):
        super().__init__()
        self._stream_shapes: Dict[str, Tuple[int, int]] = {}

    def add_stream_state(self, name: str, channels: int, length: int, batch: int) -> None:
        self._stream_shapes[name] = (channels, length)
        self.register_buffer(name, torch.zeros(batch, channels, length), persistent=False)

    def reset_stream(self, batch: int) -> None:
        for name, (channels, length) in self._stream_shapes.items():
            old = getattr(self, name)
            if old.shape == (batch, channels, length) and _writable(old):
                with torch.no_grad():
                    old.zero_()
            else:
                setattr(
                    self, name,
                    torch.zeros(batch, channels, length, dtype=old.dtype, device=old.device),
                )


def _writable(t: torch.Tensor) -> bool:
    """Whether `t` may be zeroed in place here: no gradient through it, and
    not an inference tensor outside inference mode."""
    return not t.requires_grad and (not t.is_inference() or torch.is_inference_mode_enabled())


def as_dtype(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`t` in `dtype`, casting only when it is not: a streaming step's
    exported program then holds no cast node (and no check of it) for the
    fp32 weights and state of an fp32 model, a third of its nodes in v3's."""
    return t if t.dtype == dtype else t.to(dtype)


def static_shape(t: torch.Tensor) -> Tuple[int, ...]:
    """`t.shape` as Python ints, also under `torch.jit.trace`, which gives
    sizes as traced tensors: a traced step program holds its example's
    shapes (export.py traces one program per block shape), so a size that
    Python reads there is a constant of that program, as it is of the
    `.pt2`."""
    if not torch.jit.is_tracing():
        return tuple(t.shape)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", torch.jit.TracerWarning)
        return tuple(int(d) for d in t.shape)


def static_size(t: torch.Tensor, dim: int) -> int:
    """`static_shape(t)[dim]`."""
    return static_shape(t)[dim]


def init_stream_state(module: nn.Module, batch: int) -> None:
    """Zero every streaming state under `module` for `batch` streams."""
    for m in module.modules():
        if isinstance(m, StreamingModule):
            m.reset_stream(batch)


def stream_chunks(module: nn.Module, x: torch.Tensor, chunk: int) -> torch.Tensor:
    """Feed `x [B, C, T]` through `module.step` in chunks of `chunk` frames,
    carrying the module's stream state; returns the concatenation."""
    outs = [module.step(x[..., i : i + chunk]) for i in range(0, x.shape[-1], chunk)]
    return torch.cat(outs, dim=-1)
