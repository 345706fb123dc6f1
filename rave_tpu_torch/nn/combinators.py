"""Delay-aware combinators: Lambda, StreamDelay, Sequential, Residual, AlignBranches.

PyTorch port of rave_tpu/nn/combinators.py. Builders thread `in_delay`
through child constructors; these combinators apply the children and, in
streaming mode, delay the identity branch of a residual so both branches
stay aligned, and delay parallel branches to a common output delay.
Attribute names (`layers.N`, `inner`, `branches.N`) mirror the flax
module paths (`layers_N`, `inner`, `branches_N`) so weights map by rename.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn

from rave_tpu_torch.nn.streaming import StreamingModule, as_dtype


class Lambda(nn.Module):
    """Stateless pointwise op usable in both modes (delay-transparent)."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor]):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)

    def step(self, x):
        return self.fn(x)


class StreamDelay(StreamingModule):
    """Pure delay line of `d` frames, active only on the streaming path."""

    def __init__(self, d: int, features: int, stream_batch: int = 1):
        super().__init__()
        self.d = d
        if d > 0:
            self.add_stream_state("buf", features, d, stream_batch)

    def forward(self, x):
        return x

    def step(self, x):
        if self.d == 0:
            return x
        ext = torch.cat([as_dtype(self.buf, x.dtype), x], dim=-1)
        self.buf = ext[..., ext.shape[-1] - self.d :]
        return ext[..., : x.shape[-1]]


class Sequential(nn.Module):
    """Applies children in order in both modes."""

    def __init__(self, layers: Sequence[nn.Module]):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x

    def step(self, x):
        for layer in self.layers:
            x = layer.step(x)
        return x


class Residual(nn.Module):
    """x + inner(x), with the identity branch delay-matched when streaming.

    `inner_delay` is inner's *own* delay (built with in_delay=0).
    """

    def __init__(self, inner: nn.Module, inner_delay: int, features: int,
                 stream_batch: int = 1):
        super().__init__()
        self.inner = inner
        self.inner_delay = inner_delay
        self.skip_delay = StreamDelay(inner_delay, features, stream_batch)

    def forward(self, x):
        return x + self.inner(x)

    def step(self, x):
        return self.skip_delay.step(x) + self.inner.step(x)


class AlignBranches(nn.Module):
    """Runs `branches` on one input; when streaming, delays branch i's output
    by max(delays) - delays[i] frames so that all are aligned at max(delays)
    (rave_tpu/nn/combinators.py:124-154). `features[i]` is branch i's
    output channels."""

    def __init__(self, branches: Sequence[nn.Module], delays: Sequence[int],
                 features: Sequence[int], stream_batch: int = 1):
        super().__init__()
        self.branches = nn.ModuleList(branches)
        self.delays = tuple(delays)
        m = max(self.delays)
        self.compensation = nn.ModuleList(
            StreamDelay(m - d, f, stream_batch) for d, f in zip(self.delays, features))

    def forward(self, x, *args):
        """Each branch on x; `args` go to the last branch only (a noise
        synth's draws)."""
        last = len(self.branches) - 1
        return tuple(b(x, *args) if i == last else b(x) for i, b in enumerate(self.branches))

    def step(self, x, *args):
        last = len(self.branches) - 1
        return tuple(c.step(b.step(x, *args) if i == last else b.step(x))
                     for i, (b, c) in enumerate(zip(self.branches, self.compensation)))
