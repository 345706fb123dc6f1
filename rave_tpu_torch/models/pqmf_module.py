"""PQMF as a dual-mode module (offline and streaming analysis/synthesis).

PyTorch port of rave_tpu/models/pqmf_module.py, channels-first: both
directions are stride-1 convolutions at the decimated rate over the
constant polyphase kernels of `PQMFBank`, with the same left-context cache
as nn/conv.py when streaming.

  PQMFAnalysis  : waveform [B, C, T]        -> band frames [B, C*M, T//M]
  PQMFSynthesis : band frames [B, C*M, F]   -> waveform [B, C, F*M]

Band channel `c*M + m` is band m of audio channel c, as in the JAX
package's channels-last `[B, F, C*M]`.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from rave_tpu_torch.nn.streaming import StreamingModule
from rave_tpu_torch.ops.pqmf import PQMFBank, reverse_half


class _PQMFModule(StreamingModule):
    def __init__(self, bank: PQMFBank, n_channels: int, mode: str, stream_batch: int,
                 weight: torch.Tensor | None):
        super().__init__()
        self.bank, self.n_channels, self.mode = bank, n_channels, mode
        self.M = bank.n_band
        if weight is not None:
            self.register_buffer("weight", weight, persistent=False)
        if sum(self.pad) > 0:
            self.add_stream_state("cache", n_channels * self.M, sum(self.pad), stream_batch)

    @property
    def pad(self) -> Tuple[int, int]:
        raise NotImplementedError

    def _conv(self, frames: torch.Tensor, pad: Tuple[int, int]) -> torch.Tensor:
        return F.conv1d(F.pad(frames, pad), self.weight.to(frames.dtype))

    def _cached(self, frames: torch.Tensor) -> torch.Tensor:
        """Prepend the cached left context to frames [B*C, M, F] and keep
        the new tail; the state is [B, C*M, n] per stream."""
        n = sum(self.pad)
        if n == 0:
            return frames
        BC, M, F_ = frames.shape
        merged = frames.reshape(BC // self.n_channels, self.n_channels * M, F_)
        ext = torch.cat([self.cache.to(frames.dtype), merged], dim=-1)
        self.cache = ext[..., ext.shape[-1] - n :]
        return ext.reshape(BC, M, ext.shape[-1])


class PQMFAnalysis(_PQMFModule):
    """[B, C, T] waveform -> [B, C*M, T//M] band frames."""

    def __init__(self, bank: PQMFBank, n_channels: int = 1, mode: str = "centered",
                 stream_batch: int = 1):
        weight = bank.analysis_weight() if bank.n_band > 1 else None
        super().__init__(bank, n_channels, mode, stream_batch, weight)

    @property
    def pad(self) -> Tuple[int, int]:
        Q = self.bank.taps
        if Q == 0:
            return (0, 0)
        return (Q // 2, (Q - 1) - Q // 2) if self.mode == "centered" else (Q - 1, 0)

    @property
    def delay(self) -> int:
        """Streaming delay in output frames."""
        return self.pad[1]

    def _frames(self, x: torch.Tensor) -> torch.Tensor:
        # [B, C, T] -> [B*C, M phases, T//M]
        B, C, T = x.shape
        return x.reshape(B * C, T // self.M, self.M).transpose(1, 2)

    def _merge(self, z: torch.Tensor, B: int) -> torch.Tensor:
        # [B*C, M bands, F] -> [B, C*M, F]
        return z.reshape(B, self.n_channels * self.M, z.shape[-1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.M == 1:
            return x
        z = reverse_half(self._conv(self._frames(x), self.pad))
        return self._merge(z, x.shape[0])

    def step(self, x: torch.Tensor) -> torch.Tensor:
        if self.M == 1:
            return x
        ext = self._cached(self._frames(x))
        # the stream lags the offline timeline by `delay` frames; the
        # alternating sign tracks the offline frame parity
        z = reverse_half(self._conv(ext, (0, 0)), self.delay % 2)
        return self._merge(z, x.shape[0])


class PQMFSynthesis(_PQMFModule):
    """[B, C*M, F] band frames -> [B, C, F*M] waveform.

    `in_delay` is the band-frame stream's cumulative delay (frames).
    """

    def __init__(self, bank: PQMFBank, n_channels: int = 1, mode: str = "centered",
                 in_delay: int = 0, stream_batch: int = 1):
        weight = bank.synthesis_weight() if bank.n_band > 1 else None
        super().__init__(bank, n_channels, mode, stream_batch, weight)
        self.in_delay = in_delay

    @property
    def pad(self) -> Tuple[int, int]:
        Q = self.bank.taps
        if Q == 0:
            return (0, 0)
        return ((Q - 1) - Q // 2, Q // 2) if self.mode == "centered" else (Q - 1, 0)

    @property
    def delay(self) -> int:
        """Streaming delay in output waveform samples."""
        return (self.in_delay + self.pad[1]) * self.M

    def _split(self, z: torch.Tensor) -> torch.Tensor:
        # [B, C*M, F] -> [B*C, M, F]
        B, _, F_ = z.shape
        return z.reshape(B * self.n_channels, self.M, F_)

    def _merge(self, y: torch.Tensor, B: int) -> torch.Tensor:
        # [B*C, M phases, F] -> [B, C, F*M]
        F_ = y.shape[-1]
        return y.transpose(1, 2).reshape(B, self.n_channels, F_ * self.M)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        if self.M == 1:
            return z
        return self._merge(self._conv(reverse_half(self._split(z)), self.pad), z.shape[0])

    def step(self, z: torch.Tensor) -> torch.Tensor:
        # reverse_half alternates with absolute frame parity, so it is applied
        # chunk-locally before caching (chunks hold an even number of frames,
        # which block_size() guarantees), offset by the incoming stream's lag
        if self.M == 1:
            return z
        ext = self._cached(reverse_half(self._split(z), self.in_delay % 2))
        return self._merge(self._conv(ext, (0, 0)), z.shape[0])
