"""Integer-ratio kaiser resampler as dual-mode convolutions.

PyTorch port of rave_tpu/ops/resampler.py, channels-first: downsampling
is a strided kaiser lowpass `F.conv1d`; upsampling is polyphase
interpolation (amplitude-scaled by the ratio), one conv with `ratio`
output phases interleaved into the signal. The polyphase kernels are
derived so that the offline path has zero delay (the filter's
linear-phase group delay is absorbed by the padding); streaming carries
left context as nn/conv.py does, in two stream-state buffers.

Layout: `[B, C, T]`; every (batch, channel) row is resampled alone, as a
`[B*C, 1, T]` signal, so the stream state holds `stream_batch *
n_channels` rows.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from rave_tpu_torch.nn.streaming import StreamingModule
from rave_tpu_torch.ops.pqmf import kaiser_filter


@lru_cache(maxsize=8)
def _design(ratio: int):
    """(down_kernel [K,1,1], down_pads, up_kernel [Q,1,ratio], up_pads),
    kernels in the JAX package's WIO layout.

    Down: out[t] = sum_q g[q] x[t*r + q - c]           (zero delay)
    Up:   out[t*r + m] = r * sum_j x[t - j] g[j*r + m + c]
          == correlation kernel w[q, m] = r * g[(pl-q)*r + m + c].
    """
    g = kaiser_filter(np.pi / ratio, 140).astype(np.float64)
    K = len(g)
    c = K // 2
    down = g.astype(np.float32)[:, None, None]
    d_pads = (c, K - 1 - c)

    pl = -(-c // ratio)
    pr = (K - 1 - c) // ratio
    Q = pl + pr + 1
    up = np.zeros((Q, 1, ratio), np.float32)
    for q in range(Q):
        base = (pl - q) * ratio + c
        for m in range(ratio):
            idx = base + m
            if 0 <= idx < K:
                up[q, 0, m] = ratio * g[idx]
    return down, d_pads, up, (pl, pr)


class Resampler(StreamingModule):
    """target_sr = ratio * model_sr; [B, C, T] <-> [B, C, T / ratio]."""

    def __init__(self, target_sr: int, model_sr: int, stream_batch: int = 1,
                 n_channels: int = 1):
        super().__init__()
        self.ratio = target_sr // model_sr
        if self.ratio * model_sr != target_sr or self.ratio <= 1:
            raise ValueError(f"target_sr must be an integer multiple (> 1) of model_sr "
                             f"({target_sr} vs {model_sr})")
        down, self.d_pads, up, self.u_pads = _design(self.ratio)
        # F.conv1d weights [out, in, K]: down [1, 1, K], up [ratio phases, 1, Q]
        self.register_buffer("down_weight", torch.from_numpy(down[:, 0, 0].copy())[None, None],
                             persistent=False)
        self.register_buffer("up_weight", torch.from_numpy(up[:, 0, :].T.copy())[:, None],
                             persistent=False)
        rows = stream_batch * n_channels
        extra = (-self.d_pads[1]) % self.ratio
        self.add_stream_state("down_cache", 1, sum(self.d_pads) + extra, rows)
        self.add_stream_state("up_cache", 1, sum(self.u_pads), rows)

    @property
    def down_delay(self) -> int:
        """Model-rate streaming lag of `to_model_sampling_rate`."""
        pr = self.d_pads[1]
        return (pr + (-pr) % self.ratio) // self.ratio

    @property
    def up_delay(self) -> int:
        """Target-rate streaming lag of `from_model_sampling_rate`."""
        return self.u_pads[1] * self.ratio

    def _cached(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """x with the buffer `name` prepended; the buffer keeps the new tail."""
        cache = getattr(self, name)
        ext = torch.cat([cache.to(x.dtype), x], dim=-1)
        setattr(self, name, ext[..., ext.shape[-1] - cache.shape[-1]:])
        return ext

    def to_model_sampling_rate(self, x: torch.Tensor, streaming: bool = False) -> torch.Tensor:
        """[B, C, T] at target_sr -> [B, C, T / ratio] at model_sr."""
        B, C, T = x.shape
        xf = x.reshape(B * C, 1, T)
        ext = self._cached("down_cache", xf) if streaming else F.pad(xf, self.d_pads)
        y = F.conv1d(ext, self.down_weight.to(x.dtype), stride=self.ratio)
        return y[..., : T // self.ratio].reshape(B, C, -1)

    def from_model_sampling_rate(self, x: torch.Tensor, streaming: bool = False) -> torch.Tensor:
        """[B, C, T] at model_sr -> [B, C, T * ratio] at target_sr."""
        B, C, T = x.shape
        xf = x.reshape(B * C, 1, T)
        ext = self._cached("up_cache", xf) if streaming else F.pad(xf, self.u_pads)
        y = F.conv1d(ext, self.up_weight.to(x.dtype))  # [B*C, ratio phases, T]
        return y.transpose(1, 2).reshape(B, C, T * self.ratio)

    def step_to_model(self, x: torch.Tensor) -> torch.Tensor:
        return self.to_model_sampling_rate(x, streaming=True)

    def step_from_model(self, x: torch.Tensor) -> torch.Tensor:
        return self.from_model_sampling_rate(x, streaming=True)
