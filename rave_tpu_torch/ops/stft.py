"""STFT and multiscale magnitude spectrograms for the reconstruction loss.

PyTorch port of the FFT path of rave_tpu/ops/stft.py:23-207 (the
torchaudio `Spectrogram(power=None)` semantics of the reference): a
periodic Hann window, centering by reflect padding of n_fft // 2 on both
sides, frames of n_fft every `hop` samples, one batched `torch.fft.rfft`,
and an optional division by the window's L2 norm. `torch.stft` is not used
because its `normalized` divides by sqrt(n_fft), not by the window's norm.
The mel projection is not ported (v2 has `distance.num_mels = None`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window (`torch.hann_window` default)."""
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)).astype(np.float32)


def stft(x: torch.Tensor, n_fft: int, hop: int, *, center: bool = True,
         normalized: bool = False) -> torch.Tensor:
    """Complex STFT of [B, T] -> [B, frames, n_fft // 2 + 1]. Centering
    reflect-pads, which needs T > n_fft // 2. Inputs other than float32
    and float64 (bf16 critic inputs under `train.bf16_dis`) are upcast to
    float32 first, as rave_tpu/ops/stft.py:100-103 does: the FFT takes
    neither bf16 nor fp16."""
    if x.dtype not in (torch.float32, torch.float64):
        x = x.float()
    if center:
        x = F.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    win = torch.from_numpy(hann_window(n_fft)).to(device=x.device, dtype=x.dtype)
    spec = torch.fft.rfft(x.unfold(-1, n_fft, hop) * win, dim=-1)
    if normalized:
        spec = spec / torch.sqrt(torch.sum(win * win))
    return spec


def spectrogram(x: torch.Tensor, n_fft: int, hop: int, *, power: float | None = 1.0,
                center: bool = True, normalized: bool = False) -> torch.Tensor:
    """Magnitude (power=1), power (power=2) or complex (power=None) spectrogram."""
    s = stft(x, n_fft, hop, center=center, normalized=normalized)
    if power is None:
        return s
    mag = s.abs()
    return mag if power == 1.0 else mag ** power


@dataclass(frozen=True)
class MultiScaleSTFT:
    """Magnitude spectrograms [B*C, bins, frames] at each of `scales`
    (hop = scale // 4, centered, not normalized) of a [B, C, T] signal (or
    [B, T])."""

    scales: Tuple[int, ...]

    def __call__(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.reshape(-1, x.shape[-1])
        return [stft(x, scale, scale // 4).abs().transpose(-1, -2) for scale in self.scales]
