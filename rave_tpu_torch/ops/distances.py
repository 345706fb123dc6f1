"""The reconstruction distances over multiscale spectrograms and waveforms.

PyTorch port of rave_tpu/ops/distances.py:19-158 (reference
rave/core.py:322-490): `AudioDistanceV1` (v2's distance, mel or not), the
amplitude plus instantaneous-frequency distance on complex STFTs
(`distance.kind = "instantaneous"`), the waveform and single-resolution
spectral distances, and the Encodec-style sum of both (`"encodec"`). Each
returns the JAX package's dict keys; the training step, the validation
and `evaluate` sum whatever comes back. Signals are [B, C, T] (or [B, T]);
every distance reduces to means, so the port's layout gives the values of
the JAX package's channels-last one.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from rave_tpu_torch.ops.dsp import mean_difference
from rave_tpu_torch.ops.stft import MultiScaleSTFT, mel_filterbank, on_device, spectrogram


@dataclass(frozen=True)
class AudioDistanceV1:
    """Relative-L2 linear plus L1 log spectral distance, summed over scales."""

    multiscale_stft: MultiScaleSTFT
    log_epsilon: float = 1e-7

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> dict:
        distance = 0.0
        for a, b in zip(self.multiscale_stft(x), self.multiscale_stft(y)):
            lin = mean_difference(a, b, norm="L2", relative=True)
            log = mean_difference(torch.log(a + self.log_epsilon),
                                  torch.log(b + self.log_epsilon), norm="L1")
            distance = distance + lin + log
        return {"spectral_distance": distance}


def _unwrap_if(phase: torch.Tensor) -> torch.Tensor:
    """Phase -> instantaneous frequency along the frames (reference
    rave/core.py:356-368): the wrapped phase difference by floor-mod, as
    Python's and JAX's `%` on floats (`torch.remainder`, not `fmod`)."""
    d = phase[..., 1:] - phase[..., :-1]
    d = torch.remainder(d + math.pi, 2 * math.pi) - math.pi
    unwrapped = torch.cumsum(d, dim=-1)
    return unwrapped[..., 1:] - unwrapped[..., :-1]


class _Angle(torch.autograd.Function):
    """arg(re + i im) = atan2(im, re), differentiated by JAX's rule for it:
    (re d(im) - im d(re)) / (re^2 + im^2). At an exactly zero bin that is
    0 / 0, NaN, as rave_tpu's `jnp.angle` gradient is there (torch's own
    `angle` and `atan2` give 0): ROADMAP C19."""

    @staticmethod
    def forward(ctx, re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(re, im)
        return torch.atan2(im, re)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        re, im = ctx.saved_tensors
        den = re * re + im * im
        return -grad * im / den, grad * re / den


@dataclass(frozen=True)
class WeightedInstantaneousSpectralDistance:
    """Amplitude plus instantaneous-frequency distance on complex STFTs
    (reference rave/core.py:347-412); `multiscale_stft` has
    `magnitude=False`. `weighted` masks the frequencies by clip(log1p|x|,
    0, 1) of the target, which damps near-silent bins."""

    multiscale_stft: MultiScaleSTFT
    weighted: bool = False

    def __call__(self, target: torch.Tensor, pred: torch.Tensor) -> dict:
        spectral = phase = 0.0
        for a, b in zip(self.multiscale_stft(target), self.multiscale_stft(pred)):
            xa = torch.complex(a[..., 0], a[..., 1]).abs()
            yb = torch.complex(b[..., 0], b[..., 1]).abs()
            spectral = (spectral + mean_difference(xa, yb, norm="L2", relative=True)
                        + mean_difference(torch.log1p(xa), torch.log1p(yb), norm="L1"))
            fa = _unwrap_if(_Angle.apply(a[..., 0], a[..., 1]))
            fb = _unwrap_if(_Angle.apply(b[..., 0], b[..., 1]))
            if self.weighted:
                mask = torch.clamp(torch.log1p(xa[..., 2:]), 0, 1)
                fa, fb = fa * mask, fb * mask
            phase = phase + mean_difference(fa, fb, norm="L2")
        return {"spectral_distance": spectral, "phase_distance": phase}


@dataclass(frozen=True)
class WaveformDistance:
    """Mean L1 or L2 sample distance (reference rave/core.py:436-443)."""

    norm: str = "L1"

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return mean_difference(y, x, self.norm)


@dataclass(frozen=True)
class SpectralDistance:
    """Single-resolution magnitude (or mel) spectrogram distance, summed
    over `norm` (reference rave/core.py:446-490): frames of `n_fft` every
    n_fft // 4 samples, not centered; the mel filterbank projects the
    magnitude; `power` 2 squares it."""

    n_fft: int
    sampling_rate: int
    norm: Tuple[str, ...] = ("L1",)
    power: Optional[float] = 1.0
    normalized: bool = True
    mel: Optional[int] = None

    def _spec(self, x: torch.Tensor) -> torch.Tensor:
        mag = spectrogram(x.reshape(-1, x.shape[-1]), self.n_fft, self.n_fft // 4, power=None,
                          center=False, normalized=self.normalized).abs()
        if self.mel is not None:
            fb = on_device(mel_filterbank, (self.sampling_rate, self.n_fft, self.mel),
                           mag.device, mag.dtype)
            mag = mag @ fb.T
        return mag ** 2 if self.power == 2.0 else mag

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        sx, sy = self._spec(x), self._spec(y)
        d = 0.0
        for n in self.norm:
            d = d + mean_difference(sy, sx, n)
        return d


@dataclass(frozen=True)
class EncodecAudioDistance:
    """L1 waveform distance plus L1 + L2 spectral distances at each scale
    (reference rave/core.py:415-433), mel at `n_mels[i]` when given."""

    scales: Tuple[int, ...]
    sampling_rate: int
    n_mels: Tuple[int, ...] = ()

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> dict:
        spec = 0.0
        for i, scale in enumerate(self.scales):
            spec = spec + SpectralDistance(
                n_fft=scale, sampling_rate=self.sampling_rate, norm=("L1", "L2"),
                mel=self.n_mels[i] if self.n_mels else None)(x, y)
        return {"waveform_distance": WaveformDistance("L1")(x, y), "spectral_distance": spec}
