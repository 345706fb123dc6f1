"""STFT and multiscale magnitude spectrograms for the reconstruction loss.

PyTorch port of the FFT path of rave_tpu/ops/stft.py:23-207 (the
torchaudio `Spectrogram(power=None)` semantics of the reference): a
periodic Hann window, centering by reflect padding of n_fft // 2 on both
sides, frames of n_fft every `hop` samples, one batched `torch.fft.rfft`,
and an optional division by the window's L2 norm. `torch.stft` is not used
because its `normalized` divides by sqrt(n_fft), not by the window's norm.
`frame_signal` is rave_tpu/ops/stft.py:28 (overlapping frames, no
padding). `mel_filterbank` (numpy, the same as rave_tpu/ops/stft.py:158)
serves the losses' mel projections (`MultiScaleSTFT.num_mels`,
ops/distances.py), the Fréchet mel distance of train/evaluate.py and the
mel input front-end (models/rave.py::MelAnalysis).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window (`torch.hann_window` default)."""
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def on_device(make, args: tuple, device: torch.device, dtype: Optional[torch.dtype] = None):
    """`torch.from_numpy(make(*args))` on `device` (in `dtype`), made once per
    (make, args, device, dtype): a step that made its constants anew would
    copy them from the host at every call, which a CUDA graph cannot hold
    (train/graphs.py). Never evicted: a captured graph reads the tensor by
    its address, and a replay runs no Python that would keep an entry in a
    bounded cache (the keys are few: windows, filterbanks and reflect
    indices of the shapes a process runs). Made outside inference mode, so
    that a first call under it (validation) gives a tensor that training can
    use. Read-only."""
    with torch.inference_mode(False):
        return torch.from_numpy(make(*args)).to(device=device, dtype=dtype)


def _reflect_index(length: int, pad: int) -> np.ndarray:
    return np.pad(np.arange(length), pad, mode="reflect")


def frame_signal(x: torch.Tensor, frame_length: int, hop: int) -> torch.Tensor:
    """[..., T] -> [..., frames, frame_length] overlapping frames every `hop`
    samples, no padding: (T - frame_length) // hop + 1 frames."""
    return x.unfold(-1, frame_length, hop)


def stft(x: torch.Tensor, n_fft: int, hop: int, *, center: bool = True,
         normalized: bool = False) -> torch.Tensor:
    """Complex STFT of [B, T] -> [B, frames, n_fft // 2 + 1]. Centering
    reflect-pads n_fft // 2 on each side; a pad as long as the signal or
    longer reflects again from the ends, as `jnp.pad(mode="reflect")` does
    (torch's reflect pad refuses it). Inputs other than float32
    and float64 (bf16 critic inputs under `train.bf16_dis`) are upcast to
    float32 first, as rave_tpu/ops/stft.py:100-103 does: the FFT takes
    neither bf16 nor fp16."""
    if x.dtype not in (torch.float32, torch.float64):
        x = x.float()
    if center and n_fft // 2 >= x.shape[-1]:  # numpy's repeated reflection, by index
        x = x[..., on_device(_reflect_index, (x.shape[-1], n_fft // 2), x.device)]
    elif center:
        x = F.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    win = on_device(hann_window, (n_fft,), x.device, x.dtype)
    spec = torch.fft.rfft(frame_signal(x, n_fft, hop) * win, dim=-1)
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


def _hz_to_mel(f: np.ndarray) -> np.ndarray:
    """Slaney mel scale (librosa default, htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = f >= min_log_hz
    return np.where(log_t, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep,
                    mels)


def _mel_to_hz(m: np.ndarray) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_t = m >= min_log_mel
    return np.where(log_t, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank [n_mels, n_fft//2+1]
    (librosa.filters.mel parity; reference: rave/core.py:255-266)."""
    fmax = sample_rate / 2.0
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0, fmax, n_bins)
    mel_pts = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


@dataclass(frozen=True)
class MultiScaleSTFT:
    """Spectrograms at each of `scales` (hop = scale // 4, centered) of a
    [B, C, T] signal (or [B, T]), rows b * C + c (rave_tpu/ops/stft.py:176-207,
    reference rave/core.py:269-319): magnitudes [B*C, bins, frames], or
    with `magnitude=False` the complex spectrum as [B*C, bins, frames, 2]
    (real, imag). With `num_mels` the complex spectrum is projected on the
    mel filterbank before the magnitude, the reference's order ([B*C,
    num_mels, frames]); the real and imaginary parts are projected apart,
    which is the same sum (`torch` matmuls take no complex by real)."""

    scales: Tuple[int, ...]
    sample_rate: int
    magnitude: bool = True
    normalized: bool = False
    num_mels: Optional[int] = None

    def __call__(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.reshape(-1, x.shape[-1])
        outs = []
        for scale in self.scales:
            s = stft(x, scale, scale // 4, normalized=self.normalized).transpose(-1, -2)
            if self.num_mels is not None:
                mel = on_device(mel_filterbank, (self.sample_rate, scale, self.num_mels),
                                s.device, s.real.dtype)
                s = torch.complex(mel @ s.real, mel @ s.imag)
            outs.append(s.abs() if self.magnitude else torch.stack([s.real, s.imag], -1))
        return outs
