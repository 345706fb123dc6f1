"""Pseudo-QMF multiband analysis/synthesis (PyTorch port of rave_tpu.ops.pqmf).

The filter design is numpy/scipy and identical to the JAX package's
(rave_tpu/ops/pqmf.py:31-131); it is re-implemented here because that
module imports jax. `PQMFBank` keeps the JAX package's `[Q, M, M]` NWC
kernels, so the two packages' banks can be compared directly, and exposes
them as `conv1d` weights for the channels-first runtime.

Conventions (channels-first):
  analyze    : [B, T]        -> [B, M, T//M]
  synthesize : [B, M, T//M]  -> [B, T]
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F
from scipy.optimize import fmin
from scipy.signal import firwin, kaiserord


def kaiser_filter(wc: float, atten: float, N: int | None = None) -> np.ndarray:
    """Kaiser lowpass design; `wc` is angular cutoff. Reference: rave/pqmf.py:55-70."""
    N_, beta = kaiserord(atten, wc / np.pi)
    N_ = 2 * (N_ // 2) + 1
    N = N if N is not None else N_
    return firwin(N, wc, window=("kaiser", beta), scale=False, fs=2 * np.pi)


def _loss_wc(wc: float, atten: float, M: int, N: int | None) -> float:
    """Max of the decimated composite-response ripple (IEEE 681427 objective)."""
    h = kaiser_filter(wc, atten, N)
    g = np.convolve(h, h[::-1], "full")
    g = abs(g[g.shape[-1] // 2 :: 2 * M][1:])
    return np.max(g)


def get_prototype(atten: float, M: int, N: int | None = None) -> np.ndarray:
    """Optimized lowpass prototype for an M-band PQMF. Reference: rave/pqmf.py:83-89."""
    wc = fmin(lambda w: _loss_wc(float(w[0]), atten, M, N), 1 / M, disp=0)[0]
    return kaiser_filter(float(wc), atten, N)


def qmf_bank(h: np.ndarray, n_band: int) -> np.ndarray:
    """Cosine-modulate a prototype into an M-band filterbank [M, L]."""
    k = np.arange(n_band).reshape(-1, 1)
    N = h.shape[-1]
    t = np.arange(-(N // 2), N // 2 + 1)
    p = (-1) ** k * np.pi / 4
    mod = np.cos((2 * k + 1) * np.pi / (2 * n_band) * t + p)
    return 2 * h * mod


def _center_pad_next_pow_2(x: np.ndarray) -> np.ndarray:
    next_2 = 2 ** math.ceil(math.log2(x.shape[-1]))
    pad = next_2 - x.shape[-1]
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad // 2, pad // 2 + pad % 2)])


def reverse_half(x: torch.Tensor, offset: int = 0) -> torch.Tensor:
    """Negate odd bands at even frames, for band frames `[..., M, F]`.

    An involution that turns every band into a proper baseband signal.
    `offset` shifts the frame parity: a stream that lags the offline
    timeline by an odd number of frames passes offset=1 so the signs track
    the *offline* frame parity.
    """
    odd_band = torch.arange(x.shape[-2], device=x.device) % 2 == 1
    even_frame = (torch.arange(x.shape[-1], device=x.device) + offset) % 2 == 0
    return torch.where(odd_band[:, None] & even_frame[None, :], -x, x)


@dataclass(frozen=True)
class PQMFBank:
    """Constant PQMF filterbank.

    `analysis_kernel`  : [Q, M, M] NWC weight (Q taps, in = M polyphase
                         components, out = M bands), as in rave_tpu.
    `synthesis_kernel` : [Q, M, M] NWC weight (in = M bands, out = M
                         polyphase components of the waveform).
    """

    attenuation: int
    n_band: int
    analysis_kernel: np.ndarray = field(repr=False, compare=False, default=None)
    synthesis_kernel: np.ndarray = field(repr=False, compare=False, default=None)

    @staticmethod
    def build(attenuation: int, n_band: int) -> "PQMFBank":
        if n_band == 1:
            return PQMFBank(attenuation, 1, None, None)
        power = math.log2(n_band)
        if power != math.floor(power):
            raise ValueError(f"n_band must be a power of 2, got {n_band}")
        h = get_prototype(attenuation, n_band)
        hk = _center_pad_next_pow_2(qmf_bank(h, n_band))  # [M, L], L = 2^p
        M, L = hk.shape
        Q = L // M
        # W[q, m, k] = hk[k, q*M + m]; the synthesis is the matched filter,
        # flipped in q only (see rave_tpu/ops/pqmf.py:116-125).
        analysis = hk.reshape(M, Q, M).transpose(1, 2, 0)
        synthesis = M * hk.reshape(M, Q, M)[:, ::-1, :].transpose(1, 0, 2)
        return PQMFBank(
            attenuation, n_band, analysis.astype(np.float32), synthesis.astype(np.float32)
        )

    @property
    def taps(self) -> int:
        """Kernel width Q in decimated frames (0 if single band)."""
        return 0 if self.n_band == 1 else self.analysis_kernel.shape[0]

    def analysis_weight(self) -> torch.Tensor:
        """`conv1d` weight [out band k, in phase m, Q]."""
        return torch.from_numpy(np.ascontiguousarray(self.analysis_kernel.transpose(2, 1, 0)))

    def synthesis_weight(self) -> torch.Tensor:
        """`conv1d` weight [out phase m, in band k, Q]."""
        return torch.from_numpy(np.ascontiguousarray(self.synthesis_kernel.transpose(2, 1, 0)))

    # ---- offline (centered) paths; streaming uses models.pqmf_module ------

    def analyze(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T] -> [B, M, T//M] (centered offline path)."""
        if self.n_band == 1:
            return x[:, None, :]
        M, Q = self.n_band, self.taps
        B, T = x.shape
        frames = x.reshape(B, T // M, M).transpose(1, 2)
        frames = F.pad(frames, (Q // 2, (Q - 1) - Q // 2))
        w = self.analysis_weight().to(device=x.device, dtype=x.dtype)
        return reverse_half(F.conv1d(frames, w))

    def synthesize(self, z: torch.Tensor) -> torch.Tensor:
        """[B, M, T//M] -> [B, T] (centered offline path)."""
        if self.n_band == 1:
            return z[:, 0, :]
        M, Q = self.n_band, self.taps
        # zero-delay round trip: analysis_left + synthesis_left pads = Q - 1
        z = F.pad(reverse_half(z), ((Q - 1) - Q // 2, Q // 2))
        w = self.synthesis_weight().to(device=z.device, dtype=z.dtype)
        y = F.conv1d(z, w)  # [B, M phases, F]
        B, _, N = y.shape
        return y.transpose(1, 2).reshape(B, N * M)
