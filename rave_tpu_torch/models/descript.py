"""The descript-audio-codec critic of v3: period (MPD), scale (MSD) and
multi-band STFT (MRD) critics.

PyTorch port of rave_tpu/models/descript.py (reference
rave/descript_discriminator.py), channels-first. Every conv is a
weight-normed `WNConv` (models/discriminators.py) with LeakyReLU(0.1)
between them; each critic returns its per-layer feature maps, the last one
the score. Module names mirror the flax paths (`mpd_2.conv_0`,
`mrd_2048.band3_conv4`), so utils/convert.py maps the weights by rename.

  * `MPD`: the signal reflect-padded to a multiple of the period and
    folded by it, [B, C, T/p, p] (t = n*p + j). Its (5, 1) and (3, 1)
    kernels never mix the period axis, so they are stored as 1D kernels and,
    folded (the default, the JAX `_fold_apply`), the period axis goes into
    the batch (row b*p + j) and the stack runs as 1D convolutions;
    `fold=False` runs them as true 2D convolutions, the oracle.
  * `MSD`: grouped 1D convs after a kaiser anti-aliased downsampling by
    `scale`; v3 builds none (the factory passes no rates, as the JAX one).
  * `MRD`: the fp32 complex STFT of each channel, real and imaginary parts
    as 2C image channels [B, 2C, frames, bins], cut into five frequency
    bands, each a stack of 32-channel 2D convs (cuDNN `conv2d` per band);
    the bands are concatenated along frequency into a (3, 3) `post` conv.
    The stack runs in the caller's dtype (`train.bf16_dis`). The JAX
    package's frequency-packed layout (rave_tpu/ops/packed_conv.py) is a
    TPU rewrite of these same convolutions and is not ported; its
    `packed_fmaps` only changes which copy of the maps a count-invariant
    distance reads, so the per-band maps give the same loss.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rave_tpu_torch.models.discriminators import Features, WNConv
from rave_tpu_torch.ops.pqmf import kaiser_filter
from rave_tpu_torch.ops.stft import stft

BANDS = ((0.0, 0.1), (0.1, 0.25), (0.25, 0.5), (0.5, 0.75), (0.75, 1.0))
# (kernel, stride, padding) of each band's layers (rave_tpu/models/descript.py:126-132)
MRD_SPEC = (((3, 9), (1, 1), (1, 4)), ((3, 9), (1, 2), (1, 4)), ((3, 9), (1, 2), (1, 4)),
            ((3, 9), (1, 2), (1, 4)), ((3, 3), (1, 1), (1, 1)))
# (channels, kernel, stride, groups, padding) of the MSD layers (:102-109)
MSD_SPEC = ((16, 15, 1, 1, 7), (64, 41, 4, 4, 20), (256, 41, 4, 16, 20), (1024, 41, 4, 64, 20),
            (1024, 41, 4, 256, 20), (1024, 5, 1, 1, 2))
MPD_CHANNELS = (32, 128, 512, 1024, 1024)


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.1)


class MPD(nn.Module):
    """Period-folded critic (rave_tpu/models/descript.py:38-80): five (5, 1)
    convs, stride 3 four times then 1, and a (3, 1) `post`."""

    def __init__(self, n_channels: int, period: int, fold: bool = True):
        super().__init__()
        self.period, self.fold = period, fold
        ch = n_channels
        for i, c in enumerate(MPD_CHANNELS):
            self.add_module(f"conv_{i}", WNConv(ch, c, 5, 3 if i < 4 else 1, 2))
            ch = c
        self.post = WNConv(ch, 1, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        B, C, T = x.shape
        p = self.period
        if T % p:
            x = F.pad(x, (0, p - T % p), mode="reflect")
        x = x.reshape(B, C, -1, p)
        if self.fold:
            x = x.permute(0, 3, 1, 2).reshape(B * p, C, -1)
        fmap = []
        for conv in self.children():
            if fmap:
                x = _leaky(fmap[-1])
            fmap.append(conv(x) if self.fold else conv.forward_2d(x))
        return fmap


class MSD(nn.Module):
    """Grouped 1D critic after a kaiser anti-aliased downsampling by `scale`
    (rave_tpu/models/descript.py:83-123)."""

    def __init__(self, n_channels: int, scale: int = 1):
        super().__init__()
        self.scale = scale
        if scale != 1:
            filt = kaiser_filter(np.pi / scale, 140)
            if not len(filt) % 2:
                filt = np.pad(filt, (1, 0))
            self.register_buffer("filt", torch.from_numpy(filt.astype(np.float32)),
                                 persistent=False)
        ch = n_channels
        for i, (c, k, s, g, pad) in enumerate(MSD_SPEC):
            self.add_module(f"conv_{i}", WNConv(ch, c, k, s, pad, groups=g))
            ch = c
        self.post = WNConv(ch, 1, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        if self.scale != 1:
            C, K = x.shape[1], self.filt.numel()
            w = self.filt.to(x.dtype).expand(C, 1, K)
            x = F.conv1d(x, w, stride=self.scale, padding=K // 2, groups=C)
        fmap = []
        for conv in self.children():
            if fmap:
                x = _leaky(fmap[-1])
            fmap.append(conv(x))
        return fmap


class MRD(nn.Module):
    """Multi-band STFT critic (rave_tpu/models/descript.py:135-213), per band:
    hop a quarter of the window, the five `BANDS`, as the JAX critic's
    defaults, which no caller changes."""

    def __init__(self, n_channels: int, window_length: int):
        super().__init__()
        self.window_length, self.hop = window_length, window_length // 4
        n_bins = window_length // 2 + 1
        self.bands = [(int(a * n_bins), int(b * n_bins)) for a, b in BANDS]
        for bi in range(len(self.bands)):
            ch = 2 * n_channels
            for li, (k, s, pad) in enumerate(MRD_SPEC):
                self.add_module(f"band{bi}_conv{li}", WNConv(ch, 32, k, s, pad))
                ch = 32
        self.post = WNConv(32, 1, (3, 3), 1, 1)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        B, C, T = x.shape
        s = stft(x.reshape(B * C, T), self.window_length, self.hop)  # fp32 [B*C, frames, bins]
        s = s.reshape(B, C, *s.shape[1:])
        img = torch.cat([s.real, s.imag], dim=1).to(x.dtype)  # [B, 2C, frames, bins]
        convs = dict(self.named_children())
        fmap, outs = [], []
        for bi, (lo, hi) in enumerate(self.bands):
            band = img[..., lo:hi]
            for li in range(len(MRD_SPEC)):
                band = convs[f"band{bi}_conv{li}"](band)
                fmap.append(band)
                band = _leaky(band)
            outs.append(band)
        fmap.append(self.post(torch.cat(outs, dim=-1)))
        return fmap


class DescriptDiscriminator(nn.Module):
    """MPDs, MSDs and MRDs after removing each example's and channel's mean
    and normalizing its peak to 0.8 (rave_tpu/models/descript.py:216-242)."""

    def __init__(self, n_channels: int = 1, periods: Sequence[int] = (2, 3, 5, 7, 11),
                 rates: Sequence[int] = (), fft_sizes: Sequence[int] = (2048, 1024, 512)):
        super().__init__()
        for p in periods:
            self.add_module(f"mpd_{p}", MPD(n_channels, p))
        for r in rates:
            self.add_module(f"msd_{r}", MSD(n_channels, r))
        for f in fft_sizes:
            self.add_module(f"mrd_{f}", MRD(n_channels, f))

    def forward(self, x: torch.Tensor) -> Features:
        x = x - x.mean(-1, keepdim=True)
        x = 0.8 * x / (x.abs().amax(-1, keepdim=True) + 1e-9)
        return [critic(x) for critic in self.children()]
