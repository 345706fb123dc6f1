"""The adversarial critics: multi-scale, multi-period, spectral and their combination.

PyTorch port of rave_tpu/models/discriminators.py (`WNConv` :22-73, 1D
and 2D, dilated or not, which models/descript.py's critic uses too;
`ConvNet` :76-152, `MultiScaleDiscriminator` :155-179,
`MultiPeriodDiscriminator` :182-226, `MultiScaleSpectralDiscriminator1d`
:229-258, `EncodecConvNet` :261-297, `MultiScaleSpectralDiscriminator`
:300-318, `CombineDiscriminators` :322-335), channels-first. Each
sub-network returns its per-layer feature maps; the last one is the score.
Module names mirror the flax paths (`discriminators_0.period_2_0.WNConv_3`,
`discriminators_1.enc_4096_0.conv_2`), so utils/convert.py maps the
critic's weights by rename as it does the model's.

The spectral critic (`spectral_discriminator`) runs `EncodecConvNet` on
the complex STFT of each scale as an image [B, 2C, bins, frames]: the
channels are the real parts then the imaginary parts (re_0..re_{C-1},
im_0..im_{C-1}), H the bins and W the frames, so its (9, 3) kernels span 9
bins and 3 frames, its strides (2, 1) halve the bins and its dilations
(1, 2) and (1, 4) space the frames, as the JAX package's channels-last
[B, bins, frames, 2C].

The period critics' (k, 1) kernels never mix the period axis, so their
weights are stored as 1D kernels [O, I, k] and, folded (the default, as in
the JAX package), the period axis goes into the batch and the stack runs as
1D convolutions on [B*p, C, T/p], period-major per sample: sample b's
period j is row b*p + j, which keeps the first half of the batch the first
half of the samples (the real/fake split of the train step). `fold=False`
runs the same weights as true 2D convolutions over [B, C, T/p, p], the
oracle of the folded form.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from rave_tpu_torch.nn.conv import _WeightNormConv, get_padding
from rave_tpu_torch.ops.stft import stft

Features = List[List[torch.Tensor]]


class WNConv(_WeightNormConv):
    """Non-streaming 1D or 2D conv with symmetric padding, dilation, groups
    and a bias; weight-normed (`v` [O, I / groups, *kernel], `g` [O]) or
    plain (`w`). An int `kernel_size` is 1D, a pair 2D; `stride`, `padding`
    and `dilation` are ints or pairs as `F.conv1d` / `F.conv2d` take them.
    `period_kernel`: the JAX package's kernel is the 2D (K, 1) one that the
    port keeps as the 1D kernel K (utils/convert.py reads the flag)."""

    out_dim = 0

    def __init__(self, in_features: int, features: int,
                 kernel_size: Union[int, Tuple[int, int]], stride=1, padding=0,
                 weight_norm: bool = True, groups: int = 1, dilation=1,
                 period_kernel: bool = False):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
        self.dilation, self.period_kernel = dilation, period_kernel
        kernel = (kernel_size,) if isinstance(kernel_size, int) else tuple(kernel_size)
        self._make_params((features, in_features // groups, *kernel), features, weight_norm,
                          True)

    def _params(self, x: torch.Tensor):
        """Weight and bias in the input's dtype (a bf16 critic under
        `train.bf16_dis` keeps fp32 masters; rave_tpu/models/discriminators.py:66,73)."""
        return self.weight().to(x.dtype), self.b.to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[N, I, T] -> [N, O, T'] (1D), [N, I, H, W] -> [N, O, H', W'] (2D)."""
        w, b = self._params(x)
        conv = F.conv1d if w.ndim == 3 else F.conv2d
        return conv(x, w, b, self.stride, self.padding, self.dilation, self.groups)

    def forward_2d(self, x: torch.Tensor) -> torch.Tensor:
        """A 1D kernel K as (K, 1) over [B, I, H, W] -> [B, O, H', W]."""
        w, b = self._params(x)
        return F.conv2d(x, w[..., None], b, (self.stride, 1), (self.padding, 0),
                        (self.dilation, 1), self.groups)


class ConvNet(nn.Module):
    """Feature-extracting conv stack (reference rave/discriminator.py:77-119):
    `n_layers` strided weight-normed convs of capacity * 2**i channels with
    LeakyReLU(0.2) between them, then a plain 1x1 conv to `out_size`.
    `kernel_size` int: 1D over [N, C, T]; a pair (k, w): 2D over [B, C, H,
    W], strided by (stride, 1) and padded over H only. The period critic's
    (k, 1) kernel is kept as the 1D kernel k and runs folded (1D over
    [B*p, C, T/p]) or not (2D over [B, C, T/p, p]); the fold is exact only
    for w = 1, so another kernel runs unfolded and `fold` raises."""

    def __init__(self, in_features: int, out_size: int, capacity: int, n_layers: int,
                 kernel_size: Union[int, Tuple[int, int]], stride: int, fold: bool = True):
        super().__init__()
        two_d = not isinstance(kernel_size, int)
        self.period = two_d and tuple(kernel_size)[1] == 1
        if two_d and not self.period and fold:
            raise ValueError(f"kernel {tuple(kernel_size)}: folding the period axis into the "
                             "batch is exact only for (k, 1) kernels; pass fold=False")
        self.fold = fold
        k = kernel_size[0] if two_d else kernel_size
        pad = get_padding(k, stride, mode="centered")[0]
        if two_d and not self.period:
            k, stride, pad = tuple(kernel_size), (stride, 1), (pad, 0)
        ch = in_features
        for i in range(n_layers):
            self.add_module(f"WNConv_{i}", WNConv(ch, capacity * 2 ** i, k, stride, pad,
                                                  period_kernel=self.period))
            ch = capacity * 2 ** i
        last = (1, 1) if two_d and not self.period else 1
        self.add_module(f"WNConv_{n_layers}", WNConv(ch, out_size, last, weight_norm=False,
                                                     period_kernel=self.period))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for conv in self.children():
            if feats:
                x = F.leaky_relu(feats[-1], 0.2)
            feats.append(conv.forward_2d(x) if self.period and not self.fold else conv(x))
        return feats


class MultiScaleDiscriminator(nn.Module):
    """1D ConvNets over the signal average-pooled by 2 between scales
    (reference rave/discriminator.py:122-136); the pool drops an odd last
    sample, as flax's VALID pool does."""

    def __init__(self, n_channels: int, n_discriminators: int, capacity: int = 64,
                 n_layers: int = 4, kernel_size: int = 15, stride: int = 4):
        super().__init__()
        for i in range(n_discriminators):
            self.add_module(f"scale_{i}", ConvNet(n_channels, 1, capacity, n_layers,
                                                  kernel_size, stride))

    def forward(self, x: torch.Tensor) -> Features:
        feats = []
        for net in self.children():
            feats.append(net(x))
            x = F.avg_pool1d(x, 2)
        return feats


class MultiPeriodDiscriminator(nn.Module):
    """ConvNets over the signal folded by each period (reference
    rave/discriminator.py:174-195); see the module docstring for `fold`."""

    def __init__(self, n_channels: int, periods: Sequence[int], capacity: int = 64,
                 n_layers: int = 4, kernel_size: Tuple[int, int] = (5, 1), stride: int = 4,
                 fold: bool = True):
        super().__init__()
        self.periods, self.fold = tuple(periods), fold
        for i, p in enumerate(self.periods):
            self.add_module(f"period_{p}_{i}", ConvNet(n_channels, 1, capacity, n_layers,
                                                       kernel_size, stride, fold))

    def forward(self, x: torch.Tensor) -> Features:
        B, C, T = x.shape
        feats = []
        for p, net in zip(self.periods, self.children()):
            xp = F.pad(x, (0, (p - T % p) % p)).reshape(B, C, -1, p)  # t = n*p + j
            if self.fold:
                xp = xp.permute(0, 3, 1, 2).reshape(B * p, C, -1)
            feats.append(net(xp))
        return feats


class MultiScaleSpectralDiscriminator1d(nn.Module):
    """1D ConvNets over each scale's complex STFT (not centered, normalized),
    frames as time and the real then imaginary bins as channels (reference
    rave/discriminator.py:156-171). Mirrors rave_tpu/models/discriminators.py:242,
    which flattens its channels-last [B, T, C] input with reshape(-1, T): for
    C > 1 that interleaves time and channels (ROADMAP C18); no config reaches
    this critic (the gin reader maps it to kind `spectral`, the 2D one)."""

    def __init__(self, scales: Sequence[int], capacity: int = 64, n_layers: int = 4,
                 kernel_size: int = 5, stride: int = 2):
        super().__init__()
        self.scales = tuple(scales)
        for i, scale in enumerate(self.scales):
            self.add_module(f"spec_{scale}_{i}", ConvNet(2 * (scale // 2 + 1), 1, capacity,
                                                         n_layers, kernel_size, stride))

    def forward(self, x: torch.Tensor) -> Features:
        B, T = x.shape[0], x.shape[-1]
        flat = x.transpose(1, 2).reshape(-1, T)  # rave_tpu's reshape of [B, T, C]
        feats = []
        for scale, net in zip(self.scales, self.children()):
            s = stft(flat, scale, scale // 4, center=False, normalized=True)
            spec = torch.cat([s.real, s.imag], -1).reshape(B, -1, s.shape[-1] * 2)
            feats.append(net(spec.transpose(1, 2).to(x.dtype)))
        return feats


# (kernel, stride, dilation) of EncodecConvNet's weight-normed convs, (bins, frames)
ENCODEC_LAYERS = (((9, 3), (1, 1), (1, 1)), ((9, 3), (2, 1), (1, 1)), ((9, 3), (2, 1), (1, 2)),
                  ((9, 3), (2, 1), (1, 4)), ((3, 3), (1, 1), (1, 1)))


class EncodecConvNet(nn.Module):
    """2D critic over a spectral image [B, I, bins, frames] (reference
    rave/discriminator.py:54-74): five convs of `capacity` channels
    (ENCODEC_LAYERS, padded by (k - 1) * d // 2 on each axis) with
    LeakyReLU(0.2) between them, then a weight-normed 3x3 `conv_out` to 1."""

    def __init__(self, in_features: int, capacity: int):
        super().__init__()
        ch = in_features
        for i, (k, s, d) in enumerate(ENCODEC_LAYERS):
            pad = ((k[0] - 1) * d[0] // 2, (k[1] - 1) * d[1] // 2)
            self.add_module(f"conv_{i}", WNConv(ch, capacity, k, s, pad, dilation=d))
            ch = capacity
        self.conv_out = WNConv(ch, 1, (3, 3), 1, 1)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for conv in self.children():
            if feats:
                x = F.leaky_relu(feats[-1], 0.2)
            feats.append(conv(x))
        return feats


class MultiScaleSpectralDiscriminator(nn.Module):
    """EncodecConvNets over each scale's complex STFT (not centered,
    normalized) of the signal (reference rave/discriminator.py:139-153):
    the image [B, 2C, bins, frames] of the real then imaginary parts, cast
    back to the input's dtype (the STFT of a bf16 critic input runs in
    float32, rave_tpu/models/discriminators.py:315)."""

    def __init__(self, n_channels: int, scales: Sequence[int], capacity: int = 32):
        super().__init__()
        self.scales = tuple(scales)
        for i, scale in enumerate(self.scales):
            self.add_module(f"enc_{scale}_{i}", EncodecConvNet(2 * n_channels, capacity))

    def forward(self, x: torch.Tensor) -> Features:
        B, C, T = x.shape
        flat = x.reshape(B * C, T)
        feats = []
        for scale, net in zip(self.scales, self.children()):
            s = stft(flat, scale, scale // 4, center=False, normalized=True)
            s = s.reshape(B, C, *s.shape[1:])  # [B, C, frames, bins]
            img = torch.cat([s.real, s.imag], 1).transpose(2, 3)
            feats.append(net(img.to(x.dtype)))
        return feats


class CombineDiscriminators(nn.Module):
    """The feature lists of several critics, concatenated in order
    (reference rave/discriminator.py:198-209)."""

    def __init__(self, discriminators: Sequence[nn.Module]):
        super().__init__()
        for i, d in enumerate(discriminators):
            self.add_module(f"discriminators_{i}", d)

    def forward(self, x: torch.Tensor) -> Features:
        return [f for d in self.children() for f in d(x)]
