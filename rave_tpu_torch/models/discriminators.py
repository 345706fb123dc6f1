"""The adversarial critics of v2: multi-scale, multi-period and their combination.

PyTorch port of rave_tpu/models/discriminators.py (`WNConv` :22-73, 1D
and 2D, which models/descript.py's critic uses too; `ConvNet` :76-152,
`MultiScaleDiscriminator` :155-179, `MultiPeriodDiscriminator` :182-226,
`CombineDiscriminators` :322-335), channels-first. Each sub-network
returns its per-layer feature maps; the last one is the score. Module
names mirror the flax paths (`discriminators_0.period_2_0.WNConv_3`), so
utils/convert.py maps the critic's weights by rename as it does the model's.

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

Features = List[List[torch.Tensor]]


class WNConv(_WeightNormConv):
    """Non-streaming 1D or 2D conv with symmetric padding, groups and a bias;
    weight-normed (`v` [O, I / groups, *kernel], `g` [O]) or plain (`w`).
    An int `kernel_size` is 1D, a pair 2D; `stride` and `padding` are ints
    or pairs as `F.conv1d` / `F.conv2d` take them."""

    out_dim = 0

    def __init__(self, in_features: int, features: int,
                 kernel_size: Union[int, Tuple[int, int]], stride=1, padding=0,
                 weight_norm: bool = True, groups: int = 1):
        super().__init__()
        self.stride, self.padding, self.groups = stride, padding, groups
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
        return conv(x, w, b, self.stride, self.padding, groups=self.groups)

    def forward_2d(self, x: torch.Tensor) -> torch.Tensor:
        """A 1D kernel K as (K, 1) over [B, I, H, W] -> [B, O, H', W]."""
        w, b = self._params(x)
        return F.conv2d(x, w[..., None], b, (self.stride, 1), (self.padding, 0),
                        groups=self.groups)


class ConvNet(nn.Module):
    """Feature-extracting conv stack (reference rave/discriminator.py:77-119):
    `n_layers` strided weight-normed convs of capacity * 2**i channels with
    LeakyReLU(0.2) between them, then a plain 1x1 conv to `out_size`.
    `kernel_size` int: 1D over [N, C, T]; (k, 1): the period critic's
    kernel, folded (1D over [B*p, C, T/p]) or not (2D over [B, C, T/p, p])."""

    def __init__(self, in_features: int, out_size: int, capacity: int, n_layers: int,
                 kernel_size: Union[int, Tuple[int, int]], stride: int, fold: bool = True):
        super().__init__()
        self.two_d = not isinstance(kernel_size, int)
        if self.two_d and tuple(kernel_size)[1] != 1:
            raise NotImplementedError(f"kernel {tuple(kernel_size)}: only (k, 1) period "
                                      "kernels are ported (ROADMAP A11)")
        k = kernel_size[0] if self.two_d else kernel_size
        self.fold = fold
        pad = get_padding(k, stride, mode="centered")[0]
        ch = in_features
        for i in range(n_layers):
            self.add_module(f"WNConv_{i}", WNConv(ch, capacity * 2 ** i, k, stride, pad))
            ch = capacity * 2 ** i
        self.add_module(f"WNConv_{n_layers}", WNConv(ch, out_size, 1, weight_norm=False))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for conv in self.children():
            if feats:
                x = F.leaky_relu(feats[-1], 0.2)
            feats.append(conv.forward_2d(x) if self.two_d and not self.fold else conv(x))
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


class CombineDiscriminators(nn.Module):
    """The feature lists of several critics, concatenated in order
    (reference rave/discriminator.py:198-209)."""

    def __init__(self, discriminators: Sequence[nn.Module]):
        super().__init__()
        for i, d in enumerate(discriminators):
            self.add_module(f"discriminators_{i}", d)

    def forward(self, x: torch.Tensor) -> Features:
        return [f for d in self.children() for f in d(x)]
