"""Latent prior primitives: erf-CDF quantization and the diagonal time shift.

PyTorch port of rave_tpu/prior/core.py (reference rave/prior/core.py:
QuantizedNormal 6-41, DiagonalShift 44-75), in the port's channels-first
layout: latents [B, D, T], stacked one-hots and logits [B, D*R, T] with
channel d*R + r (D major, R minor, as the JAX package's last axis). The
JAX package is channels-last ([B, T, D]); a tensor crosses between the two
by `transpose(0, 2, 1)`.

Nothing here draws: the dither of `QuantizedNormal.decode` is a uniform
tensor passed in, so that a test can hand both packages the same numbers
and an exported program draws it from its seed.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F


def stack_one_hot(classes: torch.Tensor, resolution: int) -> torch.Tensor:
    """[B, D, T] integer bins -> [B, D*R, T] float32 one-hots, channel d*R + r."""
    B, D, T = classes.shape
    oh = F.one_hot(classes.long(), resolution).to(torch.float32)  # [B, D, T, R]
    return oh.permute(0, 1, 3, 2).reshape(B, D * resolution, T)


class QuantizedNormal:
    """Quantize N(0, 1) latents into `resolution` equal-probability bins by
    the Gaussian CDF; decode to the bins' lower edges, plus an optional
    dither of up to one bin."""

    def __init__(self, resolution: int, dither: bool = True):
        self.resolution = resolution
        self.dither = dither
        self.clamp = 4.0

    def from_normal(self, x: torch.Tensor) -> torch.Tensor:
        return 0.5 * (1 + torch.special.erf(x / math.sqrt(2)))

    def to_normal(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.special.erfinv(2 * x - 1) * math.sqrt(2)
        return x.clamp(-self.clamp, self.clamp)

    def encode_classes(self, x: torch.Tensor) -> torch.Tensor:
        """[B, D, T] floats -> [B, D, T] int64 bins."""
        q = torch.floor(self.from_normal(x) * self.resolution)
        return q.clamp(0, self.resolution - 1).long()

    def to_stack_one_hot(self, classes: torch.Tensor) -> torch.Tensor:
        """[B, D, T] bins -> [B, D*R, T] one-hots (D major, R minor)."""
        return stack_one_hot(classes, self.resolution)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.to_stack_one_hot(self.encode_classes(x))

    def decode(self, x: torch.Tensor, dither: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, D*R, T] stacked one-hots or logits -> [B, D, T] floats;
        `dither` [B, D, T] uniforms in [0, 1) (the JAX package's draw from
        its `rng`), added when given and the quantizer dithers."""
        B, _, T = x.shape
        q = x.reshape(B, -1, self.resolution, T).argmax(2).to(torch.float32) / self.resolution
        if self.dither and dither is not None:
            q = q + dither.to(q.dtype) / self.resolution
        return self.to_normal(q)


class DiagonalShift:
    """Shift latent dimension d by D - 1 - d steps so that, after the shift,
    dimension d at time t conditions only on the dimensions before it at
    the same step during autoregression. The output is D - 1 steps shorter."""

    def shift(self, x: torch.Tensor) -> torch.Tensor:
        """[B, D, T] -> [B, D, T - D + 1]."""
        D, T = x.shape[1], x.shape[2]
        n = T - D + 1
        return torch.stack([x[:, d, D - 1 - d: D - 1 - d + n] for d in range(D)], dim=1)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.shift(x)

    def inverse(self, x: torch.Tensor) -> torch.Tensor:
        return self.shift(x.flip(1)).flip(1)
