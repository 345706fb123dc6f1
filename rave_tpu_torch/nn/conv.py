"""Dual-mode (offline / streaming) 1-D convolutions with static delay algebra.

PyTorch port of rave_tpu/nn/conv.py, in the channels-first `[B, C, T]`
layout:

  * Offline mode: `forward(x)` pads explicitly with `F.pad` ('centered'
    puts the larger half on the left, 'causal' all of it) and runs one
    `F.conv1d` / `F.conv_transpose1d`.
  * Streaming mode: `step(x)` carries its left context (Conv1d) or its
    overlap-add tail (ConvTranspose1d) in a stream-state buffer (see
    nn/streaming.py). Chunked streaming equals the causal offline output.
  * Delay algebra: `delay` is the cumulative number of output-rate samples
    by which the streaming output lags the centered offline output; a
    strided conv adds an `extra_delay` left shift that rounds it up to a
    whole output frame:
        extra     = (-(in_delay + pad_right)) % stride
        out_delay = (in_delay + pad_right + extra) // stride

Weight norm is stored as (v, g) with the norm taken per *output* channel
over (in, k), `+1e-12` inside the square root, for both conv kinds
(rave_tpu/nn/conv.py:70-73). `torch.nn.utils.weight_norm` normalises a
transposed conv per input channel, so it is written out here.
`freeze_weights` fixes the effective kernels for serving.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rave_tpu_torch.nn.streaming import StreamingModule, as_dtype

# flax's lecun_normal: a normal truncated at two standard deviations,
# rescaled so the truncated distribution has variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def get_padding(
    kernel_size: int, stride: int = 1, dilation: int = 1, mode: str = "centered"
) -> Tuple[int, int]:
    """(left, right) padding for same-rate (T -> T/stride) output."""
    total = max(0, dilation * (kernel_size - 1) + 1 - stride)
    if mode == "centered":
        right = total // 2
        return (total - right, right)
    if mode == "causal":
        return (total, 0)
    raise ValueError(f"padding mode must be centered|causal, got {mode}")


def conv_delay(
    in_delay: int, kernel: int, stride: int = 1, dilation: int = 1, mode: str = "centered"
) -> int:
    """Delay algebra of Conv1d, without building a module."""
    r = get_padding(kernel, stride, dilation, mode)[1]
    e = (-(in_delay + r)) % stride
    return (in_delay + r + e) // stride


def tconv_delay(in_delay: int, ratio: int, mode: str = "centered") -> int:
    """Delay algebra of ConvTranspose1d."""
    return in_delay * ratio + (ratio // 2 if mode == "centered" else 0)


def _norm_weight(v: torch.Tensor, g: torch.Tensor, out_dim: int) -> torch.Tensor:
    """w = g * v / ||v||, the norm per output channel (axis `out_dim` of v)."""
    dims = [d for d in range(v.ndim) if d != out_dim]
    norm = torch.sqrt(torch.sum(v * v, dim=dims, keepdim=True) + 1e-12)
    shape = [1] * v.ndim
    shape[out_dim] = -1
    return v * (g.reshape(shape) / norm)


class _WeightNormConv(StreamingModule):
    """Parameters shared by both conv kinds: `v`/`g` (weight norm) or `w`,
    and an optional bias `b`, initialised like the JAX package's."""

    out_dim: int  # axis of the output channels in the torch weight layout

    def _make_params(self, shape: Tuple[int, ...], features: int, weight_norm: bool,
                     use_bias: bool) -> None:
        self.weight_norm = weight_norm
        if weight_norm:
            self.v = nn.Parameter(torch.empty(shape))
            self.g = nn.Parameter(torch.empty(features))
        else:
            self.w = nn.Parameter(torch.empty(shape))
        self.b = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """lecun-normal kernel, then g = ||v|| per output channel
        (rave_tpu/nn/conv.py:138-146); zero bias."""
        kernel = self.v if self.weight_norm else self.w
        fan_in = kernel.numel() // kernel.shape[self.out_dim]
        std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
        with torch.no_grad():
            nn.init.trunc_normal_(kernel, 0.0, std, -2 * std, 2 * std, generator=generator)
            if self.weight_norm:
                dims = [d for d in range(kernel.ndim) if d != self.out_dim]
                self.g.copy_(torch.sqrt(torch.sum(kernel * kernel, dim=dims) + 1e-12))
            if self.b is not None:
                self.b.zero_()

    def weight(self) -> torch.Tensor:
        """The effective kernel, weight norm applied."""
        if self.weight_norm:
            return _norm_weight(self.v, self.g, self.out_dim)
        return self.w


def freeze_weights(module: nn.Module) -> None:
    """Replace every weight-normed conv's (v, g) under `module` by its
    effective kernel `w`, for serving weights that never change (the
    artifact; the JAX package's compiled step programs fold weight norm into
    constants): each call then skips weight norm's ops, a third of a
    streaming block's."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, _WeightNormConv) and m.weight_norm:
                w = m.weight()
                del m.v, m.g
                m.w, m.weight_norm = nn.Parameter(w, requires_grad=False), False


class Conv1d(_WeightNormConv):
    """Strided/dilated conv with centered|causal padding and streaming cache.

    Offline: `forward(x)`, x [B, C, T] -> [B, features, T//stride].
    Streaming: `step(x)` with chunk length divisible by `stride`; carries
    `cache_len = pad_total + extra_delay` input frames of left context.
    Weight layout: `v`/`w` [features, in / groups, kernel], `g` [features];
    `groups` splits the input and output channels into that many
    contiguous blocks, each convolved with its own (flax's
    `feature_group_count`, rave_tpu/nn/conv.py:107,135-137).
    """

    out_dim = 0

    def __init__(
        self, in_features: int, features: int, kernel_size: int, stride: int = 1,
        dilation: int = 1, mode: str = "centered", use_bias: bool = True,
        weight_norm: bool = False, groups: int = 1, in_delay: int = 0, stream_batch: int = 1,
    ):
        super().__init__()
        if in_features % groups or features % groups:
            raise ValueError(f"groups={groups} must divide in_features={in_features} and "
                             f"features={features}")
        self.in_features, self.features, self.groups = in_features, features, groups
        self.kernel_size, self.stride, self.dilation = kernel_size, stride, dilation
        self.mode, self.in_delay = mode, in_delay
        self.pad = get_padding(kernel_size, stride, dilation, mode)
        self._make_params((features, in_features // groups, kernel_size), features, weight_norm,
                          use_bias)
        if self.cache_len > 0:
            self.add_stream_state("cache", in_features, self.cache_len, stream_batch)

    @property
    def extra_delay(self) -> int:
        return (-(self.in_delay + self.pad[1])) % self.stride

    @property
    def delay(self) -> int:
        """Cumulative streaming delay of the output, in output-rate samples."""
        return (self.in_delay + self.pad[1] + self.extra_delay) // self.stride

    @property
    def cache_len(self) -> int:
        return sum(self.pad) + self.extra_delay

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        w = as_dtype(self.weight(), x.dtype)
        b = None if self.b is None else as_dtype(self.b, x.dtype)
        return F.conv1d(x, w, b, self.stride, 0, self.dilation, self.groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv(F.pad(x, self.pad))

    def step(self, x: torch.Tensor) -> torch.Tensor:
        if self.cache_len == 0:
            return self._conv(x)
        ext = torch.cat([as_dtype(self.cache, x.dtype), x], dim=-1)
        y = self._conv(ext)
        self.cache = ext[..., ext.shape[-1] - self.cache_len :]
        # A pad-free fat-stride conv (kernel <= stride) whose extra shift
        # lets one more window fit emits a spurious trailing frame; it is
        # recomputed identically from the cache next chunk — drop it.
        return y[..., : x.shape[-1] // self.stride]


class ConvTranspose1d(_WeightNormConv):
    """Fractional-stride upsampling conv (kernel 2*ratio, crop ratio//2 when
    centered), with causal streaming via an overlap-add carry.

    Offline: y = full_transpose(x)[crop : crop + T*ratio].
    Streaming: y = full_transpose(x)[0 : T*ratio], with the (kernel - ratio)
    tail added into the head of the next chunk.
    Weight layout: `v`/`w` [in, features, kernel] (a true transposed conv,
    no flip), `g` [features].
    """

    out_dim = 1

    def __init__(
        self, in_features: int, features: int, ratio: int, mode: str = "centered",
        use_bias: bool = True, weight_norm: bool = False, in_delay: int = 0,
        stream_batch: int = 1,
    ):
        super().__init__()
        self.in_features, self.features, self.ratio = in_features, features, ratio
        self.k = 2 * ratio
        self.mode, self.in_delay = mode, in_delay
        self.crop = ratio // 2 if mode == "centered" else 0
        self._make_params((in_features, features, self.k), features, weight_norm, use_bias)
        if self.carry_len > 0:
            self.add_stream_state("carry", features, self.carry_len, stream_batch)

    @property
    def delay(self) -> int:
        return self.in_delay * self.ratio + self.crop

    @property
    def carry_len(self) -> int:
        return self.k - self.ratio

    def _full(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, T] -> [B, features, (T-1)*ratio + k]."""
        return F.conv_transpose1d(x, as_dtype(self.weight(), x.dtype), stride=self.ratio)

    def _bias(self, y: torch.Tensor) -> torch.Tensor:
        return y if self.b is None else y + as_dtype(self.b, y.dtype)[:, None]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[-1] * self.ratio
        return self._bias(self._full(x)[..., self.crop : self.crop + n])

    def step(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[-1] * self.ratio
        y = self._full(x)
        out = y[..., :n]
        if self.carry_len > 0:
            head = out[..., : self.carry_len] + as_dtype(self.carry, out.dtype)
            out = torch.cat([head, out[..., self.carry_len :]], dim=-1)
            self.carry = y[..., n:]
        return self._bias(out)
