"""Encoder/generator building blocks (dual-mode, delay-tracked).

PyTorch port of rave_tpu/models/blocks.py, channels-first `[B, C, T]`:
the pure delay algebra, the activations (leaky ReLU, Snake), SampleNorm,
BatchNorm1d and AdaIN; the v2 family: the DilatedUnit residual stacks
(whose offline path is the fused CUDA kernel on a GPU when the activation
is leaky ReLU), EncoderV2 and GeneratorV2 (amplitude modulation, the
filtered-noise synth `NoiseGeneratorV2` beside the waveform conv, and an
optional GRU: at the encoder's output, at the generator's input); the v1
family: EncoderV1 (strided convs with BatchNorm or SampleNorm, an optional
GRU, a grouped final conv) and GeneratorV1 (upsampling with multi-kernel
`ResidualStack`s, then a waveform, a loudness and a filtered-noise branch,
`NoiseGenerator`); and the latent families (variational, wasserstein,
discrete over models/quantization.py, spherical with its angle codecs),
each taking its draws explicitly (`LatentDraws`). The noise synths'
uniform noise is an input too (`LatentDraws.uniform`, `GeneratorV2(z,
uniform)`, `GeneratorV1(z, uniform, warmed_up)`), never drawn inside the
module.
Attribute names (`net.layers.N`, `inner`, `waveform`, `synth.branches.N`,
`aligned`, `bn`, `encoder`) mirror the flax module paths, so
utils/convert.py maps weights by rename.

Train and eval mode are PyTorch's (`model.train()` / `model.eval()`);
AdaIN and BatchNorm1d read them, as the JAX modules' `train` field: AdaIN
is the identity in training and transfers in eval mode; BatchNorm1d
normalizes by the batch's statistics in training (and folds them into its
running averages) and by the running averages in eval mode and streaming.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from rave_tpu_torch.models.quantization import ResidualVectorQuantization
from rave_tpu_torch.nn.combinators import AlignBranches, Lambda, Residual, Sequential
from rave_tpu_torch.nn.conv import Conv1d, ConvTranspose1d, conv_delay, get_padding, tconv_delay
from rave_tpu_torch.nn.gru import GRU
from rave_tpu_torch.nn.streaming import as_dtype, static_shape, static_size
from rave_tpu_torch.parallel import mesh
from rave_tpu_torch.ops.dsp import (
    amp_to_impulse_response, at_least_float32, fft_convolve, mod_sigmoid,
)
from rave_tpu_torch.ops.kernels.dilated_unit import fused_dilated_unit, traced
from rave_tpu_torch.ops.kernels.unit_op import unit_op

# --------------------------------------------------------------------------
# pure delay algebra (rave_tpu/models/blocks.py:44-135)
# --------------------------------------------------------------------------


def dilated_unit_delay(kernel_size: int, dilation: int, mode: str) -> int:
    return get_padding(kernel_size, 1, dilation, mode)[1]


def residual_layer_delay(kernel_size: int, dilations, mode: str) -> int:
    d = 0
    for dil in dilations:
        d = conv_delay(d, kernel_size, 1, dil, mode)
    return d


def residual_stack_delay(kernel_sizes, dilations_list, mode: str) -> int:
    return max(sum(residual_layer_delay(k, dils, mode) for dils in dilations_list)
               for k in kernel_sizes)


def noise_generator_delay(in_delay: int, ratios, mode: str) -> int:
    d = in_delay
    for r in ratios:
        d = conv_delay(d, 3, r, 1, mode)
    return d * math.prod(ratios)


def encoder_v1_delay(in_delay: int, ratios, repeat_layers: int, mode: str) -> int:
    d = conv_delay(in_delay, 7, 1, 1, mode)
    for r in ratios:
        d = conv_delay(d, 2 * r + 1, r, 1, mode)
        for _ in range(repeat_layers - 1):
            d = conv_delay(d, 3, 1, 1, mode)
    return conv_delay(d, 5, 1, 1, mode)


def generator_v1_delay(ratios, res_kernel_sizes, res_dilations, loud_stride: int,
                       use_noise: bool, noise_ratios, mode: str) -> int:
    """The hidden stream's delay, then the latest of the waveform, loudness
    and noise branches (AlignBranches delays the others to it)."""
    d = conv_delay(0, 7, 1, 1, mode)
    for r in ratios:
        d = tconv_delay(d, r, mode) if r > 1 else conv_delay(d, 3, 1, 1, mode)
        d += residual_stack_delay(res_kernel_sizes, res_dilations, mode)
    branch = [conv_delay(d, 7, 1, 1, mode) - d,
              conv_delay(d, 2 * loud_stride + 1, loud_stride, 1, mode) * loud_stride - d]
    if use_noise:
        branch.append(noise_generator_delay(d, noise_ratios, mode) - d)
    return d + max(branch)


def noise_generator_v2_delay(in_delay: int, ratios) -> int:
    d = in_delay
    for r in ratios:
        d = conv_delay(d, 2 * r, r, 1, "causal")
    return d * math.prod(ratios)


def encoder_v2_delay(in_delay: int, kernel_size: int, ratios, dilations, mode: str) -> int:
    d = conv_delay(in_delay, 2 * kernel_size + 1, 1, 1, mode)
    for r, dils in zip(ratios, normalize_dilations(dilations, ratios)):
        for dil in dils:
            d += dilated_unit_delay(kernel_size, dil, mode)
        d = conv_delay(d, 2 * r, r, 1, mode)
    return conv_delay(d, kernel_size, 1, 1, mode)


def generator_v2_hidden_delay(kernel_size: int, ratios, dilations, mode: str) -> int:
    dilations_list = normalize_dilations(dilations, ratios)[::-1]
    d = conv_delay(0, kernel_size, 1, 1, mode)
    for r, dils in zip(ratios[::-1], dilations_list):
        d = tconv_delay(d, r, mode)
        for dil in dils:
            d += dilated_unit_delay(kernel_size, dil, mode)
    return d


def generator_v2_delay(kernel_size: int, ratios, dilations, mode: str, use_noise: bool = False,
                       noise_ratios=()) -> int:
    """Output delay: the hidden stream's, then the later of the waveform
    conv and the noise branch (AlignBranches delays the other to it)."""
    d = generator_v2_hidden_delay(kernel_size, ratios, dilations, mode)
    wave_d = conv_delay(d, kernel_size * 2 + 1, 1, 1, mode) - d
    if use_noise:
        return d + max(wave_d, noise_generator_v2_delay(d, noise_ratios) - d)
    return d + wave_d


# --------------------------------------------------------------------------
# activations, AdaIN
# --------------------------------------------------------------------------


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, 0.2)


class Snake(nn.Module):
    """x + sin^2(alpha x) / (alpha + 1e-9) with one learnable alpha per
    channel, initialized to ones and cast to the input's dtype (reference
    rave/blocks.py:852-860, rave_tpu/models/blocks.py:170-185)."""

    def __init__(self, dim: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        alpha = as_dtype(self.alpha, x.dtype)[:, None]
        return torch.addcdiv(x, torch.sin(alpha * x).square(), alpha + 1e-9)

    def step(self, x):
        return self(x)


def make_activation(name: str, dim: int) -> nn.Module:
    """Activation factory ('leaky_relu' | 'snake'); `dim` is the channel count."""
    if name == "leaky_relu":
        return Lambda(leaky_relu)
    if name == "snake":
        return Snake(dim)
    raise ValueError(f"unknown activation {name}")


class SampleNorm(nn.Module):
    """x over its L2 norm across channels (reference rave/blocks.py:25-28)."""

    def forward(self, x):
        return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)

    def step(self, x):
        return self(x)


class BatchStats(nn.Module):
    """The tensors of flax's `nn.BatchNorm`, by its names: the learned
    `scale` and `bias`, and the running `mean` and `var` (persistent
    buffers: the JAX package's `batch_stats` collection)."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))


class BatchNorm1d(nn.Module):
    """BatchNorm over [B, C, T] as flax's `nn.BatchNorm(momentum=0.9,
    epsilon=1e-5)` computes it (rave_tpu/models/blocks.py:207-221).

    In training mode it normalizes by the batch's statistics over (B, T),
    taken in float32 (float64 for a float64 input) with the biased
    variance mean(x^2) - mean(x)^2 (clipped at 0), and folds them into the
    running averages, 0.9 old + 0.1 new: not torch's unbiased variance. In
    eval mode, and always when streaming, it normalizes by the running
    averages. Under data parallelism the moments are the global batch's,
    as flax's over a sharded batch. A bfloat16 input gives a float32 output (flax promotes the
    input to its float32 statistics and parameters). Nothing is folded in while `frozen`, which the training
    step sets for `train.remat`'s recompute of a pass whose statistics
    were folded in already."""

    MOMENTUM, EPSILON = 0.9, 1e-5

    def __init__(self, features: int):
        super().__init__()
        self.bn = BatchStats(features)
        self.frozen = False

    def _normalize(self, x, mean, var):
        mul = torch.rsqrt(var + self.EPSILON) * self.bn.scale
        return (x - mean[:, None]) * mul[:, None] + self.bn.bias[:, None]

    def forward(self, x):
        if not self.training:
            return self.step(x)
        xf = at_least_float32(x)
        shards = mesh.batch_shards()
        if shards > 1:  # the global batch's moments (parallel/mesh.py)
            sums = mesh.all_reduce_sum(torch.stack([xf.sum((0, 2)), (xf * xf).sum((0, 2))]))
            n = xf.shape[0] * xf.shape[2] * shards
            mean, mean_sq = sums[0] / n, sums[1] / n
        else:
            mean, mean_sq = xf.mean((0, 2)), (xf * xf).mean((0, 2))
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        if not self.frozen:
            with torch.no_grad():
                m = self.MOMENTUM
                self.bn.mean.copy_(m * self.bn.mean + (1 - m) * mean)
                self.bn.var.copy_(m * self.bn.var + (1 - m) * var)
        return self._normalize(x, mean, var)

    def step(self, x):
        return self._normalize(x, self.bn.mean, self.bn.var)


ADAIN_MAX_BATCH = 8  # the JAX modules' `adain_max_batch`


class AdaIN(nn.Module):
    """Adaptive instance normalization with running statistics (reference
    rave/blocks.py:863-926, rave_tpu/models/blocks.py:224-299).

    The identity in training mode. In eval mode it maps the statistics over
    time of a source ('x') onto those of a target ('y'),
    `(x - mean_x) / (std_x + 1e-5) * std_y + mean_y`, once both were learned
    and the target is no longer learning. Its buffers (`mean_*`, `std_*`
    [ADAIN_MAX_BATCH, C, 1] per batch slot; `learn_*`, `num_update_*` [1])
    are persistent: checkpoints and artifacts carry them. They change only
    while `learning` is set, which the artifact's streaming steps do (the
    JAX package's mutable `adain` collection); then each call folds its
    statistics in by a cumulative moving average, the target's while
    `learn_y`, else the source's while `learn_x`. Updates reassign the
    buffers, as the stream state's do, so a `StepProgram` can swap them."""

    STATE = ("mean_x", "std_x", "mean_y", "std_y", "learn_x", "learn_y", "num_update_x",
             "num_update_y")

    def __init__(self, dim: int):
        super().__init__()
        self.learning = False
        for name in self.STATE:
            shape = (ADAIN_MAX_BATCH, dim, 1) if name[:4] in ("mean", "std_") else (1,)
            fill = torch.ones if name.startswith("std") else torch.zeros
            self.register_buffer(name, fill(shape))

    def forward(self, x):
        return x if self.training else self._transfer(x)

    def step(self, x):
        return self._transfer(x)

    def _transfer(self, x):
        bs = static_size(x, 0)
        if bs > ADAIN_MAX_BATCH:
            raise ValueError(f"AdaIN holds statistics for {ADAIN_MAX_BATCH} batch slots; "
                             f"a batch of {bs} runs only in training mode")
        learn_y = self.learn_y > 0
        idle_y = ~learn_y
        if self.learning:
            std, mean = torch.std_mean(x, -1, keepdim=True, correction=1)
            learn_x = idle_y & (self.learn_x > 0)
            for side, on in (("y", learn_y), ("x", learn_x)):
                n = getattr(self, f"num_update_{side}")
                rate = on / (n + 1)  # the cumulative moving average's weight
                for stat, value in (("mean", mean), ("std", std)):
                    old = getattr(self, f"{stat}_{side}")
                    head = torch.lerp(old[:bs], as_dtype(value, old.dtype), rate)
                    new = torch.where(on, torch.cat([head, old[bs:]]), old)
                    setattr(self, f"{stat}_{side}", new)
                setattr(self, f"num_update_{side}", n + on)
        mx, sx = as_dtype(self.mean_x[:bs], x.dtype), as_dtype(self.std_x[:bs], x.dtype)
        my, sy = as_dtype(self.mean_y[:bs], x.dtype), as_dtype(self.std_y[:bs], x.dtype)
        transfer = idle_y & (torch.minimum(self.num_update_x, self.num_update_y) > 0)
        return torch.where(transfer, (x - mx) / (sx + 1e-5) * sy + my, x)


def normalize_dilations(dilations, ratios) -> list:
    """[[1,3,9],...] per ratio (reference rave/blocks.py:506-511)."""
    if isinstance(dilations[0], int):
        dilations = [dilations for _ in ratios]
    return [tuple(d) for d in dilations]


# --------------------------------------------------------------------------
# v2 family
# --------------------------------------------------------------------------


class DilatedUnit(nn.Module):
    """act -> dilated conv(k) -> act -> conv(1). Reference rave/blocks.py:83-112."""

    def __init__(self, dim: int, kernel_size: int, dilation: int, mode: str = "centered",
                 weight_norm: bool = True, activation: str = "leaky_relu",
                 stream_batch: int = 1):
        super().__init__()
        self.kernel_size, self.dilation, self.mode = kernel_size, dilation, mode
        self.activation = activation
        conv1 = Conv1d(dim, dim, kernel_size, dilation=dilation, mode=mode,
                       weight_norm=weight_norm, use_bias=False, stream_batch=stream_batch)
        conv2 = Conv1d(dim, dim, 1, mode=mode, weight_norm=weight_norm, use_bias=False,
                       in_delay=conv1.delay, stream_batch=stream_batch)
        self.net = Sequential([
            make_activation(activation, dim), conv1, make_activation(activation, dim), conv2,
        ])

    @property
    def inner_delay(self) -> int:
        return dilated_unit_delay(self.kernel_size, self.dilation, self.mode)

    def forward(self, x):
        return self.net(x)

    def step(self, x):
        return self.net.step(x)


class FusedDilatedResidual(Residual):
    """Residual(DilatedUnit) whose offline path, for a leaky-ReLU unit, is
    one fused call, `fused_dilated_unit`: the CUDA kernel for a tensor on the
    GPU, the plain `F.conv1d` version for one on the CPU. A unit of another
    activation (Snake) runs the plain Residual, as the JAX package gates its
    Pallas kernel (rave_tpu/models/blocks.py:366-371). Parameters and the
    streaming path (plain convolutions) are those of the plain Residual.
    Under `torch.jit.trace` or `torch.export` the unit is the registered op
    `rave_tpu_torch::dilated_unit` (ops/kernels/unit_op.py), which a saved
    program records and runs: the same kernel on the card, the plain
    version on the CPU."""

    def forward(self, x):
        if self.inner.activation != "leaky_relu":
            return super().forward(x)
        conv1, conv2 = self.inner.net.layers[1], self.inner.net.layers[3]
        w1 = conv1.weight().to(x.dtype)
        w2 = conv2.weight()[:, :, 0].to(x.dtype)
        left, right = conv1.pad
        unit = unit_op if traced() else fused_dilated_unit
        return unit(x.contiguous(), w1, w2, conv1.dilation, left, right)


def residual_unit(dim: int, kernel_size: int, dilation: int, mode: str, weight_norm: bool,
                  activation: str, stream_batch: int) -> FusedDilatedResidual:
    unit = DilatedUnit(dim, kernel_size, dilation, mode, weight_norm, activation, stream_batch)
    return FusedDilatedResidual(unit, unit.inner_delay, dim, stream_batch)


class EncoderV2(nn.Module):
    """Dilated residual encoder with strided downsampling.

    Reference rave/blocks.py:514-596. Input [B, data_size*n_channels, T]
    (band frames, mel frames or the waveform), output [B, latent_size*n_out,
    T/prod(ratios)], through a GRU when `recurrent_layers`.
    """

    def __init__(self, data_size: int, capacity: int, ratios: Sequence[int], latent_size: int,
                 n_out: int, kernel_size: int, dilations, keep_dim: bool = False,
                 n_channels: int = 1, mode: str = "centered", weight_norm: bool = True,
                 activation: str = "leaky_relu", use_adain: bool = False,
                 recurrent_layers: int = 0, in_delay: int = 0, stream_batch: int = 1):
        super().__init__()
        self.kernel_size, self.mode, self.in_delay = kernel_size, mode, in_delay
        self.ratios, self.dilations = tuple(ratios), dilations
        conv = dict(mode=mode, weight_norm=weight_norm, use_bias=False, stream_batch=stream_batch)
        conv0 = Conv1d(data_size * n_channels, capacity, 2 * kernel_size + 1,
                       in_delay=in_delay, **conv)
        layers = [conv0]
        delay, ch = conv0.delay, capacity
        for r, dils in zip(self.ratios, normalize_dilations(dilations, self.ratios)):
            for d in dils:
                if use_adain:
                    layers.append(AdaIN(ch))
                res = residual_unit(ch, kernel_size, d, mode, weight_norm, activation,
                                    stream_batch)
                layers.append(res)
                delay += res.inner_delay
            layers.append(make_activation(activation, ch))
            out_ch = ch * r if keep_dim else ch * 2
            down = Conv1d(ch, out_ch, 2 * r, stride=r, in_delay=delay, **conv)
            layers.append(down)
            delay, ch = down.delay, out_ch
        layers.append(make_activation(activation, ch))
        layers.append(Conv1d(ch, latent_size * n_out, kernel_size, in_delay=delay, **conv))
        if recurrent_layers:
            layers.append(GRU(latent_size * n_out, recurrent_layers, stream_batch))
        self.net = Sequential(layers)

    @property
    def delay(self) -> int:
        return encoder_v2_delay(self.in_delay, self.kernel_size, self.ratios, self.dilations,
                                self.mode)

    def forward(self, x):
        return self.net(x)

    def step(self, x):
        return self.net.step(x)


class FilteredNoise(nn.Module):
    """The synthesis both noise synths share: band amplitudes [B,
    data_size*noise_bands, n] (from `net`) through mod_sigmoid(amp - 5),
    each frame's turned into a windowed impulse response of prod(ratios)
    taps that filters that frame's uniform noise (FFT convolution,
    frame-local): [B, data_size, n * prod(ratios)], float32 (float64 for a
    float64 pass). `uniform` [B,
    n, data_size, prod(ratios)] holds the frames' draws in [0, 1).
    Subclasses set `net`, `out_channels` (data_size), `noise_bands` and
    `target_size` (prod(ratios))."""

    def _synth(self, amp: torch.Tensor, uniform: torch.Tensor) -> torch.Tensor:
        B, _, n = amp.shape
        d = self.out_channels
        amp = mod_sigmoid(amp - 5.0).transpose(1, 2).reshape(B, n, d, self.noise_bands)
        ir = amp_to_impulse_response(amp, self.target_size)  # [B, n, d, target]
        if static_shape(uniform) != static_shape(ir):
            raise ValueError(f"the noise synth takes uniform draws {tuple(ir.shape)}; got "
                             f"{tuple(uniform.shape)}")
        out = fft_convolve(uniform.to(ir.dtype) * 2 - 1, ir)
        return out.permute(0, 2, 1, 3).reshape(B, d, n * self.target_size)

    def forward(self, x: torch.Tensor, uniform: torch.Tensor) -> torch.Tensor:
        return self._synth(self.net(x), uniform)

    def step(self, x: torch.Tensor, uniform: torch.Tensor) -> torch.Tensor:
        return self._synth(self.net.step(x), uniform)


class NoiseGeneratorV2(FilteredNoise):
    """Causal filtered-noise synth (reference rave/blocks.py:243-292,
    rave_tpu/models/blocks.py:534-603): strided causal convs (kernel 2r,
    stride r) from the hidden stream [B, in_size, T] to band amplitudes
    [B, data_size*noise_bands*n_channels, T / prod(ratios)], then
    `FilteredNoise`'s synthesis: [B, data_size*n_channels, T]."""

    def __init__(self, in_size: int, hidden_size: int, data_size: int, ratios: Sequence[int],
                 noise_bands: int, n_channels: int = 1, activation: str = "leaky_relu",
                 in_delay: int = 0, stream_batch: int = 1):
        super().__init__()
        self.ratios, self.noise_bands, self.in_delay = tuple(ratios), noise_bands, in_delay
        self.out_channels = data_size * n_channels
        self.target_size = math.prod(self.ratios)
        chans = [in_size] + (len(self.ratios) - 1) * [hidden_size]
        chans.append(self.out_channels * noise_bands)
        layers, d = [], in_delay
        for i, r in enumerate(self.ratios):
            conv = Conv1d(chans[i], chans[i + 1], 2 * r, stride=r, mode="causal", use_bias=False,
                          in_delay=d, stream_batch=stream_batch)
            layers.append(conv)
            d = conv.delay
            if i != len(self.ratios) - 1:
                layers.append(make_activation(activation, chans[i + 1]))
        self.net = Sequential(layers)

    @property
    def delay(self) -> int:
        return noise_generator_v2_delay(self.in_delay, self.ratios)


class GeneratorV2(nn.Module):
    """Mirror decoder: transposed-conv upsampling + dilated residual units,
    with optional amplitude modulation, filtered-noise branch and input GRU.

    Reference rave/blocks.py:599-714. Input [B, latent_size, T_latent];
    output [B, data_size*n_channels, T_frames] (multiband frames when
    output_mode == 'pqmf', the waveform under 'raw'). With `use_noise` the
    waveform conv and `NoiseGeneratorV2` run side by side (`synth`, an
    AlignBranches) and add before the tanh; the call then takes the noise
    branch's `uniform` draws (`RaveConfig.noise_shape`).
    """

    def __init__(self, latent_size: int, capacity: int, ratios: Sequence[int],
                 kernel_size: int, dilations, data_size: int = 0, keep_dim: bool = False,
                 n_channels: int = 1, amplitude_modulation: bool = False,
                 use_noise: bool = False, noise_hidden: int = 64, noise_ratios=(4, 4, 4),
                 noise_bands: int = 5, mode: str = "centered", weight_norm: bool = True,
                 activation: str = "leaky_relu", use_adain: bool = False,
                 recurrent_layers: int = 0, stream_batch: int = 1):
        super().__init__()
        self.kernel_size, self.mode = kernel_size, mode
        self.ratios, self.dilations = tuple(ratios), dilations
        self.amplitude_modulation, self.use_noise = amplitude_modulation, use_noise
        self.noise_ratios = tuple(noise_ratios)
        conv = dict(mode=mode, weight_norm=weight_norm, use_bias=False, stream_batch=stream_batch)
        ch = (math.prod(self.ratios) if keep_dim else 2 ** len(self.ratios)) * capacity
        layers = [GRU(latent_size, recurrent_layers, stream_batch)] if recurrent_layers else []
        conv0 = Conv1d(latent_size, ch, kernel_size, **conv)
        layers.append(conv0)
        delay = conv0.delay
        dilations_list = normalize_dilations(dilations, self.ratios)[::-1]
        for r, dils in zip(self.ratios[::-1], dilations_list):
            out_ch = ch // r if keep_dim else ch // 2
            layers.append(make_activation(activation, ch))
            up = ConvTranspose1d(ch, out_ch, r, in_delay=delay, **conv)
            layers.append(up)
            delay, ch = up.delay, out_ch
            for d in dils:
                if use_adain:
                    layers.append(AdaIN(ch))
                res = residual_unit(ch, kernel_size, d, mode, weight_norm, activation,
                                    stream_batch)
                layers.append(res)
                delay += res.inner_delay
        layers.append(make_activation(activation, ch))
        self.net = Sequential(layers)
        out = (data_size or 1) * n_channels
        wave_out = 2 * out if amplitude_modulation else out
        waveform = Conv1d(ch, wave_out, kernel_size * 2 + 1, in_delay=delay, **conv)
        if use_noise:
            noise = NoiseGeneratorV2(ch, noise_hidden, data_size or 1, noise_ratios,
                                     noise_bands, n_channels, activation, delay, stream_batch)
            self.synth = AlignBranches((waveform, noise),
                                       (waveform.delay - delay, noise.delay - delay),
                                       (wave_out, out), stream_batch)
        else:
            self.waveform = waveform

    @property
    def delay(self) -> int:
        return generator_v2_delay(self.kernel_size, self.ratios, self.dilations, self.mode,
                                  self.use_noise, self.noise_ratios)

    def _branches(self, h: torch.Tensor, uniform: Optional[torch.Tensor], streaming: bool):
        if not self.use_noise:
            return (self.waveform.step(h) if streaming else self.waveform(h)), None
        if uniform is None:
            raise ValueError("the noise branch takes its uniform draws as an input "
                             "(LatentDraws.uniform, train/steps.py::draw_noise)")
        return self.synth.step(h, uniform) if streaming else self.synth(h, uniform)

    def _mix(self, wave: torch.Tensor, noise: Optional[torch.Tensor]) -> torch.Tensor:
        if self.amplitude_modulation:
            wave, amp = wave.chunk(2, dim=1)
            wave = wave * torch.sigmoid(amp)
        return torch.tanh(wave if noise is None else wave + noise)

    def forward(self, z, uniform: Optional[torch.Tensor] = None):
        return self._mix(*self._branches(self.net(z), uniform, False))

    def step(self, z, uniform: Optional[torch.Tensor] = None):
        return self._mix(*self._branches(self.net.step(z), uniform, True))


# --------------------------------------------------------------------------
# v1 family (reference rave/blocks.py:48-240, 322-503)
# --------------------------------------------------------------------------


class ResidualLayer(nn.Module):
    """x + a chain of (act, dilated conv k) pairs (reference rave/blocks.py:48-80)."""

    def __init__(self, dim: int, kernel_size: int, dilations, mode: str = "centered",
                 weight_norm: bool = True, activation: str = "leaky_relu",
                 stream_batch: int = 1):
        super().__init__()
        self.inner_delay = residual_layer_delay(kernel_size, dilations, mode)
        layers, d = [], 0
        for dil in dilations:
            conv = Conv1d(dim, dim, kernel_size, dilation=dil, mode=mode,
                          weight_norm=weight_norm, use_bias=False, in_delay=d,
                          stream_batch=stream_batch)
            layers += [make_activation(activation, dim), conv]
            d = conv.delay
        self.net = Residual(Sequential(layers), d, dim, stream_batch)

    def forward(self, x):
        return self.net(x)

    def step(self, x):
        return self.net.step(x)


class ResidualStack(nn.Module):
    """The sum of one chain of ResidualLayers per kernel size, delay-aligned
    when streaming (reference rave/blocks.py:115-164)."""

    def __init__(self, dim: int, kernel_sizes, dilations_list, mode: str = "centered",
                 weight_norm: bool = True, activation: str = "leaky_relu",
                 stream_batch: int = 1):
        super().__init__()
        blocks_, delays = [], []
        for k in kernel_sizes:
            chain = [ResidualLayer(dim, k, tuple(dils), mode, weight_norm, activation,
                                   stream_batch) for dils in dilations_list]
            blocks_.append(Sequential(chain))
            delays.append(sum(layer.inner_delay for layer in chain))
        self.inner_delay = max(delays)
        self.aligned = AlignBranches(blocks_, delays, [dim] * len(blocks_), stream_batch)

    def forward(self, x):
        return sum(self.aligned(x))

    def step(self, x):
        return sum(self.aligned.step(x))


class UpsampleLayer(nn.Module):
    """act, then a transposed conv (kernel 2r, stride r) when r > 1, else a
    conv of kernel 3 (reference rave/blocks.py:167-195)."""

    def __init__(self, in_dim: int, out_dim: int, ratio: int, mode: str = "centered",
                 weight_norm: bool = True, activation: str = "leaky_relu", in_delay: int = 0,
                 stream_batch: int = 1):
        super().__init__()
        conv = dict(mode=mode, weight_norm=weight_norm, use_bias=False, in_delay=in_delay,
                    stream_batch=stream_batch)
        up = (ConvTranspose1d(in_dim, out_dim, ratio, **conv) if ratio > 1
              else Conv1d(in_dim, out_dim, 3, **conv))
        self.delay = up.delay
        self.net = Sequential([make_activation(activation, in_dim), up])

    def forward(self, x):
        return self.net(x)

    def step(self, x):
        return self.net.step(x)


class NoiseGenerator(FilteredNoise):
    """v1's filtered-noise synth (reference rave/blocks.py:198-240,
    rave_tpu/models/blocks.py:946-999): strided convs (kernel 3, stride r,
    the model's padding mode) at the hidden width, leaky ReLU between,
    to band amplitudes [B, data_size*noise_bands, T / prod(ratios)], then
    `FilteredNoise`'s synthesis: [B, data_size, T]. `data_size` counts the
    channels in (dec_data_size * n_channels)."""

    def __init__(self, in_size: int, data_size: int, ratios: Sequence[int] = (4, 4, 4),
                 noise_bands: int = 5, mode: str = "centered", in_delay: int = 0,
                 stream_batch: int = 1):
        super().__init__()
        self.ratios, self.noise_bands, self.in_delay = tuple(ratios), noise_bands, in_delay
        self.mode, self.out_channels = mode, data_size
        self.target_size = math.prod(self.ratios)
        chans = [in_size] * len(self.ratios) + [data_size * noise_bands]
        layers, d = [], in_delay
        for i, r in enumerate(self.ratios):
            conv = Conv1d(chans[i], chans[i + 1], 3, stride=r, mode=mode, use_bias=False,
                          in_delay=d, stream_batch=stream_batch)
            layers.append(conv)
            d = conv.delay
            if i != len(self.ratios) - 1:
                layers.append(Lambda(leaky_relu))
        self.net = Sequential(layers)

    @property
    def delay(self) -> int:
        return noise_generator_delay(self.in_delay, self.ratios, self.mode)


class EncoderV1(nn.Module):
    """Strided conv encoder with BatchNorm, or SampleNorm (reference
    rave/blocks.py:424-503, rave_tpu/models/blocks.py:1002-1106): conv 7,
    then per ratio r (norm, act, conv 2r+1 stride r doubling the width),
    `repeat_layers - 1` times more (norm, act, conv 3) per ratio, act, an
    optional GRU and act, and a final conv 5 in `n_out` groups. Input [B,
    data_size*n_channels, T], output [B, latent_size*n_out, T/prod(ratios)]."""

    def __init__(self, data_size: int, capacity: int, latent_size: int, ratios: Sequence[int],
                 n_out: int, sample_norm: bool = False, repeat_layers: int = 1,
                 n_channels: int = 1, recurrent_layers: int = 0, mode: str = "centered",
                 in_delay: int = 0, stream_batch: int = 1):
        super().__init__()
        self.ratios, self.repeat_layers = tuple(ratios), repeat_layers
        self.mode, self.in_delay = mode, in_delay
        conv = dict(mode=mode, use_bias=False, stream_batch=stream_batch)

        def norm(dim):
            return SampleNorm() if sample_norm else BatchNorm1d(dim)

        conv0 = Conv1d(data_size * n_channels, capacity, 7, in_delay=in_delay, **conv)
        layers, d, dim = [conv0], conv0.delay, capacity
        for r in self.ratios:
            out_dim = 2 * dim
            down = Conv1d(dim, out_dim, 2 * r + 1, stride=r, in_delay=d, **conv)
            layers += [norm(dim), Lambda(leaky_relu), down]
            d = down.delay
            for _ in range(repeat_layers - 1):
                same = Conv1d(out_dim, out_dim, 3, in_delay=d, **conv)
                layers += [norm(out_dim), Lambda(leaky_relu), same]
                d = same.delay
            dim = out_dim
        layers.append(Lambda(leaky_relu))
        if recurrent_layers:
            layers += [GRU(dim, recurrent_layers, stream_batch), Lambda(leaky_relu)]
        layers.append(Conv1d(dim, latent_size * n_out, 5, groups=n_out, in_delay=d, **conv))
        self.net = Sequential(layers)

    @property
    def delay(self) -> int:
        return encoder_v1_delay(self.in_delay, self.ratios, self.repeat_layers, self.mode)

    def forward(self, x):
        return self.net(x)

    def step(self, x):
        return self.net.step(x)


class GeneratorV1(nn.Module):
    """The v1 synth (reference rave/blocks.py:322-421,
    rave_tpu/models/blocks.py:1109-1248): conv 7 from the latent (then an
    optional GRU), per ratio an UpsampleLayer halving the width and a
    ResidualStack, then three branches side by side (`synth`, an
    AlignBranches): the waveform conv 7, the loudness conv (kernel
    2 loud_stride + 1, stride loud_stride; its frames repeated
    loud_stride times) and, with `use_noise`, the NoiseGenerator. The
    output [B, data_size*n_channels, T] is tanh(wave) mod_sigmoid(loud),
    plus the noise once warmed up (`warmed_up`; the noise branch runs and
    takes its `uniform` draws either way); `step` always adds it."""

    def __init__(self, latent_size: int, capacity: int, data_size: int, ratios: Sequence[int],
                 loud_stride: int = 1, use_noise: bool = True, noise_ratios=(4, 4, 4),
                 noise_bands: int = 5, res_kernel_sizes=(3,),
                 res_dilations=((1, 1), (3, 1), (5, 1)), n_channels: int = 1,
                 recurrent_layers: int = 0, mode: str = "centered", weight_norm: bool = True,
                 activation: str = "leaky_relu", stream_batch: int = 1):
        super().__init__()
        self.ratios, self.loud_stride, self.use_noise = tuple(ratios), loud_stride, use_noise
        self.noise_ratios, self.mode = tuple(noise_ratios), mode
        self.res_kernel_sizes = tuple(res_kernel_sizes)
        self.res_dilations = tuple(tuple(d) for d in res_dilations)
        conv = dict(mode=mode, weight_norm=weight_norm, use_bias=False, stream_batch=stream_batch)
        ch = 2 ** len(self.ratios) * capacity
        conv0 = Conv1d(latent_size, ch, 7, **conv)
        layers, d = [conv0], conv0.delay
        if recurrent_layers:
            layers.append(GRU(ch, recurrent_layers, stream_batch))
        for r in self.ratios:
            up = UpsampleLayer(ch, ch // 2, r, mode, weight_norm, activation, d, stream_batch)
            stack = ResidualStack(ch // 2, self.res_kernel_sizes, self.res_dilations, mode,
                                  weight_norm, activation, stream_batch)
            layers += [up, stack]
            d, ch = up.delay + stack.inner_delay, ch // 2
        self.net = Sequential(layers)
        out = data_size * n_channels
        wave = Conv1d(ch, out, 7, in_delay=d, **conv)
        loud = Conv1d(ch, 1, 2 * loud_stride + 1, stride=loud_stride, in_delay=d, **conv)
        branches, delays = [wave, loud], [wave.delay - d, loud.delay * loud_stride - d]
        features = [out, 1]
        if use_noise:
            noise = NoiseGenerator(ch, out, noise_ratios, noise_bands, mode, d, stream_batch)
            branches.append(noise)
            delays.append(noise.delay - d)
            features.append(out)
        self.synth = AlignBranches(branches, delays, features, stream_batch)

    @property
    def delay(self) -> int:
        return generator_v1_delay(self.ratios, self.res_kernel_sizes, self.res_dilations,
                                  self.loud_stride, self.use_noise, self.noise_ratios, self.mode)

    def _draws(self, uniform: Optional[torch.Tensor]) -> tuple:
        if not self.use_noise:
            return ()
        if uniform is None:
            raise ValueError("the noise branch takes its uniform draws as an input "
                             "(LatentDraws.uniform, train/steps.py::draw_noise)")
        return (uniform,)

    def _mix(self, outs, warmed_up: bool) -> torch.Tensor:
        """tanh(wave) mod_sigmoid(loud), computed in float32 (float64 for a
        float64 pass) and rounded to the waveform's dtype once (XLA fuses
        these elementwise ops of the JAX package's bf16 step), plus the
        float32 noise once warmed up."""
        wave, loud = outs[0], outs[1]
        if self.loud_stride != 1:
            loud = torch.repeat_interleave(loud, self.loud_stride, dim=-1)
        y = (torch.tanh(at_least_float32(wave)) * mod_sigmoid(at_least_float32(loud))
             ).to(wave.dtype)
        return y + outs[2] if warmed_up and self.use_noise else y

    def forward(self, z, uniform: Optional[torch.Tensor] = None, warmed_up: bool = True):
        return self._mix(self.synth(self.net(z), *self._draws(uniform)), warmed_up)

    def step(self, z, uniform: Optional[torch.Tensor] = None):
        return self._mix(self.synth.step(self.net.step(z), *self._draws(uniform)), True)


@dataclass
class LatentDraws:
    """What a model draws for one pass over latents [B, D, T]; the fields it
    does not read stay None. `eps` [B, D, T] is the variational noise, or
    the wasserstein MMD's reference sample; `noise` [B, noise_augmentation,
    T] the augmentation channels; `init_idx` and `expire_idx`
    [num_quantizers, codebook_size] the discrete codebooks' k-means and
    dead-code sample rows, indices into the B*T latent vectors (b-major);
    `uniform` the decoder's noise synth's draws in [0, 1)
    (`RaveConfig.noise_shape`). `train/steps.py::draw_noise` draws them."""

    eps: Optional[torch.Tensor] = None
    noise: Optional[torch.Tensor] = None
    init_idx: Optional[torch.Tensor] = None
    expire_idx: Optional[torch.Tensor] = None
    uniform: Optional[torch.Tensor] = None

    def to(self, device) -> "LatentDraws":
        return LatentDraws(*(None if t is None else t.to(device) for t in
                             (self.eps, self.noise, self.init_idx, self.expire_idx,
                              self.uniform)))


def unit_norm_vector_to_angles(x: torch.Tensor) -> torch.Tensor:
    """Unit hypersphere -> normalized angles in [-1, 1] (reference
    rave/blocks.py:933-946, exported spherical latents): [B, C, T] -> [B, C-1, T]."""
    tail = torch.sqrt(torch.flip(torch.cumsum(torch.flip(x**2, [1]), 1), [1]) + 1e-12)
    ang = torch.arccos(torch.clamp(x[:, :-1] / tail[:, :-1], -1.0, 1.0))  # t_k = ||x[k:]||
    last = torch.where(x[:, -1:] >= 0, ang[:, -1:], 2 * math.pi - ang[:, -1:])
    ang = torch.cat([ang[:, :-1] / math.pi, last / (2 * math.pi)], dim=1)
    return 2 * (ang - 0.5)


def angles_to_unit_norm_vector(angles: torch.Tensor) -> torch.Tensor:
    """Inverse of `unit_norm_vector_to_angles` (reference rave/blocks.py:949-963):
    [B, C-1, T] -> [B, C, T]."""
    a = (angles / 2 + 0.5) % 1
    a = torch.cat([a[:, :-1] * math.pi, a[:, -1:] * (2 * math.pi)], dim=1)
    cos, sin = torch.cos(a), torch.cumprod(torch.sin(a), dim=1)
    cos = torch.cat([cos, torch.ones_like(cos[:, :1])], dim=1)
    sin = torch.cat([torch.ones_like(sin[:, :1]), sin], dim=1)
    return cos * sin


class LatentFamily(nn.Module):
    """The latent wrapper around an encoder: `forward` (the encoder, frozen
    after the warmup where the family freezes it), `step` and
    `reparametrize(z, draws, quantize, train) -> (latent, regularization,
    updates)`. `updates` is the state a training call computed in place of
    writing it (the discrete codebooks; None for the other families): the
    train step hands it to the family's `commit` after its backward."""

    family = ""
    freeze_when_warmed = True

    def __init__(self, encoder: nn.Module):
        super().__init__()
        self.encoder = encoder

    @property
    def delay(self) -> int:
        return self.encoder.delay

    def forward(self, x, warmed_up: bool = False):
        """After the warmup the encoder is frozen: the JAX package stops its
        gradient; here it runs without a graph, which gives the same
        gradients (none) and keeps no activations."""
        if warmed_up and self.freeze_when_warmed:
            with torch.no_grad():
                return self.encoder(x)
        return self.encoder(x)

    def step(self, x):
        return self.encoder.step(x)


class VariationalEncoder(LatentFamily):
    """Gaussian reparameterization + closed-form KL (reference rave/blocks.py:717-745).

    `encoder` outputs 2*latent channels (mean ++ scale); std = softplus(scale) + 1e-4.
    """

    family = "variational"

    def reparametrize(self, z: torch.Tensor, draws: LatentDraws, quantize: bool = True,
                      train: bool = False):
        """(mean + std * eps, KL, None)."""
        mean, scale = z.chunk(2, dim=1)
        std = F.softplus(scale) + 1e-4
        var = std * std
        kl = torch.mean(torch.sum(mean * mean + var - torch.log(var) - 1, dim=1))
        return mean + std * draws.eps.to(mean.dtype), kl, None


def _augment(z: torch.Tensor, draws: LatentDraws, channels: int) -> torch.Tensor:
    """z with `channels` noise channels appended (the decoder's extra input)."""
    return torch.cat([z, draws.noise.to(z.dtype)], dim=1) if channels else z


class WassersteinEncoder(LatentFamily):
    """MMD (RBF kernel) regularization against N(0, 1), and noise
    augmentation (reference rave/blocks.py:748-791)."""

    family = "wasserstein"

    def __init__(self, encoder: nn.Module, noise_augmentation: int = 0):
        super().__init__(encoder)
        self.noise_augmentation = noise_augmentation

    @staticmethod
    def _mean_kernel(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        k = torch.mean((x[:, None] - y[None]) ** 2, dim=-1) / x.shape[-1]
        return torch.mean(torch.exp(-k))

    def reparametrize(self, z: torch.Tensor, draws: LatentDraws, quantize: bool = True,
                      train: bool = False):
        """(z with its noise channels, MMD of z's B*T vectors against eps, None);
        under data parallelism over the global batch's vectors, in rank order."""
        D = z.shape[1]
        flat = mesh.gather_rows(z.transpose(1, 2).reshape(-1, D))
        ref = mesh.gather_rows(draws.eps.to(z.dtype).transpose(1, 2).reshape(-1, D))
        mmd = (self._mean_kernel(flat, flat) + self._mean_kernel(ref, ref)
               - 2 * self._mean_kernel(flat, ref))
        return _augment(z, draws, self.noise_augmentation), mmd, None


class DiscreteEncoder(LatentFamily):
    """The RVQ latent with a schedule-gated `quantize` and noise augmentation
    (reference rave/blocks.py:794-830). The RVQ runs on the latent's B*T
    vectors, [B, T, D]."""

    family = "discrete"

    def __init__(self, encoder: nn.Module, num_quantizers: int, codebook_size: int,
                 latent_size: int, noise_augmentation: int = 0):
        super().__init__(encoder)
        self.noise_augmentation = noise_augmentation
        self.rvq = ResidualVectorQuantization(num_quantizers, latent_size, codebook_size)

    def reparametrize(self, z: torch.Tensor, draws: LatentDraws, quantize: bool = True,
                      train: bool = False):
        """(quantized z with its noise channels, commitment loss, the codebooks'
        new states when `train`); z passes as it is when not `quantize`."""
        diff, updates = z.new_zeros((), dtype=torch.float32), None
        if quantize:
            q, diff, _, updates = self.rvq(z.transpose(1, 2), draws.init_idx, draws.expire_idx,
                                           train)
            z = q.transpose(1, 2)
        return _augment(z, draws, self.noise_augmentation), diff, updates

    def commit(self, updates) -> None:
        self.rvq.commit(updates)

    def encode_indices(self, z: torch.Tensor) -> torch.Tensor:
        """Latents [B, D, T] -> code indices [B, Q, T]."""
        return self.rvq.encode(z.transpose(1, 2))

    def decode_indices(self, idx: torch.Tensor) -> torch.Tensor:
        """Code indices [B, Q, T] -> latents [B, D, T]."""
        return self.rvq.decode(idx).transpose(1, 2)


class SphericalEncoder(LatentFamily):
    """L2-normalized latents, zero regularization (reference
    rave/blocks.py:833-849). As in the JAX package its encoder is not
    frozen after the warmup."""

    family = "spherical"
    freeze_when_warmed = False

    def reparametrize(self, z: torch.Tensor, draws: LatentDraws = None, quantize: bool = True,
                      train: bool = False):
        norm = torch.sqrt(torch.sum(z * z, dim=1, keepdim=True))
        return z / norm, z.new_zeros(()), None
