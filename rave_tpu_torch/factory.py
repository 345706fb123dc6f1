"""Factory: RaveConfig -> the port's model, critic and losses.

PyTorch port of rave_tpu/factory.py: `build_rave` (:151-175) for the v1
and v2 encoder and decoder kinds (with the noise synths and the GRUs), the three
input and two output modes, and the four latent families (`build_encoder`
picks the wrapper as :82-99 does);
`build_discriminator` (:178-232) for the `multiscale`, `combined` and
`descript` critics; `build_audio_distance` (:235-265) for `v1`; `build_gan_loss`
(:268-269). Configs come from the port's own `rave_tpu_torch.config.compose`.
Weights are drawn here from a seeded CPU `torch.Generator` (lecun-normal
`v`, `g = ||v||` per output channel, zero bias; a codebook's embed uniform
as flax's variance_scaling(1, fan_in); a GRU's as flax's GRUCell), never
from jax, and then
moved to `device`: the card unless the caller asks for the CPU, so the
same seed gives the same numbers on either.
"""
from __future__ import annotations

from functools import lru_cache

import torch

from rave_tpu_torch.config import RaveConfig
from rave_tpu_torch.models import blocks
from rave_tpu_torch.models.descript import DescriptDiscriminator
from rave_tpu_torch.models.discriminators import (
    CombineDiscriminators, MultiPeriodDiscriminator, MultiScaleDiscriminator,
)
from rave_tpu_torch.models.quantization import EuclideanCodebook
from rave_tpu_torch.models.rave import RAVE
from rave_tpu_torch.nn.conv import _WeightNormConv
from rave_tpu_torch.nn.gru import GRU
from rave_tpu_torch.ops.distances import AudioDistanceV1
from rave_tpu_torch.ops.dsp import GAN_LOSSES
from rave_tpu_torch.ops.pqmf import PQMFBank
from rave_tpu_torch.ops.stft import MultiScaleSTFT


@lru_cache(maxsize=8)
def get_pqmf_bank(attenuation: int, n_band: int) -> PQMFBank:
    return PQMFBank.build(attenuation, n_band)


def pqmf_analysis_delay(cfg: RaveConfig) -> int:
    """Streaming delay (input frames) of the encoder's front-end: PQMF
    analysis, or the mel frames' lag (`models/rave.py::MelAnalysis.delay`)."""
    if cfg.input_mode == "mel":
        return (cfg.mel_n_fft // 2 - cfg.mel_hop) // cfg.mel_hop
    if cfg.input_mode != "pqmf" or cfg.n_band == 1:
        return 0
    Q = get_pqmf_bank(cfg.pqmf_attenuation, cfg.n_band).taps
    return (Q - 1) - Q // 2 if cfg.mode == "centered" else 0


def build_encoder(cfg: RaveConfig, n_channels: int = 1, stream_batch: int = 1):
    kw = dict(data_size=cfg.enc_data_size(), capacity=cfg.enc_capacity(),
              ratios=cfg.enc_ratios(), latent_size=cfg.latent_size, n_out=cfg.num_latent_out(),
              n_channels=n_channels, mode=cfg.mode,
              recurrent_layers=cfg.encoder.recurrent_layers, in_delay=pqmf_analysis_delay(cfg),
              stream_batch=stream_batch)
    if cfg.encoder.kind == "v2":
        inner = blocks.EncoderV2(
            kernel_size=cfg.encoder.kernel_size or cfg.kernel_size,
            dilations=tuple(cfg.encoder.dilations or cfg.dilations),
            keep_dim=cfg.encoder.keep_dim,
            weight_norm=cfg.weight_norm,
            activation=cfg.activation,
            use_adain=cfg.encoder.use_adain,
            **kw,
        )
    elif cfg.encoder.kind == "v1":
        inner = blocks.EncoderV1(sample_norm=cfg.encoder.sample_norm,
                                 repeat_layers=cfg.encoder.repeat_layers, **kw)
    else:
        raise ValueError(f"unknown encoder kind {cfg.encoder.kind!r}")
    lat = cfg.latent
    if lat.family == "variational":
        return blocks.VariationalEncoder(inner)
    if lat.family == "wasserstein":
        return blocks.WassersteinEncoder(inner, lat.noise_augmentation)
    if lat.family == "discrete":
        return blocks.DiscreteEncoder(inner, lat.num_quantizers, lat.codebook_size,
                                      cfg.latent_size, lat.noise_augmentation)
    if lat.family == "spherical":
        return blocks.SphericalEncoder(inner)
    raise ValueError(f"unknown latent family {lat.family!r}")


def build_decoder(cfg: RaveConfig, n_channels: int = 1, stream_batch: int = 1):
    if cfg.decoder.kind == "v1":
        d = cfg.decoder
        return blocks.GeneratorV1(
            latent_size=cfg.augmented_latent_size(),
            capacity=cfg.dec_capacity(),
            data_size=cfg.dec_data_size(),
            ratios=cfg.dec_ratios(),
            loud_stride=d.loud_stride,
            use_noise=d.use_noise_v1,
            noise_ratios=d.v1_noise_ratios,
            noise_bands=d.v1_noise_bands,
            res_kernel_sizes=d.res_kernel_sizes,
            res_dilations=d.res_dilations,
            n_channels=n_channels,
            recurrent_layers=d.recurrent_layers,
            mode=cfg.mode,
            weight_norm=cfg.weight_norm,
            activation=cfg.activation,
            stream_batch=stream_batch,
        )
    if cfg.decoder.kind != "v2":
        raise ValueError(f"unknown decoder kind {cfg.decoder.kind!r}")
    return blocks.GeneratorV2(
        latent_size=cfg.augmented_latent_size(),
        capacity=cfg.dec_capacity(),
        ratios=cfg.dec_ratios(),
        kernel_size=cfg.kernel_size,
        dilations=tuple(cfg.dilations),
        data_size=cfg.dec_data_size(),
        keep_dim=cfg.decoder.keep_dim,
        n_channels=n_channels,
        amplitude_modulation=cfg.decoder.amplitude_modulation,
        use_noise=cfg.decoder.use_noise,
        noise_hidden=cfg.decoder.noise_hidden,
        noise_ratios=cfg.decoder.noise_ratios,
        noise_bands=cfg.decoder.noise_bands,
        mode=cfg.mode,
        weight_norm=cfg.weight_norm,
        activation=cfg.activation,
        use_adain=cfg.decoder.use_adain,
        recurrent_layers=cfg.decoder.recurrent_layers,
        stream_batch=stream_batch,
    )


def resolve_device(device: str | torch.device) -> torch.device:
    """`device` as a torch.device; a CUDA device without a card raises, so
    nothing is quietly built on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port builds on the card unless the "
                           "caller passes device='cpu'")
    return device


def init_weights(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Redraw every convolution's and GRU's weights and every codebook's
    initial embed from `generator`, in module order."""
    for m in model.modules():
        if isinstance(m, (_WeightNormConv, EuclideanCodebook, GRU)):
            m.reset_parameters(generator)


def build_rave(cfg: RaveConfig, n_channels: int = 1, stream_batch: int = 1,
               seed: int = 0, device: str | torch.device = "cuda") -> RAVE:
    """The RAVE on `device`, weights drawn from `torch.Generator().manual_seed(seed)`."""
    device = resolve_device(device)
    model = RAVE(
        encoder=build_encoder(cfg, n_channels, stream_batch),
        decoder=build_decoder(cfg, n_channels, stream_batch),
        pqmf=get_pqmf_bank(cfg.pqmf_attenuation, cfg.n_band),
        latent_size=cfg.latent_size,
        sampling_rate=cfg.sampling_rate,
        n_channels=n_channels,
        input_mode=cfg.input_mode,
        output_mode=cfg.output_mode,
        mel_n_fft=cfg.mel_n_fft,
        mel_hop=cfg.mel_hop,
        n_mels=cfg.n_mels,
        mode=cfg.mode,
        stream_batch=stream_batch,
    )
    init_weights(model, torch.Generator().manual_seed(seed))
    return model.to(device)


def build_discriminator(cfg: RaveConfig, n_channels: int = 1, seed: int = 0,
                        device: str | torch.device = "cuda") -> torch.nn.Module:
    """The critic on `device`, weights drawn from `torch.Generator().manual_seed(seed)`;
    its period critics folded (models/discriminators.py, models/descript.py)."""
    device = resolve_device(device)
    d = cfg.discriminator
    cap = d.capacity or cfg.capacity
    scales = dict(n_discriminators=d.n_scales, capacity=cap, n_layers=d.n_layers,
                  kernel_size=d.kernel_size, stride=d.stride)
    if d.kind == "multiscale":
        critic = MultiScaleDiscriminator(n_channels, **scales)
    elif d.kind == "combined":
        critic = CombineDiscriminators([
            MultiPeriodDiscriminator(n_channels, d.periods, cap, d.n_layers,
                                     tuple(d.period_kernel), d.stride),
            MultiScaleDiscriminator(n_channels, **scales),
        ])
    elif d.kind == "descript":  # no MSD rates, as rave_tpu/factory.py:223-231
        critic = DescriptDiscriminator(n_channels, d.descript_periods,
                                       fft_sizes=d.descript_fft_sizes)
    else:
        raise NotImplementedError(f"discriminator kind {d.kind!r} is not ported yet "
                                  "(ROADMAP A11, spectral)")
    init_weights(critic, torch.Generator().manual_seed(seed))
    return critic.to(device)


def build_audio_distance(cfg: RaveConfig) -> AudioDistanceV1:
    dist = cfg.distance
    if dist.kind != "v1":
        raise NotImplementedError(f"distance kind {dist.kind!r} is not ported yet (ROADMAP A11)")
    if dist.num_mels is not None:
        raise NotImplementedError("distance.num_mels (mel spectrograms) is not ported yet "
                                  "(ROADMAP A11)")
    return AudioDistanceV1(MultiScaleSTFT(tuple(dist.scales)), log_epsilon=dist.log_epsilon)


def build_gan_loss(cfg: RaveConfig):
    return GAN_LOSSES[cfg.train.gan_loss]
