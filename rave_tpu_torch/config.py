"""Configuration of the port's serving path, training step and training loop.

The part of rave_tpu/config.py the port reads, owned by the port so that
nothing here depends on the JAX package: the fields `factory.build_rave`,
`factory.build_discriminator` / `build_audio_distance`, the train step and
the training driver read, with the same names, defaults and resolved
accessors, and the presets the port builds: `v1` (EncoderV1 with
BatchNorm, GeneratorV1 with its filtered-noise synth), its small noiseless
`onnx` and `raspberry`, `v2`, `v3` (v2 with Snake,
AdaIN and the descript critic), `causal`, `normalize_ambient` (a static
compressor appended to the augmentations), the latent families `discrete`,
`discrete_v3`, `wasserstein` and `spherical`, and the option presets
`snake`, `adain` and `descript_discriminator`, and the v2 variants: the
noise synth (`noise`, `v2_small`), raw-waveform output (`v2_nopqmf`,
`v2_nopqmf_small`) and mel input (`v2_with_augs`, `hybrid`, whose decoder
has a 2-layer GRU).
`compose(names, overrides)` stacks presets and applies dotted overrides as
the reference does (`compose(["v2", "causal"], ["capacity=2",
"ratios=[4,4,2]"])`). `snapshot` / `config_hash` / `from_dict` write and
read a run's `config.json` as the JAX package's do; the hash covers the
port's fields only, so a port run dir is named differently from a JAX run
dir of the same settings. tests/test_torch_config.py holds every field and
accessor equal to the JAX package's for these presets.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclass
class EncoderConfig:
    kind: str = "v2"  # v1 | v2
    capacity: Optional[int] = None  # None -> cfg.capacity
    ratios: Optional[Tuple[int, ...]] = None  # None -> cfg.ratios
    data_size: Optional[int] = None  # None -> n_band (pqmf) / n_mels (mel) / 1
    dilations: Optional[Tuple] = None  # None -> cfg.dilations
    kernel_size: Optional[int] = None  # None -> cfg.kernel_size
    keep_dim: bool = False
    sample_norm: bool = False  # v1: SampleNorm in place of BatchNorm
    repeat_layers: int = 1  # v1: convs per stride
    recurrent_layers: int = 0
    use_adain: bool = False


@dataclass
class LatentConfig:
    family: str = "variational"  # variational | wasserstein | discrete | spherical
    noise_augmentation: int = 0
    # discrete
    num_quantizers: int = 16
    codebook_size: int = 1024


@dataclass
class DecoderConfig:
    kind: str = "v2"  # v1 | v2
    capacity: Optional[int] = None
    ratios: Optional[Tuple[int, ...]] = None
    keep_dim: bool = False
    amplitude_modulation: bool = True
    use_noise: bool = False  # v2 NoiseGeneratorV2 branch
    noise_hidden: int = 64
    noise_ratios: Tuple[int, ...] = (2, 2, 2)
    noise_bands: int = 5
    recurrent_layers: int = 0
    use_adain: bool = False
    # v1 specifics
    loud_stride: int = 1
    use_noise_v1: bool = True
    v1_noise_ratios: Tuple[int, ...] = (4, 4, 4)
    v1_noise_bands: int = 5
    res_kernel_sizes: Tuple[int, ...] = (3,)
    res_dilations: Tuple[Tuple[int, ...], ...] = ((1, 1), (3, 1), (5, 1))


@dataclass
class DiscriminatorConfig:
    kind: str = "multiscale"  # multiscale | combined | descript (ported); spectral
    capacity: Optional[int] = None  # None -> cfg.capacity
    n_layers: int = 4
    kernel_size: int = 15
    stride: int = 4
    n_scales: int = 3
    periods: Tuple[int, ...] = (2, 3, 5, 7, 11)
    period_kernel: Tuple[int, int] = (5, 1)
    # descript
    descript_periods: Tuple[int, ...] = (2, 3, 5, 7, 11)
    descript_fft_sizes: Tuple[int, ...] = (2048, 1024, 512)


@dataclass
class DistanceConfig:
    kind: str = "v1"  # v1 (ported) | encodec | instantaneous
    scales: Tuple[int, ...] = (2048, 1024, 512, 256, 128)
    log_epsilon: float = 1e-7
    num_mels: Optional[int] = None


@dataclass
class TrainConfig:
    phase_1_duration: int = 1_000_000
    warmup_quantize: Optional[int] = None
    update_discriminator_every: int = 2
    gan_loss: str = "hinge"  # hinge | ls | nonsaturating
    valid_signal_crop: bool = False
    num_skipped_features: int = 0
    feature_matching_relative: bool = False
    weights: Dict[str, float] = field(
        default_factory=lambda: {
            "audio_distance": 1.0,
            "multiband_audio_distance": 1.0,
            "adversarial": 1.0,
            "feature_matching": 10.0,
        }
    )
    beta_initial: float = 0.1
    beta_target: float = 0.1
    beta_warmup_len: int = 1
    beta_log_warmup: bool = True
    gen_lr: float = 1e-3
    dis_lr: float = 1e-4
    adam_b1: float = 0.5
    adam_b2: float = 0.9
    lr_end_factor: float = 0.1  # LinearLR 1.0 -> 0.1 over phase 1
    max_steps: int = 6_000_000
    ema: Optional[float] = None
    remat: bool = False  # recompute the autoencode pass in the backward
    bf16: bool = False  # the model computes in bfloat16 (train/steps.py)
    bf16_dis: bool = False  # the critic computes in bfloat16
    dis_full_metrics: bool = False  # distances on critic steps too (logging only)


@dataclass
class DataConfig:
    sampling_rate: int = 44100
    n_signal: int = 131072
    batch: int = 8
    augmentations: Tuple[str, ...] = ()
    n_channels: int = 1  # resolved at train time from the dataset's metadata
    derivative: bool = False
    normalize: bool = False
    rand_pitch: Optional[float] = None
    workers: int = 8


@dataclass
class RaveConfig:
    name: str = "v2"
    sampling_rate: int = 44100
    capacity: int = 96
    n_band: int = 16
    pqmf_attenuation: int = 100
    latent_size: int = 128
    ratios: Tuple[int, ...] = (4, 4, 4, 2)
    kernel_size: int = 3
    dilations: Tuple = ((1, 3, 9), (1, 3, 9), (1, 3, 9), (1, 3))
    mode: str = "centered"  # causal preset flips to 'causal'
    activation: str = "leaky_relu"
    weight_norm: bool = True
    input_mode: str = "pqmf"  # pqmf | mel | raw
    output_mode: str = "pqmf"  # pqmf | raw
    mel_n_fft: int = 2048
    mel_hop: int = 256
    n_mels: int = 128
    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    latent: LatentConfig = field(default_factory=LatentConfig)
    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    discriminator: DiscriminatorConfig = field(default_factory=DiscriminatorConfig)
    distance: DistanceConfig = field(default_factory=DistanceConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    data: DataConfig = field(default_factory=DataConfig)

    def enc_capacity(self) -> int:
        return self.encoder.capacity or self.capacity

    def dec_capacity(self) -> int:
        return self.decoder.capacity or self.capacity

    def enc_ratios(self) -> Tuple[int, ...]:
        return tuple(self.encoder.ratios or self.ratios)

    def dec_ratios(self) -> Tuple[int, ...]:
        return tuple(self.decoder.ratios or self.ratios)

    def enc_data_size(self) -> int:
        if self.encoder.data_size is not None:
            return self.encoder.data_size
        if self.input_mode == "pqmf":
            return self.n_band
        return self.n_mels if self.input_mode == "mel" else 1

    def dec_data_size(self) -> int:
        return self.n_band if self.output_mode == "pqmf" else 1

    def num_latent_out(self) -> int:
        return 2 if self.latent.family == "variational" else 1

    def augmented_latent_size(self) -> int:
        if self.latent.family in ("wasserstein", "discrete"):
            return self.latent_size + self.latent.noise_augmentation
        return self.latent_size

    def decimation(self) -> int:
        """Total waveform -> latent decimation."""
        front = {"pqmf": self.n_band, "mel": self.mel_hop}.get(self.input_mode, 1)
        return math.prod(self.enc_ratios()) * front

    def noise_shape(self, n_channels: int, batch: int, latent_frames: int):
        """The shape of the noise synth's uniform draws (`LatentDraws.uniform`)
        for a latent of `latent_frames` frames: [batch, noise frames,
        dec_data_size * n_channels, prod(noise_ratios)] (v1's
        `v1_noise_ratios`); None without it."""
        ratios = self.noise_ratios()
        if ratios is None:
            return None
        target = math.prod(ratios)
        frames = latent_frames * math.prod(self.dec_ratios()) // target
        return batch, frames, self.dec_data_size() * n_channels, target

    def noise_ratios(self) -> Optional[Tuple[int, ...]]:
        """The decoder's noise synth's strides (v1's or v2's), None without one."""
        d = self.decoder
        if d.kind == "v1":
            return tuple(d.v1_noise_ratios) if d.use_noise_v1 else None
        return tuple(d.noise_ratios) if d.kind == "v2" and d.use_noise else None

    def block_size(self) -> int:
        """Minimum streaming block in waveform samples: lcm of the encoder
        decimation, the decoder upsampling, the PQMF 2-frame parity and the
        decoder's strided branches (the noise synth, v1's loudness stride).
        Strided streaming convs drop input that is not a whole number of
        their frames, so a block hands each branch whole frames: it runs at
        the decoder's frame rate (n_band samples per frame under pqmf
        output) and downsamples by prod(noise ratios) or `loud_stride`."""
        band = self.n_band if self.output_mode == "pqmf" else 1
        b = math.lcm(self.decimation(), math.prod(self.dec_ratios()) * band)
        if self.input_mode == "pqmf" or self.output_mode == "pqmf":
            b = math.lcm(b, 2 * self.n_band)
        ratios = self.noise_ratios()
        if ratios is not None:
            b = math.lcm(b, band * math.prod(ratios))
        if self.decoder.kind == "v1" and self.decoder.loud_stride > 1:
            b = math.lcm(b, band * self.decoder.loud_stride)
        return b


PRESETS: Dict[str, Callable[[RaveConfig], None]] = {}


def preset(name: str):
    def deco(fn):
        PRESETS[name] = fn
        return fn

    return deco


@preset("v1")
def _v1(c: RaveConfig):
    """rave/configs/v1.gin: EncoderV1 (BatchNorm) and GeneratorV1 (its
    filtered-noise synth on) at capacity 64, the multiscale critic."""
    c.name = "v1"
    c.capacity = 64
    c.n_band = 16
    c.latent_size = 128
    c.ratios = (4, 4, 4, 2)
    c.encoder.kind = "v1"
    c.decoder.kind = "v1"
    c.latent.family = "variational"
    c.discriminator = DiscriminatorConfig(kind="multiscale", capacity=64)
    t = c.train
    t.phase_1_duration = 1_000_000
    t.update_discriminator_every = 2
    t.valid_signal_crop = False
    t.num_skipped_features = 0
    t.feature_matching_relative = False
    t.weights["feature_matching"] = 10.0
    t.beta_initial = t.beta_target = 0.1
    t.beta_warmup_len = 1


@preset("v2")
def _v2(c: RaveConfig):
    """rave/configs/v2.gin, which includes v1.gin."""
    _v1(c)
    c.name = "v2"
    c.capacity = 96
    c.kernel_size = 3
    c.dilations = ((1, 3, 9), (1, 3, 9), (1, 3, 9), (1, 3))
    c.encoder.kind = "v2"
    c.decoder.kind = "v2"
    c.decoder.amplitude_modulation = True
    c.discriminator = DiscriminatorConfig(kind="combined", capacity=96)
    t = c.train
    t.update_discriminator_every = 4
    t.valid_signal_crop = True
    t.num_skipped_features = 1
    t.feature_matching_relative = True
    t.weights["feature_matching"] = 20.0
    t.beta_initial = 1e-6
    t.beta_target = 5e-2
    t.beta_warmup_len = 20000


@preset("v2_small")
def _v2_small(c: RaveConfig):
    """rave/configs/v2_small.gin: capacity 48, ratios 4.2.2.2, the noise
    synth with 32 bands."""
    _v2(c)
    c.name = "v2_small"
    c.capacity = 48
    c.ratios = (4, 2, 2, 2)
    c.discriminator.capacity = 48
    c.decoder.use_noise = True
    c.decoder.noise_hidden = 64
    c.decoder.noise_ratios = (2, 2, 2)
    c.decoder.noise_bands = 32
    c.train.update_discriminator_every = 2
    c.train.beta_initial = c.train.beta_target = 0.01
    c.train.beta_warmup_len = 300_000


RANDOM_COMPRESS = '{"type":"RandomCompress","threshold":-40,"amp_range":[-60,-10],"prob":0.5}'


@preset("v2_nopqmf")
def _v2_nopqmf(c: RaveConfig):
    """rave/configs/v2_nopqmf.gin: the decoder writes the raw waveform
    (ratios 8.8.8.4), with RandomCompress (its lines 34-42)."""
    _v2(c)
    c.name = "v2_nopqmf"
    c.capacity = 64
    c.encoder.ratios = (4, 4, 4, 2)
    c.decoder.ratios = (8, 8, 8, 4)
    c.discriminator.capacity = 64
    c.output_mode = "raw"
    c.train.beta_initial = 1e-6
    c.train.beta_target = 1e-2
    c.train.beta_warmup_len = 500_000
    c.data.augmentations = (RANDOM_COMPRESS,)


@preset("v2_nopqmf_small")
def _v2_nopqmf_small(c: RaveConfig):
    """rave/configs/v2_nopqmf_small.gin: v1's base with v2 blocks at capacity
    64, PQMF on the encoder side only, raw decoder ratios 8.8.8.4, phase 1
    of 500k steps and a fixed beta of 0.02 (rave_tpu/config.py:343-376)."""
    _v2(c)
    c.name = "v2_nopqmf_small"
    c.capacity = 64
    c.encoder.ratios = (4, 4, 4, 2)
    c.decoder.ratios = (8, 8, 8, 4)
    c.discriminator.capacity = 64
    c.output_mode = "raw"
    c.train.phase_1_duration = 500_000
    c.train.beta_initial = c.train.beta_target = 0.02
    c.train.beta_warmup_len = 1
    c.data.augmentations = (RANDOM_COMPRESS,)


def _mel_input(c: RaveConfig):
    """Mel-spectrogram input: 2048-point FFT, hop 256, 128 mels, encoder
    ratios 2.2.2."""
    c.input_mode = "mel"
    c.mel_n_fft = 2048
    c.mel_hop = 256
    c.n_mels = 128
    c.encoder.ratios = (2, 2, 2)


@preset("v2_with_augs")
def _v2_with_augs(c: RaveConfig):
    """rave/configs/v2_with_augs.gin: mel input, with v1's loss weights and
    fixed beta (it includes v1.gin, not v2.gin) and RandomCompress."""
    _v2(c)
    c.name = "v2_with_augs"
    _mel_input(c)
    c.train.weights["feature_matching"] = 10.0
    c.train.beta_initial = c.train.beta_target = 0.1
    c.train.beta_warmup_len = 1
    c.data.augmentations = (RANDOM_COMPRESS,)


@preset("hybrid")
def _hybrid(c: RaveConfig):
    """rave/configs/hybrid.gin: mel input, encoder dilations (1,), a 2-layer
    GRU at the decoder's input."""
    _v2(c)
    c.name = "hybrid"
    _mel_input(c)
    c.encoder.dilations = (1,)
    c.decoder.recurrent_layers = 2


@preset("v3")
def _v3(c: RaveConfig):
    """rave/configs/v3.gin = v2 + adain + snake + descript."""
    _v2(c)
    c.name = "v3"
    _snake(c)
    _adain(c)
    _descript(c)
    c.train.beta_initial = 1e-6
    c.train.beta_target = 5e-2
    c.train.beta_warmup_len = 20000


@preset("discrete")
def _discrete(c: RaveConfig):
    """rave/configs/discrete.gin: v2 with ratios 4.4.2.2 and a 16 x 1024 RVQ."""
    _v2(c)
    c.name = "discrete"
    c.ratios = (4, 4, 2, 2)
    c.latent_size = 128
    c.capacity = 96
    c.latent.family = "discrete"
    c.latent.num_quantizers = 16
    c.latent.codebook_size = 1024
    c.latent.noise_augmentation = 128
    c.distance.log_epsilon = 1.0
    c.train.phase_1_duration = 200_000
    c.train.warmup_quantize = -1
    c.train.num_skipped_features = 0
    c.train.update_discriminator_every = 4
    c.train.beta_initial = c.train.beta_target = 0.1
    c.train.beta_warmup_len = 1


@preset("discrete_v3")
def _discrete_v3(c: RaveConfig):
    """rave/configs/discrete_v3.gin: discrete with Snake and the descript critic."""
    _discrete(c)
    c.name = "discrete_v3"
    _snake(c)
    _descript(c)
    # discrete_v3.gin re-overrides BetaWarmupCallback after its includes
    # (reference configs/discrete_v3.gin:9-12), undoing discrete's fixed beta.
    c.train.beta_initial = 1e-6
    c.train.beta_target = 5e-2
    c.train.beta_warmup_len = 20000


@preset("wasserstein")
def _wasserstein(c: RaveConfig):
    """rave/configs/wasserstein.gin (applied on top of v2)."""
    c.name = "wasserstein"
    c.latent_size = 16
    c.latent.family = "wasserstein"
    c.latent.noise_augmentation = 128
    c.train.phase_1_duration = 200_000
    c.train.weights.update({"fullband_spectral_distance": 2.0,
                            "multiband_spectral_distance": 2.0, "adversarial": 2.0})
    c.train.beta_initial = c.train.beta_target = 100.0
    c.train.beta_warmup_len = 1


@preset("spherical")
def _spherical(c: RaveConfig):
    """rave/configs/spherical.gin (applied on top of v2)."""
    c.name = "spherical"
    c.latent_size = 16
    c.latent.family = "spherical"
    c.train.phase_1_duration = 200_000


@preset("onnx")
def _onnx(c: RaveConfig):
    """rave/configs/onnx.gin: v1 at capacity 32 without the noise synth
    (its FFTs have no opset-12 lowering)."""
    _v1(c)
    c.name = "onnx"
    c.capacity = 32
    c.discriminator.capacity = 32
    c.decoder.use_noise_v1 = False


@preset("raspberry")
def _raspberry(c: RaveConfig):
    """rave/configs/raspberry.gin: onnx at capacity 16."""
    _onnx(c)
    c.name = "raspberry"
    c.capacity = 16
    c.discriminator.capacity = 16


@preset("normalize_ambient")
def _normalize_ambient(c: RaveConfig):
    """rave/configs/normalize_ambient.gin: a static sox-compand ambient
    normalizer (time 0.01,0.01, 6 dB knee, curve -30/-15 -10/-8 0/-5)
    appended to the augmentations."""
    c.data.augmentations = tuple(c.data.augmentations) + (
        '{"type":"Compress","time":"0.01,0.01","lookup":"6:-30,-15,-10,-8,0,-5"}',
    )


@preset("noise")
def _noise(c: RaveConfig):
    """rave/configs/noise.gin: NoiseGeneratorV2 in GeneratorV2."""
    c.decoder.use_noise = True
    c.decoder.noise_hidden = 128
    c.decoder.noise_ratios = (2, 2, 2)
    c.decoder.noise_bands = 5


@preset("causal")
def _causal(c: RaveConfig):
    """rave/configs/causal.gin: zero-lookahead convs everywhere."""
    c.mode = "causal"
    c.name = c.name + "_causal"


@preset("snake")
def _snake(c: RaveConfig):
    c.activation = "snake"


@preset("adain")
def _adain(c: RaveConfig):
    c.encoder.use_adain = True
    c.decoder.use_adain = True


@preset("descript_discriminator")
def _descript(c: RaveConfig):
    c.discriminator.kind = "descript"


def compose(names: List[str], overrides: Optional[List[str]] = None) -> RaveConfig:
    """Stack presets in order, then apply dotted overrides."""
    cfg = RaveConfig()
    for n in names:
        if n not in PRESETS:
            raise KeyError(f"preset {n!r} is not ported (have {sorted(PRESETS)}; "
                           "ROADMAP A11: the spectral critic)")
        PRESETS[n](cfg)
    for ov in overrides or []:
        apply_override(cfg, ov)
    up = math.prod(cfg.dec_ratios()) * (cfg.n_band if cfg.output_mode == "pqmf" else 1)
    if up != cfg.decimation():
        raise ValueError(f"config is not rate-preserving: encoder decimation "
                         f"{cfg.decimation()} != decoder upsampling {up}")
    return cfg


def _parse_value(s: str) -> Any:
    try:
        return json.loads(s)
    except json.JSONDecodeError:
        return s


def apply_override(cfg: RaveConfig, assignment: str) -> None:
    """'capacity=2' / 'ratios=[4,4,2]' / 'decoder.use_noise=true' style."""
    path, _, raw = assignment.partition("=")
    obj = cfg
    parts = path.strip().split(".")
    for p in parts[:-1]:
        obj = getattr(obj, p)
    if not hasattr(obj, parts[-1]):
        raise AttributeError(f"the port's config has no field {path.strip()!r}")
    val = _parse_value(raw.strip())
    if isinstance(val, list):
        val = tuple(tuple(v) if isinstance(v, list) else v for v in val)
    cur = getattr(obj, parts[-1])
    if isinstance(cur, dict) and isinstance(val, dict):
        cur.update(val)  # 'train.weights={"adversarial": 2.0}' updates one weight
    else:
        setattr(obj, parts[-1], val)


def to_dict(cfg: RaveConfig) -> dict:
    return dataclasses.asdict(cfg)


def snapshot(cfg: RaveConfig) -> str:
    """Canonical JSON snapshot (a run dir's config.json)."""
    return json.dumps(to_dict(cfg), indent=2, sort_keys=True, default=str)


def config_hash(cfg: RaveConfig) -> str:
    return hashlib.md5(snapshot(cfg).encode()).hexdigest()[:10]


def from_dict(d: dict) -> RaveConfig:
    """Inverse of `to_dict`; keys the port has no field for are ignored."""

    def build(cls, dd):
        kw = {}
        for f in dataclasses.fields(cls):
            if f.name not in dd:
                continue
            v = dd[f.name]
            if f.name in _SECTIONS:
                kw[f.name] = build(_SECTIONS[f.name], v)
            elif isinstance(v, list):
                kw[f.name] = tuple(tuple(x) if isinstance(x, list) else x for x in v)
            else:
                kw[f.name] = v
        return cls(**kw)

    return build(RaveConfig, d)


_SECTIONS = {"encoder": EncoderConfig, "latent": LatentConfig, "decoder": DecoderConfig,
             "discriminator": DiscriminatorConfig, "distance": DistanceConfig,
             "train": TrainConfig, "data": DataConfig}
