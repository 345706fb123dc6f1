"""Configuration of the port's serving path, training step and training loop.

The part of rave_tpu/config.py the port reads, owned by the port so that
nothing here depends on the JAX package: the fields `factory.build_rave`,
`factory.build_discriminator` / `build_audio_distance`, the train step and
the training driver read, with the same names, defaults and resolved
accessors, and the two presets the port builds, `v2` and `causal`.
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
    kind: str = "v2"
    capacity: Optional[int] = None  # None -> cfg.capacity
    ratios: Optional[Tuple[int, ...]] = None  # None -> cfg.ratios
    data_size: Optional[int] = None  # None -> n_band (pqmf) / 1
    dilations: Optional[Tuple] = None  # None -> cfg.dilations
    kernel_size: Optional[int] = None  # None -> cfg.kernel_size
    keep_dim: bool = False
    recurrent_layers: int = 0
    use_adain: bool = False


@dataclass
class LatentConfig:
    family: str = "variational"
    noise_augmentation: int = 0


@dataclass
class DecoderConfig:
    kind: str = "v2"
    capacity: Optional[int] = None
    ratios: Optional[Tuple[int, ...]] = None
    keep_dim: bool = False
    amplitude_modulation: bool = True
    use_noise: bool = False
    recurrent_layers: int = 0
    use_adain: bool = False


@dataclass
class DiscriminatorConfig:
    kind: str = "multiscale"  # multiscale | combined (ported); spectral | descript
    capacity: Optional[int] = None  # None -> cfg.capacity
    n_layers: int = 4
    kernel_size: int = 15
    stride: int = 4
    n_scales: int = 3
    periods: Tuple[int, ...] = (2, 3, 5, 7, 11)
    period_kernel: Tuple[int, int] = (5, 1)


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
    input_mode: str = "pqmf"
    output_mode: str = "pqmf"
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
        return self.n_band if self.input_mode == "pqmf" else 1

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
        return math.prod(self.enc_ratios()) * (self.n_band if self.input_mode == "pqmf" else 1)

    def block_size(self) -> int:
        """Minimum streaming block in waveform samples: lcm of the encoder
        decimation, the decoder upsampling and the PQMF 2-frame parity."""
        band = self.n_band if self.output_mode == "pqmf" else 1
        b = math.lcm(self.decimation(), math.prod(self.dec_ratios()) * band)
        if self.input_mode == "pqmf" or self.output_mode == "pqmf":
            b = math.lcm(b, 2 * self.n_band)
        return b


PRESETS: Dict[str, Callable[[RaveConfig], None]] = {}


def preset(name: str):
    def deco(fn):
        PRESETS[name] = fn
        return fn

    return deco


@preset("v2")
def _v2(c: RaveConfig):
    """rave/configs/v2.gin (which includes v1.gin): what rave_tpu.config's
    `_v1` and `_v2` set of the fields the port has."""
    c.name = "v2"
    c.capacity = 96
    c.n_band = 16
    c.latent_size = 128
    c.ratios = (4, 4, 4, 2)
    c.kernel_size = 3
    c.dilations = ((1, 3, 9), (1, 3, 9), (1, 3, 9), (1, 3))
    c.encoder.kind = "v2"
    c.decoder.kind = "v2"
    c.latent.family = "variational"
    c.decoder.amplitude_modulation = True
    c.discriminator = DiscriminatorConfig(kind="combined", capacity=96)
    t = c.train
    t.phase_1_duration = 1_000_000
    t.update_discriminator_every = 4
    t.valid_signal_crop = True
    t.num_skipped_features = 1
    t.feature_matching_relative = True
    t.weights["feature_matching"] = 20.0
    t.beta_initial = 1e-6
    t.beta_target = 5e-2
    t.beta_warmup_len = 20000


@preset("causal")
def _causal(c: RaveConfig):
    """rave/configs/causal.gin: zero-lookahead convs everywhere."""
    c.mode = "causal"
    c.name = c.name + "_causal"


def compose(names: List[str], overrides: Optional[List[str]] = None) -> RaveConfig:
    """Stack presets in order, then apply dotted overrides."""
    cfg = RaveConfig()
    for n in names:
        if n not in PRESETS:
            raise KeyError(f"preset {n!r} is not ported (have {sorted(PRESETS)}; "
                           "ROADMAP A9-A11 list the other model families)")
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
