"""Reference `.gin` ingestion: parse the reference's config grammar into the
port's RaveConfig.

The port's copy of rave_tpu/config_gin.py, which reads
`rave_tpu_torch.config` in place of `rave_tpu.config`; the code is the
same, so that both packages make the same config of the same file
(tests/test_torch_config_gin.py holds them equal on a corpus of gin texts).

The reference configures itself through gin files stacked on the CLI and
re-instantiates exported runs from the run dir's `config.gin`
(reference scripts/train.py:153-156, scripts/export.py:497-500). This module
gives reference users a direct on-ramp: `--config path/to/file.gin` on
every command that takes `--config` parses the stock gin grammar (includes,
macros, single-line and block bindings, `%MACRO` refs, `@target` refs) and
translates the bindings onto the dataclass config.

Two ingestion paths:
  * stock includes (`include "configs/v2.gin"`) are recognized by name and
    applied as the equivalent preset (`_STOCK_MACROS` holds the macros each
    stock file defines, for the including file's `%MACRO` references);
  * everything else (the including file's own macros + bindings, custom
    user gins, operative config dumps) is translated binding-by-binding
    through the table below.

`augmentations_from_gin` reads an augmentation file
(configs/augmentations/*.gin) into the JSON specs of
data/transforms.get_augmentations; `prior_kwargs_from_gin` a prior file
(configs/prior/prior_v1.gin) into `train_prior`'s keyword arguments.
"""
from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from rave_tpu_torch.config import PRESETS, RaveConfig

__all__ = [
    "apply_gin_file",
    "config_from_gin",
    "augmentations_from_gin",
    "prior_kwargs_from_gin",
    "GinParseError",
]


class GinParseError(ValueError):
    pass


@dataclass(frozen=True)
class GinRef:
    """A `@scope/module.Class` (optionally called: `@...()`) reference."""

    name: str  # full dotted path, scope preserved, e.g. "variational/blocks.EncoderV2"
    called: bool = False

    @property
    def cls(self) -> str:
        return self.name.split("/")[-1].split(".")[-1]


class _Undefined:
    """Placeholder for a `%MACRO` with no definition in scope (tolerated
    unless the value is actually consumed by a translation rule)."""

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return f"%{self.name}"


# ---------------------------------------------------------------------------
# lexing / statement splitting
# ---------------------------------------------------------------------------


def _strip_comment(line: str) -> str:
    """Remove a '#'-comment, respecting single/double-quoted strings."""
    out = []
    quote = None
    for ch in line:
        if quote:
            out.append(ch)
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            out.append(ch)
        elif ch == "#":
            break
        else:
            out.append(ch)
    return "".join(out)


def _bracket_depth(s: str) -> int:
    depth = 0
    quote = None
    for ch in s:
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
    return depth


@dataclass
class _Stmt:
    kind: str  # include | macro | binding
    key: str = ""  # macro name or "target.param" (scope preserved)
    value: str = ""  # raw rhs text (or include path)


def _split_statements(text: str) -> List[_Stmt]:
    """Gin file -> ordered include/macro/binding statements. Handles block
    bindings (header `target:` + indented params) and bracket-continued
    values; drops import/from lines and comments."""
    lines = [_strip_comment(l.rstrip()) for l in text.splitlines()]
    stmts: List[_Stmt] = []
    target: Optional[str] = None  # current block-binding header
    i = 0
    while i < len(lines):
        line = lines[i]
        i += 1
        if not line.strip():
            continue
        stripped = line.strip()
        indented = line[0] in " \t"
        if not indented:
            target = None
        if stripped.startswith(("import ", "from ")):
            continue
        m = re.match(r'include\s+["\'](.+?)["\']\s*$', stripped)
        if m:
            stmts.append(_Stmt("include", value=m.group(1)))
            continue
        # block header: `scope/mod.Cls:` with no '=' at depth 0
        if stripped.endswith(":") and "=" not in stripped.split(":")[0]:
            target = stripped[:-1].strip()
            continue
        if "=" not in stripped:
            raise GinParseError(f"cannot parse gin line: {line!r}")
        lhs, rhs = stripped.split("=", 1)
        lhs, rhs = lhs.strip(), rhs.strip()
        # continuation: accumulate until brackets balance
        while _bracket_depth(rhs) > 0 and i < len(lines):
            rhs += " " + lines[i].strip()
            i += 1
        if indented and target:
            stmts.append(_Stmt("binding", key=f"{target}.{lhs}", value=rhs))
        elif re.fullmatch(r"[A-Z][A-Z0-9_]*", lhs):
            stmts.append(_Stmt("macro", key=lhs, value=rhs))
        else:
            stmts.append(_Stmt("binding", key=lhs, value=rhs))
    return stmts


# ---------------------------------------------------------------------------
# value expressions
# ---------------------------------------------------------------------------

_TOKEN = re.compile(
    r"""\s*(?:
        (?P<ref>@[\w./]+(?:\(\))?)
      | (?P<macro>%[\w.]+)
      | (?P<str>'[^']*'|"[^"]*")
      | (?P<num>[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?|[-+]?\d+)
      | (?P<word>True|False|None)
      | (?P<punct>[\[\](){},:])
    )""",
    re.VERBOSE,
)


def _tokenize(s: str) -> List[str]:
    toks, pos = [], 0
    while pos < len(s):
        m = _TOKEN.match(s, pos)
        if not m:
            if s[pos:].strip() == "":
                break
            raise GinParseError(f"cannot tokenize value at: {s[pos:]!r}")
        toks.append(m.group().strip())
        pos = m.end()
    return toks


def _parse_value(raw: str, env: Dict[str, Any]) -> Any:
    toks = _tokenize(raw)
    pos = 0

    def peek():
        return toks[pos] if pos < len(toks) else None

    def next_tok():
        nonlocal pos
        t = toks[pos]
        pos += 1
        return t

    def expr():
        t = next_tok()
        if t == "[" or t == "(":
            close = "]" if t == "[" else ")"
            items = []
            while peek() != close:
                items.append(expr())
                if peek() == ",":
                    next_tok()
            next_tok()
            return items if t == "[" else tuple(items)
        if t == "{":
            d = {}
            while peek() != "}":
                k = expr()
                if next_tok() != ":":
                    raise GinParseError(f"bad dict in: {raw!r}")
                d[k] = expr()
                if peek() == ",":
                    next_tok()
            next_tok()
            return d
        if t.startswith("@"):
            called = t.endswith("()")
            return GinRef(t[1:-2] if called else t[1:], called)
        if t.startswith("%"):
            name = t[1:]
            return env.get(name, _Undefined(name))
        if t[0] in "'\"":
            return t[1:-1]
        if t in ("True", "False"):
            return t == "True"
        if t == "None":
            return None
        try:
            return int(t)
        except ValueError:
            return float(t)

    val = expr()
    if pos != len(toks):
        raise GinParseError(f"trailing tokens in value: {raw!r}")
    return val


def _tup(v: Any) -> Any:
    """Recursively convert lists to tuples (config field convention)."""
    if isinstance(v, (list, tuple)):
        return tuple(_tup(x) for x in v)
    return v


# ---------------------------------------------------------------------------
# macro links: stock macro name -> config field effect
# ---------------------------------------------------------------------------


def _set_capacity(c: RaveConfig, v):
    c.capacity = v
    c.discriminator.capacity = v  # v1.gin binds ConvNet.capacity = %CAPACITY


_ACTIVATIONS = {"Snake": "snake", "SnakeBeta": "snake"}

_MACRO_LINKS: Dict[str, Callable[[RaveConfig, Any], None]] = {
    "SAMPLING_RATE": lambda c, v: setattr(c, "sampling_rate", v),
    "CAPACITY": _set_capacity,
    "N_BAND": lambda c, v: setattr(c, "n_band", v),
    "LATENT_SIZE": lambda c, v: setattr(c, "latent_size", v),
    "RATIOS": lambda c, v: setattr(c, "ratios", _tup(v)),
    "KERNEL_SIZE": lambda c, v: setattr(c, "kernel_size", v),
    "DILATIONS": lambda c, v: setattr(c, "dilations", _tup(v)),
    "PHASE_1_DURATION": lambda c, v: setattr(c.train, "phase_1_duration", v),
    "NOISE_AUGMENTATION": lambda c, v: setattr(c.latent, "noise_augmentation", v),
    "NUM_QUANTIZERS": lambda c, v: setattr(c.latent, "num_quantizers", v),
    "CODEBOOK_SIZE": lambda c, v: setattr(c.latent, "codebook_size", v),
    "N_FFT": lambda c, v: setattr(c, "mel_n_fft", v),
    "N_MELS": lambda c, v: setattr(c, "n_mels", v),
    "HOP_LENGTH": lambda c, v: setattr(c, "mel_hop", v),
    "ACTIVATION": lambda c, v: setattr(
        c, "activation", _ACTIVATIONS.get(v.cls, "leaky_relu")
    )
    if isinstance(v, GinRef)
    else None,
}

# macro defaults each stock gin (incl. its includes) establishes — needed so
# files including e.g. v1.gin can resolve %N_BAND without re-parsing it
_V1_MACROS = {
    "SAMPLING_RATE": 44100, "CAPACITY": 64, "N_BAND": 16,
    "LATENT_SIZE": 128, "RATIOS": [4, 4, 4, 2], "PHASE_1_DURATION": 1000000,
}
_V2_MACROS = {
    **_V1_MACROS, "KERNEL_SIZE": 3, "CAPACITY": 96, "NOISE_AUGMENTATION": 0,
    "DILATIONS": [[1, 3, 9], [1, 3, 9], [1, 3, 9], [1, 3]],
}
_STOCK_MACROS: Dict[str, Dict[str, Any]] = {
    "v1": _V1_MACROS,
    "v2": _V2_MACROS,
    "v2_small": {**_V2_MACROS, "RATIOS": [4, 2, 2, 2], "CAPACITY": 48},
    "v2_nopqmf": {**_V2_MACROS, "CAPACITY": 64},
    "v2_nopqmf_small": {**_V2_MACROS, "CAPACITY": 64},
    "v2_with_augs": {
        **_V2_MACROS, "ENCODER_RATIOS": [2, 2, 2], "N_FFT": 2048,
        "N_MELS": 128, "HOP_LENGTH": 256, "NUM_GRU_LAYERS": 2,
    },
    "v3": _V2_MACROS,
    "discrete": {
        **_V2_MACROS, "NUM_QUANTIZERS": 16, "RATIOS": [4, 4, 2, 2],
        "LATENT_SIZE": 128, "CODEBOOK_SIZE": 1024, "DYNAMIC_MASKING": False,
        "NOISE_AUGMENTATION": 128, "PHASE_1_DURATION": 200000,
    },
    "onnx": {**_V1_MACROS, "CAPACITY": 32},
    "hybrid": {
        **_V2_MACROS, "N_FFT": 2048, "N_MELS": 128, "HOP_LENGTH": 256,
        "ENCODER_RATIOS": [2, 2, 2], "NUM_GRU_LAYERS": 2,
    },
    "wasserstein": {
        "LATENT_SIZE": 16, "NOISE_AUGMENTATION": 128,
        "PHASE_1_DURATION": 200000,
    },
    "spherical": {"LATENT_SIZE": 16},
    "snake": {},
    "adain": {},
    "noise": {},
    "causal": {},
    "descript_discriminator": {},
    "spectral_discriminator": {},
    "normalize_ambient": {},
    "raspberry": {**_V1_MACROS, "CAPACITY": 16},
    "discrete_v3": {},
}
_STOCK_MACROS["discrete_v3"] = _STOCK_MACROS["discrete"]
_STOCK_MACROS["v2_small"] = {**_V2_MACROS, "RATIOS": [4, 2, 2, 2], "CAPACITY": 48}


# ---------------------------------------------------------------------------
# binding translation table
# ---------------------------------------------------------------------------


def _is_macro(raw: str, name: str) -> bool:
    return raw.strip() == f"%{name}"


def _unless_macro(field_setter, macro_name: str):
    """Set the leaf only when the binding is NOT the global-macro reference
    (the presets leave those leaves None so they track the global)."""

    def rule(ctx, val, raw):
        if not _is_macro(raw, macro_name):
            field_setter(ctx.cfg, val)

    return rule


def _set(path: str, conv=lambda v: v):
    """Set a dotted config field from the resolved value."""

    def rule(ctx, val, raw):
        obj = ctx.cfg
        parts = path.split(".")
        for p in parts[:-1]:
            obj = getattr(obj, p)
        setattr(obj, parts[-1], conv(val))

    return rule


def _ignore(ctx, val, raw):
    pass


_ENCODER_FAMILIES = {
    "VariationalEncoder": "variational",
    "DiscreteEncoder": "discrete",
    "WasserteinEncoder": "wasserstein",
    "SphericalEncoder": "spherical",
}
_ENCODER_KINDS = {"Encoder": "v1", "EncoderV2": "v2"}
_GAN_LOSSES = {
    "hinge_gan": "hinge",
    "ls_gan": "ls",
    "nonsaturating_gan": "nonsaturating",
}


def _rule_rave_encoder(ctx, val, raw):
    if isinstance(val, GinRef) and val.cls in _ENCODER_FAMILIES:
        ctx.cfg.latent.family = _ENCODER_FAMILIES[val.cls]
    elif isinstance(val, GinRef) and val.cls in _ENCODER_KINDS:
        ctx.cfg.encoder.kind = _ENCODER_KINDS[val.cls]


def _rule_rave_decoder(ctx, val, raw):
    if isinstance(val, GinRef):
        ctx.cfg.decoder.kind = {"Generator": "v1", "GeneratorV2": "v2"}.get(
            val.cls, ctx.cfg.decoder.kind
        )


def _rule_rave_discriminator(ctx, val, raw):
    if not isinstance(val, GinRef):
        return
    kinds = {
        "MultiScaleDiscriminator": "multiscale",
        "CombineDiscriminators": ctx.combine_kind or "combined",
        "DescriptDiscriminator": "descript",
    }
    if val.cls in kinds:
        ctx.cfg.discriminator.kind = kinds[val.cls]


def _rule_combine_list(ctx, val, raw):
    names = {v.cls for v in val if isinstance(v, GinRef)}
    if "MultiPeriodDiscriminator" in names:
        kind = "combined"
    elif {"MultiScaleSpectralDiscriminator",
          "MultiScaleSpectralDiscriminator1d"} & names:
        kind = "spectral"
    else:
        kind = "multiscale"
    ctx.combine_kind = kind
    # retro-apply when rave.RAVE.discriminator = @CombineDiscriminators was
    # (or will be) bound — the preset semantics key off the combined list
    if ctx.cfg.discriminator.kind in ("combined", "spectral", "multiscale"):
        ctx.cfg.discriminator.kind = kind


def _rule_weights(ctx, val, raw):
    if isinstance(val, dict):
        up = {}
        for k, v in val.items():
            if k == "reg":
                # the reference's static-regularization weight maps onto a
                # constant beta schedule (v2_nopqmf_small.gin:100)
                ctx.cfg.train.beta_initial = float(v)
                ctx.cfg.train.beta_target = float(v)
                ctx.cfg.train.beta_warmup_len = 1
            else:
                up[k] = float(v)
        ctx.cfg.train.weights.update(up)


def _rule_gan_loss(ctx, val, raw):
    if isinstance(val, GinRef) and val.cls in _GAN_LOSSES:
        ctx.cfg.train.gan_loss = _GAN_LOSSES[val.cls]


def _rule_causal(ctx, val, raw):
    if val == "causal" and ctx.cfg.mode != "causal":
        ctx.cfg.mode = "causal"
        ctx.cfg.name = ctx.cfg.name + "_causal"


def _rule_activation(ctx, val, raw):
    if isinstance(val, GinRef):
        ctx.cfg.activation = _ACTIVATIONS.get(val.cls, ctx.cfg.activation)


def _rule_augmentations(ctx, val, raw):
    ctx.pending_augs = [v for v in val if isinstance(v, GinRef)]


def _rule_noise_module(ctx, val, raw):
    ctx.cfg.decoder.use_noise = isinstance(val, GinRef)


def _rule_add_augmentation(ctx, val, raw):
    """`add_augmentation: aug = @augmentations/transforms.X()` — the
    grammar of the reference's configs/augmentations/*.gin files
    (scripts/train.py:127-132 parses one file per --augment flag and calls
    add_augmentation() once, consuming the file's last `aug` binding)."""
    if isinstance(val, GinRef):
        ctx.added_augs.append(val)


_RULES: Dict[str, Callable] = {
    # ---- augmentation files (configs/augmentations/*.gin) ------------------
    "add_augmentation.aug": _rule_add_augmentation,
    # ---- core / distances -------------------------------------------------
    "AudioDistanceV1.log_epsilon": _set("distance.log_epsilon", float),
    "AudioDistanceV1.multiscale_stft": _ignore,
    "MultiScaleSTFT.scales": _set("distance.scales", _tup),
    "MultiScaleSTFT.sample_rate": _ignore,
    "MultiScaleSTFT.magnitude": _ignore,
    "MultiScaleSTFT.num_mels": _set("distance.num_mels"),
    "split_dataset.max_residual": _ignore,
    "n_fft_to_num_bands.n_fft": _ignore,
    "get_augmented_latent_size.latent_size": _ignore,
    "get_augmented_latent_size.noise_augmentation": _ignore,
    # ---- convolution / pqmf -----------------------------------------------
    "Conv1d.bias": _ignore,
    "ConvTranspose1d.bias": _ignore,
    "get_padding.mode": _rule_causal,
    "CachedPQMF.attenuation": _set("pqmf_attenuation"),
    "CachedPQMF.n_band": _ignore,  # tracks %N_BAND
    "normalization.mode": lambda ctx, v, raw: setattr(
        ctx.cfg, "weight_norm", v == "weight_norm"
    ),
    # ---- encoders ----------------------------------------------------------
    "Encoder.data_size": _ignore,
    "Encoder.capacity": _unless_macro(
        lambda c, v: setattr(c.encoder, "capacity", v), "CAPACITY"
    ),
    "Encoder.latent_size": _ignore,
    "Encoder.ratios": _unless_macro(
        lambda c, v: setattr(c.encoder, "ratios", _tup(v)), "RATIOS"
    ),
    "Encoder.sample_norm": _set("encoder.sample_norm"),
    "Encoder.repeat_layers": _set("encoder.repeat_layers"),
    "Encoder.n_out": _ignore,
    "EncoderV2.data_size": _ignore,
    "EncoderV2.capacity": _unless_macro(
        lambda c, v: setattr(c.encoder, "capacity", v), "CAPACITY"
    ),
    "EncoderV2.ratios": _unless_macro(
        lambda c, v: setattr(c.encoder, "ratios", _tup(v)), "RATIOS"
    ),
    "EncoderV2.latent_size": _ignore,
    "EncoderV2.n_out": _ignore,
    "EncoderV2.kernel_size": _unless_macro(
        lambda c, v: setattr(c.encoder, "kernel_size", v), "KERNEL_SIZE"
    ),
    "EncoderV2.dilations": _unless_macro(
        lambda c, v: setattr(c.encoder, "dilations", _tup(v)), "DILATIONS"
    ),
    "EncoderV2.activation": _rule_activation,
    "EncoderV2.adain": lambda ctx, v, raw: setattr(
        ctx.cfg.encoder, "use_adain", isinstance(v, GinRef)
    ),
    "EncoderV2.keep_dim": _set("encoder.keep_dim"),
    "EncoderV2.recurrent_layer": _ignore,
    "VariationalEncoder.encoder": lambda ctx, v, raw: (
        setattr(ctx.cfg.encoder, "kind", _ENCODER_KINDS.get(v.cls, "v2"))
        if isinstance(v, GinRef)
        else None
    ),
    "DiscreteEncoder.encoder_cls": lambda ctx, v, raw: (
        setattr(ctx.cfg.encoder, "kind", _ENCODER_KINDS.get(v.cls, "v2"))
        if isinstance(v, GinRef)
        else None
    ),
    "DiscreteEncoder.vq_cls": _ignore,
    "DiscreteEncoder.num_quantizers": _set("latent.num_quantizers"),
    "DiscreteEncoder.noise_augmentation": _set("latent.noise_augmentation"),
    "WasserteinEncoder.encoder_cls": lambda ctx, v, raw: (
        setattr(ctx.cfg.encoder, "kind", _ENCODER_KINDS.get(v.cls, "v2"))
        if isinstance(v, GinRef)
        else None
    ),
    "WasserteinEncoder.noise_augmentation": _set("latent.noise_augmentation"),
    "SphericalEncoder.encoder_cls": lambda ctx, v, raw: (
        setattr(ctx.cfg.encoder, "kind", _ENCODER_KINDS.get(v.cls, "v2"))
        if isinstance(v, GinRef)
        else None
    ),
    "ResidualVectorQuantization.num_quantizers": _set("latent.num_quantizers"),
    "ResidualVectorQuantization.dim": _ignore,  # tracks %LATENT_SIZE
    "ResidualVectorQuantization.codebook_size": _set("latent.codebook_size"),
    # ---- decoders ----------------------------------------------------------
    "Generator.latent_size": _ignore,
    "Generator.capacity": _unless_macro(
        lambda c, v: setattr(c.decoder, "capacity", v), "CAPACITY"
    ),
    "Generator.data_size": _ignore,
    "Generator.ratios": _unless_macro(
        lambda c, v: setattr(c.decoder, "ratios", _tup(v)), "RATIOS"
    ),
    "Generator.loud_stride": _set("decoder.loud_stride"),
    "Generator.use_noise": _set("decoder.use_noise_v1"),
    "GeneratorV2.data_size": _ignore,
    "GeneratorV2.capacity": _unless_macro(
        lambda c, v: setattr(c.decoder, "capacity", v), "CAPACITY"
    ),
    "GeneratorV2.ratios": _unless_macro(
        lambda c, v: setattr(c.decoder, "ratios", _tup(v)), "RATIOS"
    ),
    "GeneratorV2.latent_size": _ignore,
    "GeneratorV2.kernel_size": _ignore,  # tracks %KERNEL_SIZE
    "GeneratorV2.dilations": _ignore,  # tracks %DILATIONS
    "GeneratorV2.amplitude_modulation": _set("decoder.amplitude_modulation"),
    "GeneratorV2.noise_module": _rule_noise_module,
    "GeneratorV2.recurrent_layer": _ignore,  # GRU.num_layers carries the info
    "GeneratorV2.activation": _rule_activation,
    "GeneratorV2.adain": lambda ctx, v, raw: setattr(
        ctx.cfg.decoder, "use_adain", isinstance(v, GinRef)
    ),
    "GeneratorV2.keep_dim": _set("decoder.keep_dim"),
    "ResidualStack.kernel_sizes": _set("decoder.res_kernel_sizes", _tup),
    "ResidualStack.dilations_list": _set("decoder.res_dilations", _tup),
    "NoiseGenerator.ratios": _set("decoder.v1_noise_ratios", _tup),
    "NoiseGenerator.noise_bands": _set("decoder.v1_noise_bands"),
    "NoiseGeneratorV2.hidden_size": _set("decoder.noise_hidden"),
    "NoiseGeneratorV2.data_size": _ignore,
    "NoiseGeneratorV2.ratios": _set("decoder.noise_ratios", _tup),
    "NoiseGeneratorV2.noise_bands": _set("decoder.noise_bands"),
    "NoiseGeneratorV2.activation": _rule_activation,
    "GRU.num_layers": _set("decoder.recurrent_layers"),
    "GRU.latent_size": _ignore,
    "ResidualLayer.activation": _rule_activation,
    "DilatedUnit.activation": _rule_activation,
    "UpsampleLayer.activation": _rule_activation,
    "Snake.": _ignore,
    # ---- discriminators ----------------------------------------------------
    "ConvNet.in_size": _ignore,
    "ConvNet.out_size": _ignore,
    "ConvNet.capacity": _set("discriminator.capacity"),
    "ConvNet.n_layers": _set("discriminator.n_layers"),
    "ConvNet.stride": _set("discriminator.stride"),
    "ConvNet.conv": _ignore,
    "scales/ConvNet.kernel_size": _set("discriminator.kernel_size"),
    "scales/ConvNet.conv": _ignore,
    "periods/ConvNet.kernel_size": _set("discriminator.period_kernel", _tup),
    "periods/ConvNet.conv": _ignore,
    "spectral/ConvNet.kernel_size": _ignore,
    "spectral/ConvNet.stride": _ignore,
    "spectral/ConvNet.conv": _ignore,
    "MultiScaleDiscriminator.n_discriminators": _set("discriminator.n_scales"),
    "MultiScaleDiscriminator.convnet": _ignore,
    "MultiPeriodDiscriminator.periods": _set("discriminator.periods", _tup),
    "MultiPeriodDiscriminator.convnet": _ignore,
    "MultiScaleSpectralDiscriminator1d.scales": _set(
        "discriminator.spectral_scales", _tup
    ),
    "MultiScaleSpectralDiscriminator1d.convnet": _ignore,
    "MultiScaleSpectralDiscriminator.scales": _set(
        "discriminator.spectral_scales", _tup
    ),
    "MultiScaleSpectralDiscriminator.convnet": _ignore,
    "EncodecConvNet.capacity": _set("discriminator.encodec_capacity"),
    "CombineDiscriminators.discriminators": _rule_combine_list,
    "mean_difference.norm": _ignore,
    "mean_difference.relative": _set("train.feature_matching_relative"),
    # ---- model assembly (rave.RAVE) ----------------------------------------
    "RAVE.latent_size": _unless_macro(
        lambda c, v: setattr(c, "latent_size", v), "LATENT_SIZE"
    ),
    "RAVE.pqmf": _ignore,
    "RAVE.sampling_rate": _unless_macro(
        lambda c, v: setattr(c, "sampling_rate", v), "SAMPLING_RATE"
    ),
    "RAVE.encoder": _rule_rave_encoder,
    "RAVE.decoder": _rule_rave_decoder,
    "RAVE.discriminator": _rule_rave_discriminator,
    "RAVE.phase_1_duration": _unless_macro(
        lambda c, v: setattr(c.train, "phase_1_duration", v), "PHASE_1_DURATION"
    ),
    "RAVE.gan_loss": _rule_gan_loss,
    "RAVE.valid_signal_crop": _set("train.valid_signal_crop"),
    "RAVE.feature_matching_fun": _ignore,
    "RAVE.num_skipped_features": _set("train.num_skipped_features"),
    "RAVE.audio_distance": _ignore,
    "RAVE.multiband_audio_distance": _ignore,
    "RAVE.weights": _rule_weights,
    "RAVE.loss_weights": _rule_weights,
    "RAVE.warmup_quantize": _set("train.warmup_quantize"),
    "RAVE.update_discriminator_every": _set("train.update_discriminator_every"),
    "RAVE.input_mode": _set("input_mode"),
    "RAVE.output_mode": _set("output_mode"),
    "RAVE.enable_pqmf_encode": lambda ctx, v, raw: setattr(
        ctx.cfg, "input_mode", "pqmf" if v else "raw"
    ),
    "RAVE.enable_pqmf_decode": lambda ctx, v, raw: setattr(
        ctx.cfg, "output_mode", "pqmf" if v else "raw"
    ),
    "RAVE.n_bands": _ignore,  # tracks %N_BAND
    "RAVE.n_channels": _set("data.n_channels"),
    "RAVE.audio_monitor_epochs": _ignore,
    "RAVE.spectrogram": lambda ctx, v, raw: (
        setattr(ctx.cfg, "input_mode", "mel") if isinstance(v, GinRef) else None
    ),
    "RAVE.is_mel_input": lambda ctx, v, raw: setattr(
        ctx.cfg, "input_mode", "mel" if v else ctx.cfg.input_mode
    ),
    # ---- beta warmup --------------------------------------------------------
    "BetaWarmupCallback.initial_value": _set("train.beta_initial", float),
    "BetaWarmupCallback.target_value": _set("train.beta_target", float),
    "BetaWarmupCallback.warmup_len": _set("train.beta_warmup_len"),
    # ---- mel front-end -------------------------------------------------------
    "MelSpectrogram.sample_rate": _ignore,
    "MelSpectrogram.n_fft": _unless_macro(
        lambda c, v: setattr(c, "mel_n_fft", v), "N_FFT"
    ),
    "MelSpectrogram.win_length": _ignore,
    "MelSpectrogram.hop_length": _unless_macro(
        lambda c, v: setattr(c, "mel_hop", v), "HOP_LENGTH"
    ),
    "MelSpectrogram.normalized": _ignore,
    "MelSpectrogram.n_mels": _unless_macro(
        lambda c, v: setattr(c, "n_mels", v), "N_MELS"
    ),
    # ---- dataset / augmentations ---------------------------------------------
    "get_dataset.augmentations": _rule_augmentations,
}

# bindings on these classes are collected as augmentation parameters instead
# of config fields (they parameterize @refs in get_dataset.augmentations)
_AUG_CLASSES = {
    "RandomCompress", "Compress", "RandomGain", "FrequencyMasking",
    "RandomMute", "RandomApply", "Dequantize",
}

# canonical JSON key order per augmentation type (matches the preset strings)
_AUG_KEY_ORDER = {
    "RandomCompress": ["threshold", "amp_range", "prob"],
    "Compress": ["time", "lookup"],
}


class _Ctx:
    def __init__(self, cfg: RaveConfig):
        self.cfg = cfg
        self.env: Dict[str, Any] = {}
        self.aug_params: Dict[str, Dict[str, Any]] = {}
        self.pending_augs: Optional[List[GinRef]] = None
        # `add_augmentation: aug = @...` bindings, in file order (the
        # reference's configs/augmentations/*.gin grammar)
        self.added_augs: List[GinRef] = []
        self.combine_kind: Optional[str] = None
        self.unknown: List[str] = []


def _rule_key(target: str, param: str) -> Tuple[str, str]:
    """binding target -> (scoped key, unscoped key) for table lookup."""
    scope = target.split("/")[0] + "/" if "/" in target else ""
    cls = target.split("/")[-1].split(".")[-1]
    return f"{scope}{cls}.{param}", f"{cls}.{param}"


def _emit_aug_spec(ref: GinRef, params: Dict[str, Any]) -> str:
    """Aug reference + collected gin params -> inline JSON spec string (the
    form data/transforms.get_augmentations consumes)."""
    cls = ref.cls
    kw = {k: v for k, v in params.items() if k != "sr"}
    # the reference's v2_nopqmf_small.gin binds RandomCompress's parameters
    # under the (mistyped) static Compress scope; the operative intent is
    # RandomCompress (see config.py preset note)
    if cls == "Compress" and {"threshold", "amp_range", "prob"} & set(kw):
        cls = "RandomCompress"
    order = _AUG_KEY_ORDER.get(cls, sorted(kw))
    body: Dict[str, Any] = {"type": cls}
    for k in order:
        if k in kw:
            body[k] = kw[k]
    for k in kw:  # params outside the canonical order, in gin order
        if k not in body:
            body[k] = kw[k]
    return json.dumps(body, separators=(",", ":"))


def _apply_binding(ctx: _Ctx, key: str, raw: str) -> None:
    target, _, param = key.rpartition(".")
    if not target:
        ctx.unknown.append(key)
        return
    cls = target.split("/")[-1].split(".")[-1]
    val = _parse_value(raw, ctx.env)
    if cls in _AUG_CLASSES:
        name = target.split("/")[-1]
        ctx.aug_params.setdefault(name, {})[param] = val
        return
    k_scoped, k_plain = _rule_key(target, param)
    rule = _RULES.get(k_scoped) or _RULES.get(k_plain)
    if rule is None:
        ctx.unknown.append(key)
        return
    if isinstance(val, _Undefined) and rule is not _ignore:
        # overlay gins legitimately reference macros their base defines
        # (noise.gin uses %N_BAND) — only consumed values must resolve
        raise GinParseError(
            f"binding {key} references undefined macro %{val.name}"
        )
    rule(ctx, val, raw)


def _resolve_include(
    inc: str, base_dirs: Sequence[Path]
) -> Tuple[Optional[str], Optional[Path]]:
    """-> (stock preset name, None) or (None, resolved path)."""
    stem = Path(inc).stem
    if stem in PRESETS and stem in _STOCK_MACROS:
        return stem, None
    for d in base_dirs:
        cand = (d / inc).resolve()
        if cand.is_file():
            return None, cand
        cand = (d / Path(inc).name).resolve()
        if cand.is_file():
            return None, cand
    raise GinParseError(
        f"cannot resolve include {inc!r}: not a stock config and not found "
        f"under {[str(d) for d in base_dirs]}"
    )


def _apply_text(
    ctx: _Ctx, text: str, base_dirs: Sequence[Path]
) -> None:
    for stmt in _split_statements(text):
        if stmt.kind == "include":
            stock, path = _resolve_include(stmt.value, base_dirs)
            if stock is not None:
                PRESETS[stock](ctx.cfg)
                for k, v in _STOCK_MACROS[stock].items():
                    ctx.env.setdefault(k, v)
            else:
                _apply_text(
                    ctx, path.read_text(), [path.parent, *base_dirs]
                )
        elif stmt.kind == "macro":
            val = _parse_value(stmt.value, ctx.env)
            ctx.env[stmt.key] = val
            link = _MACRO_LINKS.get(stmt.key)
            if link is not None and not isinstance(val, _Undefined):
                link(ctx.cfg, val)
        else:
            _apply_binding(ctx, stmt.key, stmt.value)


def _is_model_root(text: str) -> bool:
    """A gin file 'names' the model when it includes another config or binds
    the model's encoder/decoder — overlays (snake, causal, ...) don't."""
    if re.search(r"^\s*include\s", text, re.M):
        return True
    return bool(
        re.search(r"RAVE\s*:|RAVE\.(encoder|decoder)\s*=", text)
        and re.search(r"\b(encoder|decoder)\s*=\s*@", text)
    )


def apply_gin_file(
    cfg: RaveConfig, path: str, strict: bool = False
) -> RaveConfig:
    """Apply a reference-format .gin file on top of `cfg` (stacking
    semantics, like the reference's multi --config CLI). Mutates and
    returns cfg. `strict=True` raises on untranslatable bindings instead
    of skipping them (operative config dumps contain framework-internal
    bindings that are safely ignorable)."""
    p = Path(path)
    text = p.read_text()
    ctx = _Ctx(cfg)
    _apply_text(ctx, text, [p.parent, p.parent.parent, Path.cwd()])
    if ctx.pending_augs is not None:
        cfg.data.augmentations = tuple(
            _emit_aug_spec(r, ctx.aug_params.get(r.name.split("/")[-1], {}))
            for r in ctx.pending_augs
        )
    if ctx.added_augs:
        # an augmentation gin stacked as --config behaves like --augment
        cfg.data.augmentations = tuple(cfg.data.augmentations) + tuple(
            _emit_aug_spec(r, ctx.aug_params.get(r.name.split("/")[-1], {}))
            for r in ctx.added_augs
        )
    if _is_model_root(text):
        cfg.name = p.stem
    if strict and ctx.unknown:
        raise GinParseError(
            f"untranslated gin bindings: {sorted(set(ctx.unknown))}"
        )
    return cfg


def config_from_gin(path: str, strict: bool = False) -> RaveConfig:
    """Parse a reference .gin file into a fresh RaveConfig."""
    return apply_gin_file(RaveConfig(), path, strict=strict)


def augmentations_from_gin(path: str) -> List[str]:
    """Parse a reference augmentation gin file
    (rave/configs/augmentations/{mute,compress,gain}.gin and user files of
    the same grammar) into inline JSON spec strings consumable by
    data/transforms.get_augmentations.

    The reference resolves each `--augment <name>` flag to `<name>.gin`,
    parses it, and calls add_augmentation() once per file
    (scripts/train.py:127-132) — so the file's last `aug` binding is the
    effective one; class-parameter bindings (`RandomGain.gain_range = ...`)
    in the same file are applied onto the emitted spec."""
    p = Path(path)
    ctx = _Ctx(RaveConfig())
    _apply_text(ctx, p.read_text(), [p.parent, p.parent.parent, Path.cwd()])
    refs = ctx.added_augs[-1:] if ctx.added_augs else []
    if not refs:
        raise GinParseError(
            f"{path}: no `add_augmentation: aug = @...` binding found"
        )
    return [
        _emit_aug_spec(r, ctx.aug_params.get(r.name.split("/")[-1], {}))
        for r in refs
    ]


# VariationalPrior gin params (rave/configs/prior/prior_v1.gin:1-8) ->
# train_prior keyword names (prior/train.py). `sr` is bound
# to @get_model_sr() in the stock file — derived from the run dir here, so
# it is ignored.
_PRIOR_PARAMS = {
    "resolution": int,
    "res_size": int,
    "skp_size": int,
    "kernel_size": int,
    "cycle_size": int,
    "n_layers": int,
}


def prior_kwargs_from_gin(path: str) -> Dict[str, Any]:
    """Parse a reference prior gin file (configs/prior/prior_v1.gin) into
    train_prior(...) keyword arguments."""
    p = Path(path)
    out: Dict[str, Any] = {}
    unknown: List[str] = []
    for stmt in _split_statements(p.read_text()):
        if stmt.kind != "binding":
            continue
        target, _, param = stmt.key.rpartition(".")
        cls = target.split("/")[-1].split(".")[-1]
        if cls not in ("VariationalPrior", "Prior", "Model"):
            unknown.append(stmt.key)
            continue
        if param == "sr":
            continue  # derived from the RAVE run dir
        if param not in _PRIOR_PARAMS:
            unknown.append(stmt.key)
            continue
        val = _parse_value(stmt.value, {})
        out[param] = _PRIOR_PARAMS[param](val)
    if not out:
        raise GinParseError(
            f"{path}: no VariationalPrior bindings found "
            f"(untranslated: {unknown})"
        )
    return out
