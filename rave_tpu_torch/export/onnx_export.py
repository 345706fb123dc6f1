"""ONNX emission of the RAVE forward pass from the port's own modules.

The port's counterpart of rave_tpu/export/onnx_export.py:262-366 (reference
scripts/export_onnx.py:76-91): a port model becomes opset-12 `.onnx` bytes
with a dynamic audio length, the weights baked in as initializers, input
"audio_in" [1, 1, audio_length] and output "audio_out". The graph is the
offline forward: PQMF analysis -> encoder -> variational reparametrization
(RandomNormalLike, or the posterior mean with `deterministic`) -> decoder
-> PQMF synthesis. It reads the port's modules: each conv's effective
kernel (weight norm materialized) turned into the JAX package's [K, I, O]
layout that export/onnx_graph.py takes, and BatchNorm's running statistics
as a `BatchNormalization` node. Its node list is the JAX exporter's, node
for node, on the same weights (tests/test_torch_onnx.py).

Scope, as the JAX exporter's and the reference's `onnx.gin`: the v1 and
v2 families without the FFT noise synth (it has no opset-12 lowering),
variational, mono, PQMF input and output, no GRU, no AdaIN, v1 with one
conv per stride and a loudness stride of 1; `unsupported` refuses the rest
with the same tests. The StableHLO half of the JAX command is not ported:
only the `.onnx` is written.
"""
from __future__ import annotations

import numpy as np
import torch

from rave_tpu_torch.config import RaveConfig
from rave_tpu_torch.export import onnx_proto as P
from rave_tpu_torch.export.onnx_graph import Builder
from rave_tpu_torch.models.blocks import normalize_dilations
from rave_tpu_torch.nn.conv import ConvTranspose1d, get_padding


def _kernel(conv) -> np.ndarray:
    """A conv's effective kernel (weight norm applied) as [K, I/groups, O]."""
    w = conv.weight().detach().float().cpu()
    order = (2, 0, 1) if isinstance(conv, ConvTranspose1d) else (2, 1, 0)
    return np.ascontiguousarray(w.permute(*order).numpy())


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _reverse_half(b: Builder, z: str, n_band: int) -> str:
    """Dynamic-length reverse_half: odd bands flip sign at even frames,
    mask[k, n] = 1 + band_odd[k] * ((2*(n%2)-1) - 1)."""
    shape = b.op("Shape", [z])
    f = b.op("Gather", [shape, b.const("idx", np.asarray(2, np.int64))], axis=0)
    rng = b.op("Range", [b.const("start", np.asarray(0, np.int64)), f,
                         b.const("delta", np.asarray(1, np.int64))])
    parity = b.op("Mod", [rng, b.const("two", np.asarray(2, np.int64))])
    parity_f = b.op("Cast", [parity], to=1)  # float32
    # e[n] = 2*(n%2) - 2  (== -2 at even frames, 0 at odd)
    e = b.add_const(b.mul_const(parity_f, np.asarray(2.0, np.float32)),
                    np.asarray(-2.0, np.float32))
    e = b.op("Unsqueeze", [e], axes=[0, 1])  # [1, 1, F]
    band_odd = (np.arange(n_band) % 2).astype(np.float32).reshape(1, n_band, 1)
    mask = b.add_const(b.mul(e, b.const("band_odd", band_odd)), np.asarray(1.0, np.float32))
    return b.mul(z, mask)


def _encoder_v1(b: Builder, x: str, cfg: RaveConfig, layers) -> str:
    """EncoderV1's offline forward (models/blocks.py::EncoderV1): conv 7,
    per ratio (BatchNorm, act, strided conv), act, the grouped conv 5."""

    def conv(x, idx, k, stride=1, groups=1):
        return b.conv1d(x, _kernel(layers[idx]), None, stride=stride,
                        pads=get_padding(k, stride, 1, cfg.mode), groups=groups, hint=f"enc{idx}")

    x = conv(x, 0, 7)
    i = 1
    for r in cfg.ratios:
        bn = layers[i].bn
        x = b.batch_norm(x, _np(bn.scale), _np(bn.bias), _np(bn.mean), _np(bn.var))
        x = b.leaky_relu(x)
        x = conv(x, i + 2, 2 * r + 1, stride=r)
        i += 3
    x = b.leaky_relu(x)
    return conv(x, i + 1, 5, groups=2)


def _residual_stack(b: Builder, x: str, stack, cfg: RaveConfig) -> str:
    """ResidualStack with one kernel size: its (single) aligned branch, summed
    into the input layer by layer."""
    branch = stack.aligned.branches[0]
    k = cfg.decoder.res_kernel_sizes[0]
    for j, dils in enumerate(cfg.decoder.res_dilations):
        inner = branch.layers[j].net.inner.layers
        h = x
        for slot, dil in zip((1, 3), dils):
            h = b.leaky_relu(h)
            h = b.conv1d(h, _kernel(inner[slot]), None, dilation=dil,
                         pads=get_padding(k, 1, dil, cfg.mode), hint=f"res{j}_{slot}")
        x = b.add(x, h)
    return x


def _activation(b: Builder, x: str, cfg: RaveConfig, module) -> str:
    """leaky_relu or Snake (x + sin^2(alpha x) / (alpha + 1e-9))."""
    if cfg.activation == "snake":
        alpha = _np(module.alpha).reshape(1, -1, 1)
        s = b.op("Sin", [b.mul(x, b.const("alpha", alpha))])
        return b.add(x, b.op("Div", [b.mul(s, s), b.const("alpha_eps", alpha + 1e-9)]))
    return b.leaky_relu(x)


def _residual_unit_v2(b: Builder, x: str, cfg: RaveConfig, unit, K: int, dil: int) -> str:
    """Residual(DilatedUnit): x + conv1x1(act(conv_dil(act(x))))."""
    net = unit.inner.net.layers
    h = _activation(b, x, cfg, net[0])
    h = b.conv1d(h, _kernel(net[1]), None, dilation=dil, pads=get_padding(K, 1, dil, cfg.mode),
                 hint="dconv")
    h = _activation(b, h, cfg, net[2])
    h = b.conv1d(h, _kernel(net[3]), None, pads=(0, 0), hint="pconv")
    return b.add(x, h)


def _encoder_v2(b: Builder, x: str, cfg: RaveConfig, layers) -> str:
    """EncoderV2's offline forward; layer indices as models/blocks.py builds them."""
    K = cfg.encoder.kernel_size or cfg.kernel_size
    eratios = tuple(cfg.encoder.ratios or cfg.ratios)
    dl = normalize_dilations(tuple(cfg.encoder.dilations or cfg.dilations), eratios)
    x = b.conv1d(x, _kernel(layers[0]), None, pads=get_padding(2 * K + 1, 1, 1, cfg.mode),
                 hint="enc0")
    i = 1
    for r, dils in zip(eratios, dl):
        for d in dils:
            x = _residual_unit_v2(b, x, cfg, layers[i], K, d)
            i += 1
        x = _activation(b, x, cfg, layers[i])
        x = b.conv1d(x, _kernel(layers[i + 1]), None, stride=r,
                     pads=get_padding(2 * r, r, 1, cfg.mode), hint=f"down{i}")
        i += 2
    x = _activation(b, x, cfg, layers[i])
    return b.conv1d(x, _kernel(layers[i + 1]), None, pads=get_padding(K, 1, 1, cfg.mode),
                    hint="enc_final")


def _generator_v2(b: Builder, z: str, cfg: RaveConfig, decoder) -> str:
    """GeneratorV2's offline forward without the noise branch: mirrored
    upsampling and residual units, optional amplitude modulation, tanh."""
    layers = decoder.net.layers
    K = cfg.kernel_size
    dl = normalize_dilations(tuple(cfg.dilations), cfg.ratios)[::-1]
    x = b.conv1d(z, _kernel(layers[0]), None, pads=get_padding(K, 1, 1, cfg.mode), hint="dec0")
    i = 1
    for r, dils in zip(tuple(cfg.ratios)[::-1], dl):
        x = _activation(b, x, cfg, layers[i])
        x = b.conv_transpose1d(x, _kernel(layers[i + 1]), None, ratio=r,
                               crop=r // 2 if cfg.mode == "centered" else 0, hint=f"up{i}")
        i += 2
        for d in dils:
            x = _residual_unit_v2(b, x, cfg, layers[i], K, d)
            i += 1
    x = _activation(b, x, cfg, layers[i])
    wave = b.conv1d(x, _kernel(decoder.waveform), None,
                    pads=get_padding(2 * K + 1, 1, 1, cfg.mode), hint="wave")
    ds = cfg.n_band  # out_data_size, mono
    if cfg.decoder.amplitude_modulation:
        w = b.slice_channels(wave, 0, ds)
        amp = b.slice_channels(wave, ds, 2 * ds)
        wave = b.mul(w, b.op("Sigmoid", [amp]))
    return b.op("Tanh", [wave])


def _generator_v1(b: Builder, z: str, cfg: RaveConfig, decoder) -> str:
    """GeneratorV1's offline forward without the noise branch:
    tanh(wave) * mod_sigmoid(loud), the loudness broadcast over the bands."""
    layers = decoder.net.layers
    x = b.conv1d(z, _kernel(layers[0]), None, pads=get_padding(7, 1, 1, cfg.mode), hint="dec0")
    idx = 1
    for r in cfg.ratios:
        up = layers[idx].net.layers[1]
        x = b.leaky_relu(x)
        if r > 1:
            x = b.conv_transpose1d(x, _kernel(up), None, ratio=r,
                                   crop=r // 2 if cfg.mode == "centered" else 0, hint=f"up{idx}")
        else:
            x = b.conv1d(x, _kernel(up), None, pads=get_padding(3, 1, 1, cfg.mode),
                         hint=f"up{idx}")
        x = _residual_stack(b, x, layers[idx + 1], cfg)
        idx += 2
    wave = b.conv1d(x, _kernel(decoder.synth.branches[0]), None,
                    pads=get_padding(7, 1, 1, cfg.mode), hint="wave")
    loud = b.conv1d(x, _kernel(decoder.synth.branches[1]), None,
                    pads=get_padding(3, 1, 1, cfg.mode), hint="loud")
    # mod_sigmoid(x) = 2 sigmoid(x)^2.3 + 1e-7 (ops/dsp.py)
    amp = b.op("Pow", [b.op("Sigmoid", [loud]), b.const("p", np.asarray(2.3, np.float32))])
    amp = b.add_const(b.mul_const(amp, np.asarray(2.0, np.float32)),
                      np.asarray(1e-7, np.float32))
    return b.mul(b.op("Tanh", [wave]), amp)


def unsupported(why: str):
    raise NotImplementedError(
        f"ONNX export covers the v1 and v2 families without the noise synth (the "
        f"reference's onnx.gin scope): {why}. Use `export` (the .rtpu artifact) for this "
        f"configuration.")


def check_scope(cfg: RaveConfig) -> None:
    """Raise NotImplementedError for what has no opset-12 graph here, by the
    tests of rave_tpu/export/onnx_export.py:282-312."""
    kind = (cfg.encoder.kind, cfg.decoder.kind)
    if kind not in (("v1", "v1"), ("v2", "v2")):
        unsupported(f"got encoder/decoder kind {kind}")
    v2 = kind == ("v2", "v2")
    if cfg.latent.family != "variational" or cfg.latent.noise_augmentation:
        unsupported(f"got latent family {cfg.latent.family}+aug{cfg.latent.noise_augmentation}")
    if cfg.decoder.use_noise if v2 else cfg.decoder.use_noise_v1:
        unsupported("the FFT noise branch has no opset-12 lowering; train with "
                    "use_noise=false (the reference's onnx.gin does the same)")
    if cfg.input_mode != "pqmf" or cfg.output_mode != "pqmf":
        unsupported(f"got input/output mode {cfg.input_mode}/{cfg.output_mode}")
    if not v2 and cfg.decoder.loud_stride != 1:
        unsupported(f"got loud_stride {cfg.decoder.loud_stride}")
    if cfg.encoder.repeat_layers != 1 or cfg.encoder.recurrent_layers:
        unsupported("repeat/recurrent encoder layers")
    if cfg.decoder.recurrent_layers:
        unsupported("recurrent decoder layers")
    if cfg.encoder.use_adain or cfg.decoder.use_adain:
        unsupported("AdaIN layers (stateful attribute surface)")
    if cfg.activation not in ("leaky_relu", "snake"):
        unsupported(f"activation {cfg.activation}")


def export_onnx_model(cfg: RaveConfig, model, *, deterministic: bool = False,
                      doc: str = "") -> bytes:
    """The forward pass of the port model `model` (built from `cfg`) as ONNX
    ModelProto bytes. Raises NotImplementedError outside the scope above."""
    check_scope(cfg)
    v2 = cfg.encoder.kind == "v2"
    bank = model.pqmf
    M, Q = bank.n_band, bank.taps

    b = Builder(cfg.name)
    x = b.add_input("audio_in", (1, 1, "audio_length"))
    if M > 1:  # PQMF analysis
        x = b.reshape(x, (1, -1, M))       # [1, T/M, M]: (n, m) = x[n*M+m]
        x = b.transpose(x, (0, 2, 1))      # NCW [1, M, T/M]
        x = b.conv1d(x, bank.analysis_kernel, None, pads=(Q // 2, (Q - 1) - Q // 2),
                     hint="pqmf_a")
        x = _reverse_half(b, x, M)

    layers = model.encoder.encoder.net.layers
    z2 = _encoder_v2(b, x, cfg, layers) if v2 else _encoder_v1(b, x, cfg, layers)
    D = cfg.latent_size
    mean = b.slice_channels(z2, 0, D)
    if deterministic:
        z = mean
    else:
        scale = b.slice_channels(z2, D, 2 * D)
        std = b.add_const(b.op("Softplus", [scale]), np.asarray(1e-4, np.float32))
        z = b.add(mean, b.mul(std, b.op("RandomNormalLike", [mean])))

    y = (_generator_v2 if v2 else _generator_v1)(b, z, cfg, model.decoder)
    if M > 1:  # PQMF synthesis
        y = _reverse_half(b, y, M)
        y = b.conv1d(y, bank.synthesis_kernel, None, pads=((Q - 1) - Q // 2, Q // 2),
                     hint="pqmf_s")
        y = b.transpose(y, (0, 2, 1))
        y = b.reshape(y, (1, 1, -1))
    b.nodes.append(P.node("Identity", [y], ["audio_out"]))  # outputs match by name
    b.add_output("audio_out", (1, 1, "audio_length"))
    return b.build(doc=doc or f"rave_tpu_torch {cfg.name} forward (opset 12)")
