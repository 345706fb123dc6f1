"""The exported artifact (`.rtpu` directory) and `ExportedRAVE`, which serves it.

PyTorch port of rave_tpu/export/artifact.py. An artifact is a directory:

    manifest.json     the streaming metadata (per-method channels and
                      ratios, latency, block size, latent family and size,
                      attributes, the config), as the JAX package's, with
                      `format` "rtpu-torch-v1" so that neither package loads
                      the other's artifact
    weights.pt        the generator's `state_dict` (trained or EMA
                      weights, the analysis buffers), by `torch.save`
    *_step.pt2        the streaming step programs, by `torch.export.save`

Layout: the port's own, `[B, C, T]` waveforms and `[B, D, T_lat]` latents
(the JAX artifact is `[B, T, C]`).

The streaming state is explicit: `stream_slots(model)` names every stream
buffer of the model (conv caches and carries, delay lines, the PQMF
caches) and every AdaIN buffer, in module order, which is the union of
every method's state. A `StepProgram` runs one method as `(state, x, seed)
-> (y, state')`: it puts the state into the model's buffers, runs the
method with AdaIN learning (the JAX artifact's streaming calls make its
`adain` collection mutable), reads the buffers back and puts the originals
back, so it changes no module and the same code runs eagerly
(`ExportedRAVE`) and under `torch.export` (export.py). The offline calls
read the AdaIN state and never change it; `reset_stream` zeroes the stream
buffers and keeps it; the attribute setters (`set_learn_target`, ...)
write it, as the JAX artifact's do.
The sampling noise (the variational eps and padding, the discrete and
wasserstein augmentation channels) comes from the int64 `seed` (a uint32
value) through `normal_from_seed`, and the decoder's noise synth's
uniforms through `uniform_from_seed` (as the JAX artifact draws them from
its "noise" rng), so an exported program holds no draw as a constant and
draws what the eager artifact draws from the same seed. The encoder's
front-end (PQMF, mel or none) and the output transform (PQMF synthesis or
none) are the model's (`RAVE.transform_input` / `synthesize` and their
streaming steps). The
latent codecs of the four families are `post_process_latent` /
`pre_process_latent`; a discrete artifact's latents are its RVQ code
indices [B, Q, T] as floats, and its decode program holds the codebooks.

An artifact exported with a prior (`export --prior`) also holds
`prior.json` (the prior run's `prior_config.json`, also the manifest's
`prior`), `prior.pt` (the prior's `state_dict`) and `prior_step.pt2`. A
`PriorStep` is one autoregressive step `(state, x[B, D*R, 1], seed) ->
(next, state')`: the prior's logits for the frame after `x`, and the
stacked one-hot sampled from them with Gumbel noise drawn from `seed`
(`uniform_from_seed`, `prior_gumbel`). `ExportedRAVE.sample_prior` runs
the prior's `generate` from a zero frame and a zero state on the same
draws, one seed per step, so it samples what chained `PriorStep` calls
sample; then it decodes the quantized frames with a dither from the same
sampler, undoes the diagonal shift and pads the latent with normals up to
the artifact's latent size (rave_tpu/export/artifact.py:212-243).
"""
from __future__ import annotations

import contextlib
import json
from pathlib import Path
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rave_tpu_torch import config as config_lib
from rave_tpu_torch.config import RaveConfig
from rave_tpu_torch.factory import build_rave, resolve_device
from rave_tpu_torch.models.blocks import (
    AdaIN, angles_to_unit_norm_vector, unit_norm_vector_to_angles,
)
from rave_tpu_torch.models.rave import RAVE
from rave_tpu_torch.nn.conv import freeze_weights
from rave_tpu_torch.nn.graphs import StepGraphs
from rave_tpu_torch.nn.streaming import StreamingModule, static_size
from rave_tpu_torch.ops.resampler import Resampler
from rave_tpu_torch.prior.core import DiagonalShift, QuantizedNormal
from rave_tpu_torch.prior.model import Prior, gumbel_from_uniform, sample_prediction
from rave_tpu_torch.train.loop import fp32_exact
from rave_tpu_torch.utils.rng import MASK32, hash32, normal_from_seed, uniform_from_seed

FORMAT = "rtpu-torch-v1"
ENCODE_SALT, DECODE_SALT = 1, 2  # the latent noise of encode and of decode
SYNTH_SALT = 3  # the decoder's noise synth
PRIOR_SALT, PRIOR_DITHER_SALT, PRIOR_PAD_SALT = 4, 5, 6  # the prior's draws, its dither, padding
DECODE_SEED_OFFSET = 0x9E3779B9  # forward decodes with seed + this, mod 2^32 (as JAX)
STEP_METHODS = ("encode", "decode", "forward")


def post_process_latent(cfg: RaveConfig, model: nn.Module, latent_size: int, z: torch.Tensor,
                        eps: Optional[torch.Tensor] = None,
                        seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Raw encoder output [B, D, T] -> user-facing latents [B, latent_size, T],
    per family (reference scripts/export.py:351-408): variational, mean +
    std * eps, centred, rotated by the PCA and truncated (`model` holds the
    `latent_pca` and `latent_mean` buffers; `eps` [B, D, T] defaults to
    draws from `seed`); discrete, the code indices [B, Q, T] as floats;
    spherical, the angles; wasserstein, z itself."""
    fam = cfg.latent.family
    if fam == "discrete":
        return model.encoder.encode_indices(z).float()
    if fam == "spherical":
        return unit_norm_vector_to_angles(z)
    if fam == "wasserstein":
        return z
    mean, scale = z.chunk(2, dim=1)
    std = F.softplus(scale) + 1e-4
    if eps is None:
        eps = normal_from_seed(seed, mean.shape, ENCODE_SALT)
    zs = mean + std * eps.to(mean.dtype)
    zs = zs - model.latent_mean[:, None]
    zs = torch.einsum("ij,bjt->bit", model.latent_pca, zs)
    return zs[:, :latent_size]


def pre_process_latent(cfg: RaveConfig, model: nn.Module, full_latent_size: int, z: torch.Tensor,
                       noise: Optional[torch.Tensor] = None,
                       seed: Optional[torch.Tensor] = None) -> torch.Tensor:
    """User-facing latents [B, L, T] -> decoder input [B, full_latent_size, T],
    the inverse of `post_process_latent` up to the noise: variational,
    padded with noise, rotated back and un-centred; discrete, the indices
    clipped to the codebook, decoded (`model.rvq`) and given their
    augmentation noise; spherical, the unit vectors of the angles;
    wasserstein, the augmentation noise appended. `noise` [B, full - (the
    decoded width), T] defaults to draws from `seed`."""
    fam = cfg.latent.family
    if fam == "spherical":
        return angles_to_unit_norm_vector(z)
    if fam == "discrete":
        idx = z.clamp(0, cfg.latent.codebook_size - 1).to(torch.int64)
        z = model.rvq.decode(idx).transpose(1, 2)
    B, L, T = z.shape
    if static_size(z, 1) < full_latent_size:
        if noise is None:
            noise = normal_from_seed(seed, (B, full_latent_size - L, T), DECODE_SALT)
        z = torch.cat([z, noise.to(z.dtype)], dim=1)
    if fam != "variational":
        return z
    z = torch.einsum("ij,bit->bjt", model.latent_pca, z)
    return z + model.latent_mean[:, None]


def stream_slots(model: nn.Module) -> List[Tuple[str, nn.Module, str]]:
    """(name, module, attribute) of every stream buffer and AdaIN buffer under
    `model`, in module order: the artifact's state, the same for every method."""
    slots = []
    for name, m in model.named_modules():
        if isinstance(m, StreamingModule):
            attrs = list(m._stream_shapes)
        elif isinstance(m, AdaIN):
            attrs = AdaIN.STATE
        else:
            continue
        slots += [(f"{name}.{attr}" if name else attr, m, attr) for attr in attrs]
    return slots


def initial_state(model: nn.Module) -> List[torch.Tensor]:
    """The state a stream starts from: zero stream buffers, the AdaIN buffers
    as the model holds them."""
    return [getattr(m, attr).clone() if isinstance(m, AdaIN) else
            torch.zeros_like(getattr(m, attr)) for _, m, attr in stream_slots(model)]


@contextlib.contextmanager
def swapped(slots, values, learning: Optional[bool] = False):
    """The buffers of `slots` set to `values` (AdaIN learning if `learning`,
    not learning after; None leaves the flags as they are), and put back on
    exit."""
    saved = [getattr(m, attr) for _, m, attr in slots]
    adains = {m for _, m, _ in slots if isinstance(m, AdaIN)} if learning is not None else ()
    for (_, m, attr), v in zip(slots, values):
        setattr(m, attr, v)
    for m in adains:
        m.learning = learning
    try:
        yield
    finally:
        for (_, m, attr), v in zip(slots, saved):
            setattr(m, attr, v)
        for m in adains:
            m.learning = False


def graphed_stream(model: RAVE, latent_size: Optional[int] = None) -> StepGraphs:
    """The model's streaming pair as one served step, `(x, uniform=None) ->
    (z, y)`: `step_encode(x)`, then `step_decode` of its first `latent_size`
    channels (all when None), over the model's own stream and AdaIN buffers
    (`stream_slots`), read at each call and written in place. A CUDA graph
    per block shape on the card, eager on the CPU (`StepGraphs`); the
    model's mode and AdaIN's learning flags are part of the key.
    `init_stream_state` zeroes the buffers in place, so a reset replays the
    same graph."""
    slots = stream_slots(model)
    adains = [m for m in model.modules() if isinstance(m, AdaIN)]

    def pair(state, x, uniform=None):
        with swapped(slots, state, learning=None):
            z = model.step_encode(x)
            y = model.step_decode(z if latent_size is None else z[:, :latent_size], uniform)
            new = [getattr(m, attr) for _, m, attr in slots]
        return (z, y), new

    return StepGraphs(pair, lambda: [getattr(m, attr) for _, m, attr in slots],
                      key=lambda: (model.training, tuple(m.learning for m in adains)))


class _Side(nn.Module):
    """One half of the model and the latent codec beside it; its own
    module, so that a program that runs it holds only its weights."""

    def __init__(self, model: RAVE, cfg: RaveConfig, latent_size: int):
        super().__init__()
        self.cfg, self.latent_size = cfg, latent_size
        self.register_buffer("latent_pca", model.latent_pca, persistent=False)
        self.register_buffer("latent_mean", model.latent_mean, persistent=False)


class EncodeSide(_Side):
    def __init__(self, model: RAVE, cfg: RaveConfig, latent_size: int):
        super().__init__(model, cfg, latent_size)
        self.encoder, self.front = model.encoder, model.input_transform

    def forward(self, x, seed=None, eps=None, streaming: bool = False):
        """[B, C, T] -> [B, latent_size, T / decimation] (discrete: indices)."""
        if self.front is not None:
            x = self.front.step(x) if streaming else self.front(x)
        z = self.encoder.step(x) if streaming else self.encoder(x)
        return post_process_latent(self.cfg, self, self.latent_size, z, eps, seed)


class DecodeSide(_Side):
    def __init__(self, model: RAVE, cfg: RaveConfig, latent_size: int):
        super().__init__(model, cfg, latent_size)
        self.decoder, self.synthesis = model.decoder, model.output_transform
        self.n_channels = model.n_channels
        if cfg.latent.family == "discrete":  # the codebooks decode the indices
            self.rvq = model.encoder.rvq

    def forward(self, z, seed=None, noise=None, streaming: bool = False, uniform=None):
        """[B, latent_size, T_lat] -> [B, C, T_lat * decimation]. `uniform`
        (the noise synth's draws) defaults to draws from `seed`."""
        zp = pre_process_latent(self.cfg, self, self.cfg.augmented_latent_size(), z, noise, seed)
        shape = self.cfg.noise_shape(self.n_channels, z.shape[0], z.shape[-1])
        if shape is not None and uniform is None:
            uniform = uniform_from_seed(seed, shape, SYNTH_SALT)
        y = self.decoder.step(zp, uniform) if streaming else self.decoder(zp, uniform)
        if self.synthesis is None:
            return y
        return self.synthesis.step(y) if streaming else self.synthesis(y)


class StepProgram(nn.Module):
    """One streaming method as `(state, x, seed) -> (y, state')` (the JAX
    artifact's `encode_step` / `decode_step` / `forward_step`): `state` the
    list of `stream_slots(model)`, `seed` an int64 scalar holding a uint32.
    `forward` decodes with `seed + 0x9E3779B9 mod 2^32`. `eps` / `noise`
    / `uniform` replace the seed's draws (tests inject another package's draws)."""

    def __init__(self, method: str, model: RAVE, encode: EncodeSide, decode: DecodeSide):
        super().__init__()
        self.method = method
        if method != "decode":
            self.encode = encode
        if method != "encode":
            self.decode = decode
        self.slots = stream_slots(model)  # a plain list: registers no module twice

    def forward(self, state: List[torch.Tensor], x: torch.Tensor, seed: torch.Tensor,
                eps: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                uniform: Optional[torch.Tensor] = None):
        if len(state) != len(self.slots):
            raise ValueError(f"{len(state)} state tensors for {len(self.slots)} stream buffers")
        with swapped(self.slots, state, learning=True):
            if self.method == "encode":
                y = self.encode(x, seed, eps, streaming=True)
            elif self.method == "decode":
                y = self.decode(x, seed, noise, streaming=True, uniform=uniform)
            else:
                z = self.encode(x, seed, eps, streaming=True)
                y = self.decode(z, (seed + DECODE_SEED_OFFSET) & MASK32, noise, streaming=True,
                                uniform=uniform)
            new = [getattr(m, attr) for _, m, attr in self.slots]
        return y, new


class PriorStep(nn.Module):
    """One step of the bundled prior as `(state, x, seed) -> (next, state')`:
    `state` the list of `stream_slots(prior)`, `x` [B, D*R, 1] the last
    frame, `next` the stacked one-hot sampled from the prior's logits with
    Gumbel noise from `seed` (an int64 scalar holding a uint32), or their
    argmax with `argmax`."""

    def __init__(self, prior: Prior):
        super().__init__()
        self.prior = prior
        self.slots = stream_slots(prior)

    def forward(self, state: List[torch.Tensor], x: torch.Tensor, seed: torch.Tensor,
                argmax: bool = False):
        if len(state) != len(self.slots):
            raise ValueError(f"{len(state)} state tensors for {len(self.slots)} stream buffers")
        D, R = self.prior.latent_size, self.prior.resolution
        with swapped(self.slots, state):
            logits = self.prior.step(x)
            new = [getattr(m, attr) for _, m, attr in self.slots]
        gumbel = None if argmax else prior_gumbel(seed, x.shape[0], D, R)
        return sample_prediction(logits, D, R, gumbel, argmax), new


def prior_gumbel(seed: torch.Tensor, batch: int, latent_size: int,
                 resolution: int) -> torch.Tensor:
    """The Gumbel noise [B, D, R, 1] of one prior step, drawn from `seed`."""
    return gumbel_from_uniform(uniform_from_seed(seed, (batch, latent_size, resolution, 1),
                                                 PRIOR_SALT))


def prior_step_seed(seed: int, i: int) -> int:
    """The seed of step `i` of a prior sample drawn from `seed`."""
    return hash32((seed & MASK32) ^ hash32(i + 1))


class ExportedRAVE:
    """An artifact loaded on `device` (the card unless the caller passes
    `device="cpu"`): `encode`, `decode` and `forward`, offline or streaming
    in whole blocks, at the artifact's `target_sampling_rate`. The model is
    in eval mode with its kernels fixed (`freeze_weights`).

    Every call without an explicit `seed` takes the next seed of a chain
    started from `seed` (the JAX artifact's `_rng` / `_next_rng`). The
    streaming state (`state`, and the resampler's own) persists between
    calls until `reset_stream`, which keeps the AdaIN part of `state`.

    The streaming calls and the prior's steps are served by `StepGraphs`
    (`graphs`: "encode", "decode", "forward" and "prior"): on the card each
    replays a CUDA graph of the whole call (the resampler's step in, the
    step program, the resampler's step out), the JAX artifact's jitted
    step. Their state tensors (`stream_state`: `state`, then the
    resampler's) keep their addresses: `reset_stream`, the attribute
    setters and an assignment to `state` write them in place. Calling a
    `steps` program directly is the eager path."""

    def __init__(self, path: str, device: str | torch.device = "cuda", seed: int = 0):
        self.path = Path(path)
        self.device = resolve_device(device)
        self.manifest = json.loads((self.path / "manifest.json").read_text())
        if self.manifest.get("format") != FORMAT:
            raise ValueError(f"{self.path} is a {self.manifest.get('format')!r} artifact; the "
                             f"port reads {FORMAT!r} (export it with rave_tpu_torch.cli export)")
        self.cfg = config_lib.from_dict(self.manifest["config"])
        self.n_channels = self.manifest["n_channels"]
        self.stream_batch = self.manifest["stream_batch"]
        self.latent_size = self.manifest["latent_size"]
        self.full_latent_size = self.manifest["full_latent_size"]
        self.model = build_rave(self.cfg, n_channels=self.n_channels,
                                stream_batch=self.stream_batch, device=self.device)
        weights = torch.load(self.path / "weights.pt", map_location="cpu", weights_only=True)
        self.model.load_state_dict(weights)
        self.model.eval().requires_grad_(False)
        freeze_weights(self.model)
        self.encode_side = EncodeSide(self.model, self.cfg, self.latent_size)
        self.decode_side = DecodeSide(self.model, self.cfg, self.latent_size)
        self.steps = {m: StepProgram(m, self.model, self.encode_side, self.decode_side)
                      for m in STEP_METHODS}
        self.slots = stream_slots(self.model)
        # the AdaIN buffers' places in `state` (the attributes' setters write them)
        self.adain_indices = [i for i, (_, m, _) in enumerate(self.slots)
                              if isinstance(m, AdaIN)]
        self._seed, self._calls = int(seed) & MASK32, 0
        self.resampler = None
        tsr = self.manifest.get("target_sampling_rate", self.manifest["sampling_rate"])
        if tsr != self.manifest["sampling_rate"]:
            self.resampler = Resampler(tsr, self.manifest["sampling_rate"], self.stream_batch,
                                       self.n_channels).to(self.device)
        self._resampler_slots = stream_slots(self.resampler) if self.resampler else []
        with torch.inference_mode(False):  # written in place by every later call
            self._stream = initial_state(self.model) + [
                torch.zeros_like(getattr(m, attr)) for _, m, attr in self._resampler_slots]
        adain = set(self.adain_indices)
        self._stream_indices = [i for i in range(len(self._stream)) if i not in adain]
        self.graph_pool = torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None
        self.stream_steps = {m: self._stream_step(m) for m in STEP_METHODS}
        self.graphs = {m: StepGraphs(self.stream_steps[m], self._stream, self.graph_pool)
                       for m in STEP_METHODS}
        self.prior_step = None
        pc = self.manifest.get("prior")
        if pc and (self.path / "prior.pt").exists():
            prior = Prior(pc["latent_size"], pc["resolution"], pc["res_size"], pc["skp_size"],
                          pc["kernel_size"], pc["cycle_size"], pc["n_layers"])
            prior.load_state_dict(torch.load(self.path / "prior.pt", map_location="cpu",
                                             weights_only=True))
            self.prior_step = PriorStep(prior.to(self.device).eval().requires_grad_(False))
            with torch.inference_mode(False):
                self._prior_stream = self.prior_state()
            self.graphs["prior"] = StepGraphs(self.prior_step, self._prior_stream,
                                              self.graph_pool)

    # ---- the stream state ------------------------------------------------
    @property
    def state(self) -> Tuple[torch.Tensor, ...]:
        """The model's stream and AdaIN tensors (`stream_slots(self.model)`),
        as the step programs take them: a tuple, so an item assignment
        raises. Assigning a list to `state` copies it into them in place,
        or, where the dtypes differ (a float64 copy), puts the new tensors in
        their places (the graphs key them apart)."""
        return tuple(self._stream[:len(self.slots)])

    @state.setter
    def state(self, values: List[torch.Tensor]) -> None:
        n = len(self.slots)
        if len(values) != n:
            raise ValueError(f"{len(values)} state tensors for {n} stream buffers")
        if all(v.shape == s.shape and v.dtype == s.dtype for v, s in zip(values, self._stream)):
            with torch.no_grad():
                for s, v in zip(self._stream, values):
                    s.copy_(v)
        else:
            self._stream[:n] = [v.to(self.device) for v in values]

    @property
    def stream_state(self) -> List[torch.Tensor]:
        """Every state tensor of the streaming calls: `state`, then the
        resampler's (what `stream_steps` take and `graphs` write)."""
        return self._stream

    def _stream_step(self, method: str):
        """`method`'s streaming call as a step over `stream_state`, `(state,
        x, seed, eps, noise, uniform) -> (y, state')`: the resampler's step
        in (encode, forward), the step program, the resampler's step out
        (decode, forward). What a graph of `graphs` captures."""
        step, n, rs = self.steps[method], len(self.slots), self.resampler

        def run(state, x, seed, eps=None, noise=None, uniform=None):
            with swapped(self._resampler_slots, state[n:]):
                if rs is not None and method != "decode":
                    x = rs.step_to_model(x)
                y, new = step(state[:n], x, seed, eps=eps, noise=noise, uniform=uniform)
                if rs is not None and method != "encode":
                    y = rs.step_from_model(y)
                new = new + [getattr(m, attr) for _, m, attr in self._resampler_slots]
            return y, new

        return run

    # ---- seeds -----------------------------------------------------------
    def next_seed(self) -> int:
        """The next uint32 of the seed chain."""
        self._calls += 1
        return hash32(self._seed ^ hash32(self._calls))

    def _seed_value(self, seed: Optional[int]) -> int:
        return self.next_seed() if seed is None else int(seed) & MASK32

    def _seed_tensor(self, seed: Optional[int]) -> torch.Tensor:
        """An int64 scalar on the device, filled by a kernel (no host copy)."""
        return torch.full((), self._seed_value(seed), dtype=torch.int64, device=self.device)

    # ---- the step programs -----------------------------------------------
    def load_program(self, method: str):
        """The exported `<method>_step.pt2` as a callable module; it must
        have been exported on this artifact's kind of device."""
        entry = self.manifest.get("aot", {}).get(f"{method}_step")
        if entry is None:
            raise FileNotFoundError(f"{self.path} has no {method}_step program")
        if torch.device(entry["device"]).type != self.device.type:
            raise ValueError(
                f"{self.path / entry['file']} was exported on {entry['device']} and holds its "
                f"weights there; it does not run on {self.device}. Load the artifact with "
                f"device={torch.device(entry['device']).type!r}, or export it again with "
                f"--device {self.device.type}")
        return torch.export.load(str(self.path / entry["file"])).module()

    # ---- public surface --------------------------------------------------
    def _check_block(self, n: int, unit: int, what: str) -> None:
        if n % unit:
            raise ValueError(f"streaming {what} must be a multiple of {unit} (got {n})")

    def _resample(self, x: torch.Tensor, direction: str) -> torch.Tensor:
        """The offline resampling; a streaming call's is in its step (`stream_steps`)."""
        if self.resampler is None:
            return x
        if direction == "in":
            return self.resampler.to_model_sampling_rate(x)
        return self.resampler.from_model_sampling_rate(x)

    @fp32_exact()
    @torch.no_grad()
    def encode(self, x: torch.Tensor, streaming: bool = False, seed: Optional[int] = None,
               eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, C, T] waveform at target_sr -> [B, latent_size, T_lat]."""
        if streaming:
            self._check_block(x.shape[-1], self.block_size, "chunks (samples)")
            return self.graphs["encode"](x, self._seed_value(seed), eps)
        x = self._resample(x.to(self.device), "in")
        with self._adain_state():
            return self.encode_side(x, self._seed_tensor(seed), eps)

    @fp32_exact()
    @torch.no_grad()
    def decode(self, z: torch.Tensor, streaming: bool = False, seed: Optional[int] = None,
               noise: Optional[torch.Tensor] = None,
               uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
        """[B, latent_size, T_lat] -> [B, C, T] waveform at target_sr."""
        if streaming:
            self._check_block(z.shape[-1], self.manifest["block_size"] // self.cfg.decimation(),
                              "latent chunks (frames)")
            return self.graphs["decode"](z, self._seed_value(seed), None, noise, uniform)
        with self._adain_state():
            y = self.decode_side(z.to(self.device), self._seed_tensor(seed), noise,
                                 uniform=uniform)
        return self._resample(y, "out")

    @fp32_exact()
    @torch.no_grad()
    def forward(self, x: torch.Tensor, streaming: bool = False, seed: Optional[int] = None,
                eps: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None,
                uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
        """decode(encode(x)): encode with one seed of the chain (or `seed`),
        decode with it + 0x9E3779B9, as the `forward_step` program."""
        if streaming:
            self._check_block(x.shape[-1], self.block_size, "chunks (samples)")
            return self.graphs["forward"](x, self._seed_value(seed), eps, noise, uniform)
        x = self._resample(x.to(self.device), "in")
        s = self._seed_tensor(seed)
        with self._adain_state():
            z = self.encode_side(x, s, eps)
            y = self.decode_side(z, (s + DECODE_SEED_OFFSET) & MASK32, noise, uniform=uniform)
        return self._resample(y, "out")

    @property
    def block_size(self) -> int:
        """The streaming block in target-rate samples."""
        b = self.manifest["block_size"]
        return b * self.resampler.ratio if self.resampler else b

    def reset_stream(self) -> None:
        """Zero the stream buffers (the resampler's too) in place; the AdaIN
        state stays as it is."""
        with torch.no_grad():
            for i in self._stream_indices:
                self._stream[i].zero_()

    # ---- AdaIN attributes and the prior ----------------------------------
    def _adain_state(self):
        """The model's AdaIN buffers set to the artifact's AdaIN state (offline calls)."""
        idx = self.adain_indices
        return swapped([self.slots[i] for i in idx], [self.state[i] for i in idx])

    def _set_adain(self, leaf: str, value: float) -> None:
        """Fill every AdaIN buffer named `leaf` (rave_tpu/export/artifact.py:398-408);
        nothing without AdaIN, as the JAX artifact without an `adain` collection."""
        with torch.no_grad():
            for i in self.adain_indices:
                if self.slots[i][2] == leaf:
                    self._stream[i].fill_(value)

    def set_learn_target(self, on: bool) -> None:
        self._set_adain("learn_y", 1.0 if on else 0.0)

    def set_learn_source(self, on: bool) -> None:
        self._set_adain("learn_x", 1.0 if on else 0.0)

    def reset_target(self) -> None:
        for leaf, value in (("mean_y", 0.0), ("std_y", 1.0), ("num_update_y", 0.0)):
            self._set_adain(leaf, value)

    def reset_source(self) -> None:
        for leaf, value in (("mean_x", 0.0), ("std_x", 1.0), ("num_update_x", 0.0)):
            self._set_adain(leaf, value)

    @property
    def has_prior(self) -> bool:
        return self.prior_step is not None

    def prior_state(self) -> List[torch.Tensor]:
        """The zero stream state a prior sample starts from."""
        return initial_state(self.prior_step.prior)

    @fp32_exact()
    @torch.no_grad()
    def sample_prior(self, n_frames: int, seed: Optional[int] = None,
                     argmax: bool = False) -> torch.Tensor:
        """`n_frames` latent frames [1, latent_size, n_frames] from the bundled
        prior, ready for `decode`: n_frames + D - 1 steps of the prior from a
        zero frame (step i draws what `prior_step` draws from
        `prior_step_seed(seed, i)`), decoded
        with a dither drawn from the seed, the diagonal shift undone, and
        normals from the seed for the latent dimensions the prior does not
        model (rave_tpu/export/artifact.py:212-243)."""
        if self.prior_step is None:
            raise RuntimeError(f"{self.path} was exported without a prior")
        s = self._seed_value(seed)
        prior = self.prior_step.prior
        D, R = prior.latent_size, prior.resolution
        n = n_frames + D - 1
        # the prior's `generate` from a zero frame and a zero state, one
        # served step at a time
        for t in self._prior_stream:
            t.zero_()
        x, ys, step = torch.zeros(1, D * R, 1, device=self.device), [], self.graphs["prior"]
        for i in range(n):
            x = step(x, prior_step_seed(s, i), argmax=argmax)
            ys.append(x)
        ys = torch.cat(ys, dim=-1)
        seed_t = torch.full((), s, dtype=torch.int64, device=self.device)
        dither = uniform_from_seed(seed_t, (1, D, n), PRIOR_DITHER_SALT)
        z = DiagonalShift().inverse(QuantizedNormal(R).decode(ys, dither))
        if D < self.latent_size:
            pad = normal_from_seed(seed_t, (1, self.latent_size - D, n_frames), PRIOR_PAD_SALT)
            z = torch.cat([z, pad], dim=1)
        return z[:, : self.latent_size]
