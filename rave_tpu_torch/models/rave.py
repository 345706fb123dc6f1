"""The RAVE autoencoder: input transform -> encoder -> decoder -> output
transform, with the analysis buffers that export reads.

PyTorch port of rave_tpu/models/rave.py. The input transform is PQMF
analysis (`input_mode` 'pqmf'), the log-mel front-end `MelAnalysis`
('mel') or none ('raw'); the output transform PQMF synthesis
(`output_mode` 'pqmf') or none ('raw': the decoder writes the waveform).
The multiband loss's target is PQMF analysis whatever the input mode.
Layout: waveforms [B, n_channels, T], latents [B, D, T_lat], as in the
reference RAVE.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rave_tpu_torch.models.blocks import GeneratorV1, LatentDraws
from rave_tpu_torch.models.pqmf_module import PQMFAnalysis, PQMFSynthesis
from rave_tpu_torch.nn.streaming import StreamingModule, as_dtype, static_size
from rave_tpu_torch.ops.pqmf import PQMFBank
from rave_tpu_torch.ops.stft import frame_signal, hann_window, mel_filterbank


class MelAnalysis(StreamingModule):
    """Log-mel front-end of mel input (rave_tpu/models/rave.py:25-95):
    [B, C, T] -> [B, C*n_mels, frames], channel c*n_mels + m.

    Offline, torchaudio's MelSpectrogram(center=True) with the reference's
    last-frame crop (rave/model.py:238-242): reflect padding of n_fft/2 on
    both sides, frames every `hop`, the last dropped, a periodic Hann,
    |rfft|, the Slaney mel filterbank, log1p. Streaming keeps the last
    n_fft - hop samples (`cache` [B, C, n_fft - hop]) and frames causally:
    the stream lags the centred offline frames by (n_fft/2 - hop)/hop
    frames (`delay`)."""

    def __init__(self, sampling_rate: int, n_fft: int = 2048, hop: int = 256,
                 n_mels: int = 128, n_channels: int = 1, stream_batch: int = 1):
        super().__init__()
        if (n_fft // 2) % hop:
            raise ValueError(f"streaming mel needs hop | n_fft/2 (hop {hop}, n_fft {n_fft})")
        self.n_fft, self.hop, self.n_mels = n_fft, hop, n_mels
        self.register_buffer("window", torch.from_numpy(hann_window(n_fft)), persistent=False)
        self.register_buffer("filterbank", torch.from_numpy(
            mel_filterbank(sampling_rate, n_fft, n_mels)), persistent=False)
        self.add_stream_state("cache", n_channels, n_fft - hop, stream_batch)

    @property
    def delay(self) -> int:
        return (self.n_fft // 2 - self.hop) // self.hop

    def _project(self, frames: torch.Tensor) -> torch.Tensor:
        """frames [B, C, F, n_fft] -> [B, C*n_mels, F], the FFT in the frames'
        dtype, as the JAX package's (whose rfft takes no bfloat16: a bf16
        step with mel input is refused, train/steps.py::build_train_steps)."""
        mag = torch.fft.rfft(frames * as_dtype(self.window, frames.dtype), dim=-1).abs()
        mel = torch.log1p(mag @ as_dtype(self.filterbank, mag.dtype).t())  # [B, C, F, M]
        B, C, n, M = mel.shape
        return mel.transpose(2, 3).reshape(B, C * M, n)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, C, T = x.shape
        flat = F.pad(x.reshape(B * C, 1, T), (self.n_fft // 2, self.n_fft // 2), mode="reflect")
        frames = frame_signal(flat.reshape(B, C, -1), self.n_fft, self.hop)[:, :, :-1]
        return self._project(frames)

    def step(self, x: torch.Tensor) -> torch.Tensor:
        if static_size(x, -1) % self.hop:
            raise ValueError(f"a mel block must be a multiple of the hop {self.hop}")
        ext = torch.cat([as_dtype(self.cache, x.dtype), x], dim=-1)
        self.cache = ext[..., ext.shape[-1] - self.cache.shape[-1]:]
        return self._project(frame_signal(ext, self.n_fft, self.hop))


class RAVE(nn.Module):
    """Autoencoder over a latent family of models/blocks.py (reference
    rave/model.py:136-270)."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module, pqmf: PQMFBank,
                 latent_size: int, sampling_rate: int, n_channels: int = 1,
                 input_mode: str = "pqmf", output_mode: str = "pqmf", mel_n_fft: int = 2048,
                 mel_hop: int = 256, n_mels: int = 128, mode: str = "centered",
                 stream_batch: int = 1):
        super().__init__()
        if input_mode not in ("pqmf", "mel", "raw") or output_mode not in ("pqmf", "raw"):
            raise ValueError(f"input_mode={input_mode!r} (pqmf | mel | raw), "
                             f"output_mode={output_mode!r} (pqmf | raw)")
        self.encoder, self.decoder, self.pqmf = encoder, decoder, pqmf
        self.latent_size, self.sampling_rate = latent_size, sampling_rate
        self.n_channels, self.mode = n_channels, mode
        self.input_mode, self.output_mode = input_mode, output_mode
        self.pqmf_analysis = PQMFAnalysis(pqmf, n_channels, mode, stream_batch)
        if input_mode == "mel":
            self.mel_analysis = MelAnalysis(sampling_rate, mel_n_fft, mel_hop, n_mels,
                                            n_channels, stream_batch)
        # the decoder's output delay is in band frames under 'pqmf' output
        self.pqmf_synthesis = PQMFSynthesis(pqmf, n_channels, mode,
                                            decoder.delay if output_mode == "pqmf" else 0,
                                            stream_batch)
        # analysis buffers read by export and the prior (reference rave/model.py:196-198)
        D = latent_size
        self.register_buffer("latent_pca", torch.eye(D))
        self.register_buffer("latent_mean", torch.zeros(D))
        self.register_buffer("fidelity", torch.zeros(D))
        self.register_buffer("receptive_field", torch.zeros(2))

    # ---- streaming delays -------------------------------------------------
    @property
    def encode_delay(self) -> int:
        """Latent-rate delay of streaming encode vs offline (the encoder is
        built with in_delay = the front-end's delay, so it is cumulative)."""
        return self.encoder.delay

    @property
    def decode_delay(self) -> int:
        """Waveform-rate delay of streaming decode vs offline."""
        if self.output_mode != "pqmf":
            return self.decoder.delay
        Q = self.pqmf.taps
        pad_r = 0 if self.mode == "causal" or Q == 0 else Q // 2
        return (self.decoder.delay + pad_r) * max(self.pqmf.n_band, 1)

    # ---- input / output transforms (what the train step composes) ----------
    @property
    def input_transform(self) -> Optional[nn.Module]:
        """The encoder's front-end: PQMF analysis, the mel front-end, or None (raw)."""
        return {"pqmf": self.pqmf_analysis,
                "mel": getattr(self, "mel_analysis", None)}.get(self.input_mode)

    @property
    def output_transform(self) -> Optional[nn.Module]:
        """PQMF synthesis under pqmf output, else None (the decoder writes the waveform)."""
        return self.pqmf_synthesis if self.output_mode == "pqmf" else None

    def transform_input(self, x: torch.Tensor) -> torch.Tensor:
        """[B, n_channels, T] -> the encoder's input: band frames [B,
        n_channels*n_band, T / n_band], mel frames [B, n_channels*n_mels, T /
        hop], or x itself."""
        front = self.input_transform
        return x if front is None else front(x)

    def multiband(self, x: torch.Tensor) -> torch.Tensor:
        """PQMF analysis whatever the input mode (the multiband loss's target)."""
        return self.pqmf_analysis(x)

    def decode_multiband(self, z: torch.Tensor, uniform: Optional[torch.Tensor] = None,
                         warmed_up: bool = True) -> torch.Tensor:
        """The decoder's output, before synthesis (band frames under pqmf
        output). `warmed_up` reaches GeneratorV1 alone, whose noise branch
        is added only after the warmup (rave_tpu/models/rave.py:194-200)."""
        if isinstance(self.decoder, GeneratorV1):
            return self.decoder(z, uniform, warmed_up)
        return self.decoder(z, uniform)

    def synthesize(self, y: torch.Tensor) -> torch.Tensor:
        back = self.output_transform
        return y if back is None else back(y)

    # ---- offline ---------------------------------------------------------
    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """[B, n_channels, T] -> the encoder's output [B, D, T / decimation]
        (D = 2 * latent_size for the variational family, else latent_size)."""
        return self.encoder(self.transform_input(x))

    def reparametrize(self, z: torch.Tensor, draws: LatentDraws
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(decoder input, regularization) of the latent family at inference,
        on the family's `draws` (train/steps.py::draw_noise): the discrete
        family quantizes and updates no codebook."""
        zs, reg, _ = self.encoder.reparametrize(z, draws)
        return zs, reg

    def decode(self, z: torch.Tensor, uniform: Optional[torch.Tensor] = None,
               warmed_up: bool = True) -> torch.Tensor:
        """[B, augmented latent, T_lat] -> [B, n_channels, T_lat * decimation];
        `uniform` feeds the noise branch (`RaveConfig.noise_shape`)."""
        return self.synthesize(self.decode_multiband(z, uniform, warmed_up))

    def forward(self, x: torch.Tensor, draws: LatentDraws) -> torch.Tensor:
        zs, _ = self.reparametrize(self.encode(x), draws)
        return self.decode(zs, draws.uniform)

    # ---- streaming (see nn/streaming.py for the state) ---------------------
    def step_encode(self, x: torch.Tensor) -> torch.Tensor:
        front = self.input_transform
        return self.encoder.step(x if front is None else front.step(x))

    def step_decode(self, z: torch.Tensor, uniform: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        y, back = self.decoder.step(z, uniform), self.output_transform
        return y if back is None else back.step(y)
