"""The RAVE autoencoder: PQMF analysis -> encoder -> decoder -> PQMF
synthesis, with the analysis buffers that export reads.

PyTorch port of rave_tpu/models/rave.py for `input_mode` / `output_mode`
'pqmf'. Layout: waveforms [B, n_channels, T], latents [B, D, T_lat], as in
the reference RAVE.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from rave_tpu_torch.models.blocks import LatentDraws
from rave_tpu_torch.models.pqmf_module import PQMFAnalysis, PQMFSynthesis
from rave_tpu_torch.ops.pqmf import PQMFBank


class RAVE(nn.Module):
    """Autoencoder over a latent family of models/blocks.py (reference
    rave/model.py:136-270)."""

    def __init__(self, encoder: nn.Module, decoder: nn.Module, pqmf: PQMFBank,
                 latent_size: int, sampling_rate: int, n_channels: int = 1,
                 input_mode: str = "pqmf", output_mode: str = "pqmf", mode: str = "centered",
                 stream_batch: int = 1):
        super().__init__()
        if input_mode != "pqmf" or output_mode != "pqmf":
            raise NotImplementedError(
                f"input_mode={input_mode!r}, output_mode={output_mode!r}: only 'pqmf' is "
                "ported (mel input: ROADMAP A11; raw output: ROADMAP A11)"
            )
        self.encoder, self.decoder, self.pqmf = encoder, decoder, pqmf
        self.latent_size, self.sampling_rate = latent_size, sampling_rate
        self.n_channels, self.mode = n_channels, mode
        self.pqmf_analysis = PQMFAnalysis(pqmf, n_channels, mode, stream_batch)
        # the decoder's output delay is in band frames under 'pqmf' output
        self.pqmf_synthesis = PQMFSynthesis(pqmf, n_channels, mode, decoder.delay, stream_batch)
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
        built with in_delay = PQMF analysis delay, so it is cumulative)."""
        return self.encoder.delay

    @property
    def decode_delay(self) -> int:
        """Waveform-rate delay of streaming decode vs offline."""
        Q = self.pqmf.taps
        pad_r = 0 if self.mode == "causal" or Q == 0 else Q // 2
        return (self.decoder.delay + pad_r) * max(self.pqmf.n_band, 1)

    # ---- input / output transforms (what the train step composes) ----------
    def transform_input(self, x: torch.Tensor) -> torch.Tensor:
        """[B, n_channels, T] -> band frames [B, n_channels*n_band, T / n_band]."""
        return self.pqmf_analysis(x)

    def multiband(self, x: torch.Tensor) -> torch.Tensor:
        """PQMF analysis whatever the input mode (the multiband loss's target)."""
        return self.pqmf_analysis(x)

    def decode_multiband(self, z: torch.Tensor) -> torch.Tensor:
        """Decoder output in band frames, before synthesis."""
        return self.decoder(z)

    def synthesize(self, y_mb: torch.Tensor) -> torch.Tensor:
        return self.pqmf_synthesis(y_mb)

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

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """[B, augmented latent, T_lat] -> [B, n_channels, T_lat * decimation]."""
        return self.synthesize(self.decode_multiband(z))

    def forward(self, x: torch.Tensor, draws: LatentDraws) -> torch.Tensor:
        zs, _ = self.reparametrize(self.encode(x), draws)
        return self.decode(zs)

    # ---- streaming (see nn/streaming.py for the state) ---------------------
    def step_encode(self, x: torch.Tensor) -> torch.Tensor:
        return self.encoder.step(self.pqmf_analysis.step(x))

    def step_decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.pqmf_synthesis.step(self.decoder.step(z))
