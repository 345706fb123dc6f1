"""Device-resident dataset: the whole ARS store on the card, batches made there.

The port's counterpart of rave_tpu/data/device_data.py, in plain torch (the
JAX one is plain XLA, not a Pallas kernel). The int16 records are uploaded
once; each training batch is gathered, cropped, phase-mangled by the
standard pipeline's RandomApply(allpass, p=.8) and dithered by
Dequantize(16) (reference rave/dataset.py:223-231) on the card, so the
steady-state loop moves no batch from the host. It serves the standard
pipeline only (no augmentation, derivative, normalization or pitch), as the
JAX one does.

The batch is deterministic in (seed, step): `draws(step)` takes the random
numbers (rows, crop offsets, allpass frequencies, apply mask, dither) from a
generator seeded by `fold_in(seed, step)` (utils/rng.py), and `assemble`
turns them into the batch with no randomness of its own, so a test can hand
it the JAX pipeline's draws, and a resumed run continues the schedule of an
unbroken one.

The phase mangle is the reference biquad allpass (conjugate pole pair,
amplitude .99, log-uniform 20..2000 Hz — rave/core.py:24-45) applied in the
frequency domain: with the signal zero-padded by 8192 samples the truncated
IIR tail is below 1e-30 (0.99^8192). Its response is evaluated in the
factored form of its poles, which keeps it within ~4e-7 of
scipy.signal.lfilter in float64 where the JAX package's expanded
polynomials, in float32, come ~6e-5 from it near the pole
(tests/test_torch_data.py).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence

import numpy as np
import torch

from rave_tpu_torch.data.store import ArsReader
from rave_tpu_torch.utils.rng import step_generator

MANGLE_PAD = 8192  # 0.99^8192 ~ 1e-36: IIR tail truncation below fp32 eps
MANGLE_P = 0.8  # RandomApply's probability (rave/dataset.py:227)
UPLOAD_RECORDS = 256  # records per host -> device copy


def db_nbytes(db_path: str) -> int:
    return ArsReader(db_path).nbytes()


def allpass_mangle(x: torch.Tensor, u: torch.Tensor, apply: torch.Tensor, sr: int,
                   min_f: float = 20.0, max_f: float = 2000.0,
                   amplitude: float = 0.99) -> torch.Tensor:
    """The random allpass on [B, C, T], given its draws: `u` [B] uniform in
    [0, 1) picks each row's frequency log-uniformly in [min_f, max_f];
    rows where `apply` [B] is False pass through unchanged."""
    T = x.shape[-1]
    omega = (2.0 * math.pi / sr * torch.exp(
        u.float() * (math.log(max_f) - math.log(min_f)) + math.log(min_f)))[:, None]
    L = 1 << int(math.ceil(math.log2(T + MANGLE_PAD)))
    w = 2.0 * math.pi * torch.arange(L // 2 + 1, device=x.device, dtype=torch.float32) / L
    # b = [a^2, -2a cos(omega), 1], a = [1, -2a cos(omega), a^2]
    # (transforms.pole_to_z_filter), factored by the poles a e^{+-i omega}:
    # A(w) = (1 - a e^{i(omega - w)}) (1 - a e^{-i(omega + w)}) and
    # H(w) = e^{-2iw} conj(A) / A. The expanded form cancels near the pole in
    # float32 (~1e-4 of H there); the factored one takes omega - w directly.
    A = ((1 - amplitude * torch.exp(1j * (omega - w)))
         * (1 - amplitude * torch.exp(-1j * (omega + w))))
    H = torch.exp(-2j * w) * A.conj() / A
    y = torch.fft.irfft(torch.fft.rfft(x, n=L, dim=-1) * H[:, None, :], n=L, dim=-1)[..., :T]
    return torch.where(apply[:, None, None], y.to(x.dtype), x)


class Draws(NamedTuple):
    """The random numbers of one batch."""

    rows: torch.Tensor  # [B] record numbers
    offsets: torch.Tensor  # [B] crop starts
    u: torch.Tensor  # [B] uniform: the allpass frequency
    apply: torch.Tensor  # [B] bool: mangle this row
    dither: torch.Tensor  # [B, C, n_signal] uniform in [0, 1)


class DeviceDataPipeline:
    """Batch maker over the store held on `device`: `batch_at(step)` is a
    [B, C, n_signal] float32 batch, deterministic in (seed, step)."""

    def __init__(self, db_path: str, indices: Sequence[int], batch: int, n_signal: int,
                 sr: int, seed: int = 0, device: str | torch.device = "cuda"):
        reader = ArsReader(db_path)
        if reader.num_signal < n_signal:
            raise ValueError(f"records of {reader.num_signal} samples cannot yield "
                             f"{n_signal}-sample crops")
        records = reader.records()  # [N, S, C] int16, memory-mapped
        self.device = torch.device(device)
        self.records = torch.empty(records.shape, dtype=torch.int16, device=self.device)
        for i in range(0, len(records), UPLOAD_RECORDS):
            self.records[i : i + UPLOAD_RECORDS] = torch.from_numpy(
                np.array(records[i : i + UPLOAD_RECORDS]))
        self.indices = torch.as_tensor(np.asarray(indices, np.int64), device=self.device)
        self.batch, self.n_signal, self.sr, self.seed = batch, n_signal, sr, seed
        self.channels = reader.channels
        self.max_offset = reader.num_signal - n_signal

    def draws(self, step: int) -> Draws:
        g = step_generator(self.seed, step, self.device)
        B, dev = self.batch, self.device
        pick = torch.randint(0, len(self.indices), (B,), generator=g, device=dev)
        offsets = torch.randint(0, self.max_offset + 1, (B,), generator=g, device=dev)
        u = torch.rand(B, generator=g, device=dev)
        apply = torch.rand(B, generator=g, device=dev) < MANGLE_P
        dither = torch.rand(B, self.channels, self.n_signal, generator=g, device=dev)
        return Draws(self.indices[pick], offsets, u, apply, dither)

    def assemble(self, d: Draws) -> torch.Tensor:
        """Gather, crop, mangle and dither: the batch the draws `d` make."""
        pos = d.offsets[:, None] + torch.arange(self.n_signal, device=self.device)
        x = self.records[d.rows[:, None], pos].permute(0, 2, 1).float() / 32767.0
        x = allpass_mangle(x, d.u, d.apply, self.sr)
        return x + d.dither / 2**15

    def batch_at(self, step: int) -> torch.Tensor:
        return self.assemble(self.draws(step))
