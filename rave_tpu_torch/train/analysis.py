"""Validation-time analytics: the receptive-field probe and the latent PCA.

PyTorch port of rave_tpu/train/analysis.py::receptive_field (reference
rave/core.py:180-217). In eval mode, as the JAX probe's `train=False`
model, it differentiates one output sample of encode ->
reparametrize -> decode with respect to the input and reads the extent of
the non-zero gradient. The discrete family's inference quantization looks
codes up, so no gradient reaches the input: its field is (0, 0), as in the
JAX package, without a probe. The probe is architectural, so it runs a
clone without GRUs (the reference disables recurrent layers for the same
reason, rave/core.py:186-189). The training loop turns it into the
valid-signal crop `rf // crop_dim` (rave_tpu/train/loop.py:165-175). On a
GPU the probe runs through the fused units' `autograd.Function`, kernel
forward and plain backward.

`pca` is rave_tpu/train/analysis.py::pca, the same numpy: the loop turns
the validation latents into the model's `latent_pca`, `latent_mean` and
`fidelity` buffers (reference rave/model.py:463-488).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from rave_tpu_torch.config import RaveConfig
from rave_tpu_torch.factory import build_rave
from rave_tpu_torch.train.steps import draw_noise


def receptive_field(cfg: RaveConfig, n_channels: int = 1, device: str | torch.device = "cuda",
                    seed: int = 0) -> Tuple[int, int]:
    """(left, right) receptive field of encode + decode, in samples, from a
    freshly seeded model; the probe length doubles from 2**15 until the
    gradient's footprint fits."""
    if cfg.latent.family == "discrete":
        return 0, 0
    probe = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, recurrent_layers=0),
                                decoder=dataclasses.replace(cfg.decoder, recurrent_layers=0))
    model = build_rave(probe, n_channels=n_channels, seed=seed, device=device).eval()
    model.requires_grad_(False)  # the input's gradient is all the probe reads
    N = 2 ** 15
    while True:
        x = np.random.default_rng(0).standard_normal((1, N, n_channels)).astype(np.float32)
        x = torch.from_numpy(x.transpose(0, 2, 1).copy()).to(device).requires_grad_()
        draws = draw_noise(cfg, x.detach().cpu(), torch.Generator().manual_seed(seed + 2))
        zs, _ = model.reparametrize(model.encode(x), draws.to(device))
        y = model.decode(zs, None if draws.uniform is None else draws.uniform.to(device))
        (grad,) = torch.autograd.grad(y[0, 0, y.shape[-1] // 2], x)
        g = grad[0, 0].abs().cpu().numpy()
        if g[0] == 0 and g[-1] == 0:
            nz = np.nonzero(g > 0)[0]
            mid = N // 2
            left = int(mid - nz.min()) if len(nz) else 0
            right = int(nz.max() - mid) if len(nz) else 0
            return left, right
        N *= 2
        if N > 2 ** 21:
            raise RuntimeError("receptive field larger than 2^21 samples")


def crop_dim(cfg: RaveConfig, n_channels: int = 1) -> int:
    """The divisor of the receptive field in `crop_frames`: n_band * channels
    under PQMF input, else the channels, as rave_tpu/train/loop.py:168 has
    it (a crop of band frames by samples under mel and raw input)."""
    return cfg.n_band * n_channels if cfg.input_mode == "pqmf" else n_channels


def crop_frames(cfg: RaveConfig, rf: Tuple[int, int], n_channels: int = 1) -> Tuple[int, int]:
    """The band frames `valid_signal_crop` drops on each side (loop.py:168-169)."""
    dim = crop_dim(cfg, n_channels)
    return rf[0] // dim, rf[1] // dim


def valid_crop(cfg: RaveConfig, rf: Tuple[int, int], n_signal: int,
               n_channels: int = 1) -> Tuple[int, int]:
    """`crop_frames`, or a ValueError where it leaves the multiband loss no
    band frame. The bands (`RAVE.multiband`, a PQMF under every input) hold
    n_signal / n_band frames of each channel, and the crop is rave_tpu's.
    Under mel and raw input that crop counts samples as band frames, and
    rave_tpu's guard, which compares it with n_signal, lets a crop through
    that empties the loss (ROADMAP C12); here it raises. Under PQMF input
    both guards are the same."""
    crop = crop_frames(cfg, rf, n_channels)
    frames = n_signal // cfg.n_band
    if crop[0] + crop[1] >= frames:
        why = "" if cfg.input_mode == "pqmf" else (
            f"; under {cfg.input_mode} input the crop divides the receptive field by the "
            f"channels alone, as rave_tpu does, a crop rave_tpu's guard lets through to a loss "
            f"over no frame (ROADMAP C12)")
        raise ValueError(
            f"n_signal={n_signal} leaves no valid signal after cropping the model's receptive "
            f"field ({rf[0]}+{rf[1]} samples, {crop[0]}+{crop[1]} of the {frames} band frames)"
            f" — raise --n_signal or disable train.valid_signal_crop{why}")
    return crop


def pca(latents: np.ndarray):
    """Full PCA of [N, D] latents -> (components [D, D], mean [D],
    cumulative explained-variance 'fidelity' [D]), float32; a numpy SVD
    stand-in for sklearn.PCA."""
    mean = latents.mean(0)
    z = latents - mean
    _, s, vt = np.linalg.svd(z, full_matrices=False)  # rows of vt: the principal axes
    var = s**2 / max(len(z) - 1, 1)
    fidelity = np.cumsum(var / var.sum())
    comp = vt
    if comp.shape[0] < z.shape[1]:  # fewer samples than dims: pad the basis
        comp = np.concatenate([comp, np.eye(z.shape[1])[comp.shape[0]:]], 0)
        fidelity = np.pad(fidelity, (0, z.shape[1] - len(fidelity)), constant_values=1.0)
    return comp.astype(np.float32), mean.astype(np.float32), fidelity.astype(np.float32)
