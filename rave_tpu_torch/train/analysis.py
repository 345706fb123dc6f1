"""Validation-time analytics: the receptive-field probe and the latent PCA.

PyTorch port of rave_tpu/train/analysis.py::receptive_field (reference
rave/core.py:180-217). It differentiates one output sample of encode ->
reparametrize -> decode with respect to the input and reads the extent of
the non-zero gradient; the training loop turns it into the valid-signal crop
`rf // n_band` (rave_tpu/train/loop.py:165-169). On a GPU the probe runs
through the fused units' `autograd.Function`, kernel forward and plain
backward.

`pca` is rave_tpu/train/analysis.py::pca, the same numpy: the loop turns
the validation latents into the model's `latent_pca`, `latent_mean` and
`fidelity` buffers (reference rave/model.py:463-488).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from rave_tpu_torch.config import RaveConfig
from rave_tpu_torch.factory import build_rave


def receptive_field(cfg: RaveConfig, n_channels: int = 1, device: str | torch.device = "cuda",
                    seed: int = 0) -> Tuple[int, int]:
    """(left, right) receptive field of encode + decode, in samples, from a
    freshly seeded model; the probe length doubles from 2**15 until the
    gradient's footprint fits."""
    model = build_rave(cfg, n_channels=n_channels, seed=seed, device=device)
    model.requires_grad_(False)  # the input's gradient is all the probe reads
    N = 2 ** 15
    while True:
        x = np.random.default_rng(0).standard_normal((1, N, n_channels)).astype(np.float32)
        x = torch.from_numpy(x.transpose(0, 2, 1).copy()).to(device).requires_grad_()
        z = model.encode(x)
        eps = torch.randn(1, cfg.latent_size, z.shape[-1],
                          generator=torch.Generator().manual_seed(seed + 2))
        zs, _ = model.reparametrize(z, eps=eps.to(device))
        y = model.decode(zs)
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


def crop_frames(cfg: RaveConfig, rf: Tuple[int, int], n_channels: int = 1) -> Tuple[int, int]:
    """The band frames `valid_signal_crop` drops on each side (loop.py:168-169)."""
    dim = cfg.n_band * n_channels
    return rf[0] // dim, rf[1] // dim


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
