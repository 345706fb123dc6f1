"""Residual vector quantization with EMA codebooks.

PyTorch port of rave_tpu/models/quantization.py (reference
rave/quantization.py). Layout: vectors on the last axis, `[..., D]`, as in
the JAX package; `DiscreteEncoder` (models/blocks.py) transposes the port's
`[B, D, T]` latents at its boundary.

The codebook state (`embed`, `embed_avg`, `cluster_size`, `inited`) is
registered buffers, so `state_dict`, checkpoints and export carry it. A
training call is functional: it returns the new state beside its output
and leaves the buffers alone; the train step assigns the state once, after
its backward (`commit`). So `train.remat`'s recompute sees the codebook and
the draws the forward saw and picks the same codes, as the JAX step, whose
model state goes out as `new_ms`. One training call runs in the JAX order:

  1. the k-means init, only while `inited` is 0 (`kmeans`);
  2. the nearest codes under the embed as it stands after the init;
  3. the EMA update of `cluster_size` and `embed_avg`, and the Laplace
     smoothed `embed`;
  4. dead-code expiry against the updated `cluster_size`;
  5. the straight-through estimator and the commitment loss.

The random sample indices of the init and of the expiry are inputs
(`init_idx`, `expire_idx`: `[codebook_size]` each), drawn by the caller, so
a test can hand both packages the same numbers. Whether to init is read on
the host: once per buffer version (`needs_init`), not once per step.

Under data parallelism (parallel/mesh.py::sharded_batch) a training call
runs steps 1-4 on every rank's samples gathered in rank order, as JAX's
step over the global batch does, so every rank commits the same state;
each rank quantizes its own rows.

The nearest code is the JAX formula, argmax(2 x e^T - |x|^2 - |e|^2), a
`[P, D] x [D, N]` product: not `cdist` or an argmin of distances, which
round differently and can break ties differently.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from rave_tpu_torch.parallel import mesh


def nearest(samples: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """Index of the nearest row of codes [N, D] for each row of samples [P, D]."""
    dist = (2 * samples @ codes.T - torch.sum(samples**2, -1, keepdim=True)
            - torch.sum(codes**2, -1)[None, :])
    return torch.argmax(dist, dim=-1)


def kmeans(samples: torch.Tensor, num_clusters: int, iters: int,
           init_idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-iteration k-means from the rows `init_idx` of samples [P, D]:
    (means [N, D], bins [N]) (reference rave/quantization.py:36-56)."""
    means = samples[init_idx]
    for _ in range(iters):
        onehot = F.one_hot(nearest(samples, means), num_clusters).to(samples.dtype)
        bins = onehot.sum(0)
        new_means = onehot.T @ samples / bins.clamp_min(1.0)[:, None]
        means = torch.where(bins[:, None] == 0, means, new_means)
    bins = F.one_hot(nearest(samples, means), num_clusters).to(samples.dtype).sum(0)
    return means, bins


class EuclideanCodebook(nn.Module):
    """EMA-updated codebook with k-means init and dead-code expiry
    (reference rave/quantization.py:59-181), at the JAX package's decay,
    smoothing, dead-code threshold and k-means iterations (no RAVE config
    sets others)."""

    STATE = ("embed", "embed_avg", "cluster_size", "inited")
    DECAY, EPSILON, THRESHOLD_EMA_DEAD_CODE, KMEANS_ITERS = 0.99, 1e-5, 2, 50

    def __init__(self, dim: int, codebook_size: int):
        super().__init__()
        self.dim, self.codebook_size = dim, codebook_size
        self.register_buffer("embed", torch.zeros(codebook_size, dim))
        self.register_buffer("embed_avg", torch.zeros(codebook_size, dim))
        self.register_buffer("cluster_size", torch.zeros(codebook_size))
        self.register_buffer("inited", torch.tensor(0.0))
        self._seen: Optional[tuple] = None  # (the `inited` tensor last read, its version)
        self._needs_init = True

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """The JAX initializer, variance_scaling(1, fan_in, uniform) on
        [N, D] (fan_in = N), drawn from `generator`; embed_avg a copy."""
        limit = math.sqrt(3.0 / self.codebook_size)
        embed = torch.empty(self.embed.shape).uniform_(-limit, limit, generator=generator)
        self.embed.copy_(embed)
        self.embed_avg.copy_(embed)

    def needs_init(self) -> bool:
        """`inited == 0`, read on the host when the buffer changed since the
        last read (it was loaded, written or replaced), else from that read.
        The read keeps its tensor alive, so no other tensor takes its place."""
        seen, inited = self._seen, self.inited
        if seen is None or seen[0] is not inited or seen[1] != inited._version:
            self._seen, self._needs_init = (inited, inited._version), bool(inited == 0)
        return self._needs_init

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """[..., D] -> code indices [...]."""
        flat = x.reshape(-1, x.shape[-1])
        return nearest(flat, self.embed.to(flat.dtype)).reshape(x.shape[:-1])

    def decode(self, idx: torch.Tensor) -> torch.Tensor:
        return self.embed[idx]

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Inference: x [..., D] -> (quantized [..., D], indices [...])."""
        flat = x.reshape(-1, x.shape[-1]).float()
        idx = nearest(flat, self.embed.to(flat.dtype))
        return self.embed[idx].reshape(x.shape).to(x.dtype), idx.reshape(x.shape[:-1])

    def train_call(self, x: torch.Tensor, init_idx: torch.Tensor, expire_idx: torch.Tensor):
        """Training: (quantized [..., D], indices [...], new state {name: tensor})."""
        flat = x.reshape(-1, x.shape[-1]).float()
        # the state is not differentiated; under data parallelism it trains on
        # every rank's samples, in rank order (parallel/mesh.py)
        samples = mesh.gather_rows(flat.detach())
        embed, embed_avg, cluster_size = self.embed, self.embed_avg, self.cluster_size
        if self.needs_init():
            embed, cluster_size = kmeans(samples, self.codebook_size, self.KMEANS_ITERS,
                                         init_idx)
            embed_avg = embed
        idx_all = nearest(samples, embed.to(samples.dtype))
        start = mesh.rank() * flat.shape[0] if mesh.batch_shards() > 1 else 0
        idx = idx_all[start:start + flat.shape[0]]
        quantized = embed[idx].reshape(x.shape).to(x.dtype)

        d, eps, n_codes = self.DECAY, self.EPSILON, self.codebook_size
        onehot = F.one_hot(idx_all, n_codes).float()
        csize = cluster_size * d + onehot.sum(0) * (1 - d)
        eavg = embed_avg * d + (onehot.T @ samples) * (1 - d)
        n = torch.sum(csize)
        smoothed = (csize + eps) / (n + n_codes * eps) * n
        expired = csize < self.THRESHOLD_EMA_DEAD_CODE
        new_embed = torch.where(expired[:, None], samples[expire_idx], eavg / smoothed[:, None])
        state = {"embed": new_embed, "embed_avg": eavg, "cluster_size": csize,
                 "inited": torch.ones_like(self.inited)}
        return quantized, idx.reshape(x.shape[:-1]), state

    @torch.no_grad()
    def commit(self, state: Dict[str, torch.Tensor]) -> None:
        """Assign the state a training call returned."""
        for name in self.STATE:
            getattr(self, name).copy_(state[name])
        self._seen, self._needs_init = (self.inited, self.inited._version), False


class VectorQuantization(nn.Module):
    """One VQ stage: straight-through estimator and commitment loss
    (reference rave/quantization.py:184-270; the port has no projections:
    every RAVE codebook has the latent's width), at commitment weight 1."""

    def __init__(self, dim: int, codebook_size: int):
        super().__init__()
        self.codebook = EuclideanCodebook(dim, codebook_size)

    def forward(self, x: torch.Tensor, init_idx: Optional[torch.Tensor] = None,
                expire_idx: Optional[torch.Tensor] = None, train: bool = False):
        """x [..., D] -> (quantized, indices, commitment loss, new state or None)."""
        if not train:
            q, idx = self.codebook(x)
            return q, idx, x.new_zeros((), dtype=torch.float32), None
        q, idx, state = self.codebook.train_call(x, init_idx, expire_idx)
        q = x + (q - x).detach()  # straight-through
        return q, idx, torch.mean((q.detach() - x) ** 2), state


class ResidualVectorQuantization(nn.Module):
    """Stack of VQ layers over successive residuals (SoundStream Alg. 1;
    reference rave/quantization.py:273-318). Indices [B, Q, T] of x [B, T, D]."""

    def __init__(self, num_quantizers: int, dim: int, codebook_size: int):
        super().__init__()
        self.vq = nn.ModuleList(VectorQuantization(dim, codebook_size)
                                for _ in range(num_quantizers))

    def forward(self, x: torch.Tensor, init_idx: Optional[torch.Tensor] = None,
                expire_idx: Optional[torch.Tensor] = None, train: bool = False):
        """x [B, T, D] -> (quantized, summed commitment loss, indices [B, Q, T],
        per-layer new states or None). Training takes `init_idx` and
        `expire_idx` [Q, codebook_size], row i for layer i."""
        quantized, residual = torch.zeros_like(x), x
        losses, indices, states = [], [], []
        for i, layer in enumerate(self.vq):
            q, idx, loss, state = layer(residual, None if init_idx is None else init_idx[i],
                                        None if expire_idx is None else expire_idx[i], train)
            residual = residual - q
            quantized = quantized + q
            losses.append(loss)
            indices.append(idx)
            states.append(state)
        return (quantized, torch.sum(torch.stack(losses)), torch.stack(indices, dim=1),
                states if train else None)

    def commit(self, states: List[Dict[str, torch.Tensor]]) -> None:
        for layer, state in zip(self.vq, states):
            layer.codebook.commit(state)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, T, D] -> indices [B, Q, T]."""
        residual, out = x, []
        for layer in self.vq:
            idx = layer.codebook.encode(residual)
            residual = residual - layer.codebook.decode(idx)
            out.append(idx)
        return torch.stack(out, dim=1)

    def decode(self, indices: torch.Tensor) -> torch.Tensor:
        """indices [B, Q, T] -> [B, T, D]."""
        out = 0.0
        for i, layer in enumerate(self.vq):
            out = out + layer.codebook.decode(indices[:, i])
        return out
