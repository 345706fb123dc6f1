"""Autoregressive WaveNet-style prior over RAVE latents.

PyTorch port of rave_tpu/prior/model.py (reference rave/prior/model.py:
Prior 17-165, rave/prior/residual_block.py). Every convolution is causal,
so one module serves teacher-forced training (`forward` over a sequence)
and generation one frame at a time (`step`), whose left context lives in
the convs' stream state (nn/streaming.py): `init_stream_state(prior, B)`
zeroes it, and the artifact's `prior_step` program carries it explicitly.

Layout: the port's channels-first [B, D*R, T] stacked one-hots and logits
(prior/core.py); the JAX package's is [B, T, D*R]. The attribute names
mirror the flax module paths (`pre_net.layers.0`, `res_<i>.dconv`,
`post_net.layers.2`), so `utils/convert.py::from_jax_prior` maps a JAX
prior's params by rename.

What the JAX functions draw from an rng comes in as a tensor here:
`sample_prediction` takes its Gumbel noise (`jax.random.categorical` is
`argmax(logits + gumbel)`), and `generate` takes one Gumbel draw per step
or a `torch.Generator` to draw them from.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rave_tpu_torch.factory import init_weights, resolve_device
from rave_tpu_torch.models.blocks import leaky_relu
from rave_tpu_torch.nn.combinators import Lambda, Sequential
from rave_tpu_torch.nn.conv import Conv1d
from rave_tpu_torch.nn.streaming import init_stream_state
from rave_tpu_torch.prior.core import stack_one_hot


class GatedResidualBlock(nn.Module):
    """sigmoid(xa) * tanh(xb) gate over a causal dilated conv, with 1x1
    residual and skip projections (reference rave/prior/residual_block.py:6-31)."""

    def __init__(self, res_size: int, skp_size: int, kernel_size: int, dilation: int,
                 stream_batch: int = 1):
        super().__init__()
        self.dconv = Conv1d(res_size, 2 * res_size, kernel_size, dilation=dilation,
                            mode="causal", stream_batch=stream_batch)
        self.rconv = Conv1d(res_size, res_size, 1)
        self.sconv = Conv1d(res_size, skp_size, 1)

    def _gate(self, x, res, skp):
        xa, xb = x.chunk(2, dim=1)
        g = torch.sigmoid(xa) * torch.tanh(xb)
        return res + self.rconv(g), skp + self.sconv(g)

    def forward(self, x, skp):
        return self._gate(self.dconv(x), x, skp)

    def step(self, x, skp):
        return self._gate(self.dconv.step(x), x, skp)


class Prior(nn.Module):
    """Grouped causal pre-net -> gated residual stack -> grouped post-net over
    stacked one-hot quantized latents (reference rave/prior/model.py:38-67,
    103-109). Defaults: the reference's prior_v1.gin."""

    def __init__(self, latent_size: int, resolution: int = 32, res_size: int = 512,
                 skp_size: int = 256, kernel_size: int = 3, cycle_size: int = 4,
                 n_layers: int = 10, stream_batch: int = 1):
        super().__init__()
        self.latent_size, self.resolution = latent_size, resolution
        self.res_size, self.skp_size = res_size, skp_size
        self.kernel_size, self.cycle_size, self.n_layers = kernel_size, cycle_size, n_layers
        dr = resolution * latent_size
        self.pre_net = Sequential([
            Conv1d(dr, res_size, kernel_size, mode="causal", groups=latent_size,
                   stream_batch=stream_batch),
            Lambda(leaky_relu),
        ])
        for i in range(n_layers):  # flax names them res_<i>
            self.add_module(f"res_{i}", GatedResidualBlock(
                res_size, skp_size, kernel_size, 2 ** (i % cycle_size), stream_batch))
        self.post_net = Sequential([
            Conv1d(skp_size, skp_size, 1),
            Lambda(leaky_relu),
            Conv1d(skp_size, dr, 1, groups=latent_size),
        ])

    @property
    def residuals(self) -> List[GatedResidualBlock]:
        return [getattr(self, f"res_{i}") for i in range(self.n_layers)]

    @property
    def receptive_field(self) -> int:
        return (self.kernel_size - 1) * int(
            np.sum(2 ** (np.arange(self.n_layers) % self.cycle_size))) + 1

    def _skip(self, res):
        return torch.zeros(res.shape[0], self.skp_size, res.shape[2], dtype=res.dtype,
                           device=res.device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[B, D*R, T] -> logits [B, D*R, T]; logit t sees inputs up to t."""
        res = self.pre_net(x)
        skp = self._skip(res)
        for layer in self.residuals:
            res, skp = layer(res, skp)
        return self.post_net(skp)

    def step(self, x: torch.Tensor) -> torch.Tensor:
        """One or more frames [B, D*R, n] -> logits [B, D*R, n], carrying the
        convs' left context in their stream state."""
        res = self.pre_net.step(x)
        skp = self._skip(res)
        for layer in self.residuals:
            res, skp = layer.step(res, skp)
        return self.post_net.step(skp)


def build_prior(latent_size: int, resolution: int = 32, res_size: int = 512,
                skp_size: int = 256, kernel_size: int = 3, cycle_size: int = 4,
                n_layers: int = 10, stream_batch: int = 1, seed: int = 0,
                device: str | torch.device = "cuda") -> Prior:
    """The prior on `device`, weights drawn from `torch.Generator().manual_seed(seed)`
    (each conv's lecun-normal kernel, its fan-in per group, in module order)."""
    device = resolve_device(device)
    prior = Prior(latent_size, resolution, res_size, skp_size, kernel_size, cycle_size,
                  n_layers, stream_batch)
    init_weights(prior, torch.Generator().manual_seed(seed))
    return prior.to(device)


def split_classes(x: torch.Tensor, latent_size: int) -> torch.Tensor:
    """[B, D*R, T] -> [B, D, R, T] (reference rave/prior/model.py:129-134)."""
    B, _, T = x.shape
    return x.reshape(B, latent_size, -1, T)


def prior_loss(prior: Prior, x_onehot: torch.Tensor, latent_size: int,
               n_real: Optional[int] = None) -> torch.Tensor:
    """Teacher-forced next-step cross-entropy (reference rave/prior/model.py:
    151-165), averaged over the first `n_real` rows when given."""
    logits = prior(x_onehot)
    target = split_classes(x_onehot[..., 1:], latent_size).argmax(2)  # [B, D, T-1]
    logp = F.log_softmax(split_classes(logits[..., :-1], latent_size), dim=2)
    nll = -logp.gather(2, target[:, :, None]).squeeze(2)
    if n_real is not None:
        nll = nll[:n_real]
    return nll.mean()


def gumbel_from_uniform(u: torch.Tensor) -> torch.Tensor:
    """Standard Gumbel draws from uniforms in [0, 1) (0 clamped to the
    smallest normal float, as `jax.random.gumbel` draws its uniforms)."""
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(u.dtype).tiny)))


def sample_prediction(logits: torch.Tensor, latent_size: int, resolution: int,
                      gumbel: Optional[torch.Tensor] = None, argmax: bool = False
                      ) -> torch.Tensor:
    """Logits [B, D*R, T] -> sampled stacked one-hots [B, D*R, T] (reference
    rave/prior/model.py:136-149): the argmax of each dimension's logits, plus
    `gumbel` [B, D, R, T] unless `argmax` (a categorical draw)."""
    cls = split_classes(logits, latent_size)
    if not argmax:
        cls = cls + gumbel.to(cls.dtype)
    return stack_one_hot(cls.argmax(2), resolution)


@torch.no_grad()
def generate(prior: Prior, x0: torch.Tensor, n_steps: int,
             gumbel: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None,
             argmax: bool = False) -> torch.Tensor:
    """`n_steps` frames from a zeroed stream state, one `step` each, fed back
    (reference rave/prior/model.py:111-127): `x0` [B, D*R, 1] seeds the
    chain; returns [B, D*R, n_steps] stacked one-hots. Step i's Gumbel noise
    is `gumbel[i]` ([n_steps, B, D, R, 1]), or else drawn from `generator`."""
    D, R = prior.latent_size, prior.resolution
    init_stream_state(prior, x0.shape[0])
    x, ys = x0, []
    for i in range(n_steps):
        logits = prior.step(x)
        g = None
        if not argmax:
            g = gumbel[i] if gumbel is not None else gumbel_from_uniform(torch.rand(
                (x0.shape[0], D, R, 1), generator=generator, device=x0.device))
        x = sample_prediction(logits, D, R, g, argmax)
        ys.append(x)
    return torch.cat(ys, dim=-1)
