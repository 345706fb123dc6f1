"""DSP primitives of the noise synth, and the training step's losses.

PyTorch port of rave_tpu/ops/dsp.py (reference rave/core.py:20-81,
151-170, 236-252). `mod_sigmoid`, `amp_to_impulse_response` and
`fft_convolve` work on the last axis, as there. The losses reduce to a
mean over all elements, so they are indifferent to layout: the port's
channels-first and folded critic feature maps give the same values as the
JAX package's channels-last ones. `get_beta_kl`, `get_beta_kl_cyclic` and
`get_beta_kl_cyclic_annealed` are the reference's beta-KL schedules
(rave_tpu/ops/dsp.py:113-128), which neither package's step calls.

Under data parallelism (parallel/mesh.py::sharded_batch) a relative
`mean_difference` divides the global batch's mean difference by the
global batch's mean energy, as JAX's step over the global batch does: both
sums are reduced over the ranks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from rave_tpu_torch.nn.streaming import static_size
from rave_tpu_torch.parallel import mesh


def mod_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """Exponentiated sigmoid of the amplitude envelopes: 2 sigmoid(x)^2.3 + 1e-7."""
    return 2 * torch.sigmoid(x) ** 2.3 + 1e-7


def at_least_float32(x: torch.Tensor) -> torch.Tensor:
    """`x` in float32, or as it is when it is float64 (a float64 twin's pass)."""
    return x if x.dtype == torch.float64 else x.float()


def amp_to_impulse_response(amp: torch.Tensor, target_size: int) -> torch.Tensor:
    """Real zero-phase amplitudes [..., F] -> a causal FIR kernel [..., target_size]
    in float32 (float64 for float64 amplitudes): the symmetric impulse
    response, rolled to its centre, windowed by a periodic Hann, zero-padded
    (or cropped from its end, when it is longer than `target_size`, as
    torch's negative pad does in the reference) and rolled back."""
    ir = torch.fft.irfft(at_least_float32(amp), dim=-1)
    filter_size = static_size(ir, -1)
    ir = torch.roll(ir, filter_size // 2, dims=-1)
    n = torch.arange(filter_size, dtype=torch.float64, device=ir.device)
    win = (0.5 - 0.5 * torch.cos(2 * torch.pi * n / filter_size)).to(ir.dtype)  # hanning(n+1)[:-1]
    ir = ir * win
    extra = int(target_size) - filter_size
    ir = F.pad(ir, (0, extra)) if extra >= 0 else ir[..., : int(target_size)]
    return torch.roll(ir, -(filter_size // 2), dims=-1)


def fft_convolve(signal: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Linear convolution of `signal` by `kernel` along the last axis by FFT,
    the first len(signal) samples (both zero-padded to twice the length)."""
    n = signal.shape[-1]
    signal = F.pad(signal, (0, n))
    kernel = F.pad(kernel, (kernel.shape[-1], 0))
    out = torch.fft.irfft(torch.fft.rfft(signal) * torch.fft.rfft(kernel), n=signal.shape[-1])
    return out[..., out.shape[-1] // 2 :]


def mean_difference(target: torch.Tensor, value: torch.Tensor, norm: str = "L1",
                    relative: bool = False) -> torch.Tensor:
    """Mean L1/L2 difference, optionally relative to the target's energy."""
    diff = target - value
    if norm == "L1":
        d, energy = diff.abs(), target.abs() if relative else None
    elif norm == "L2":
        d, energy = diff * diff, target * target if relative else None
    else:
        raise ValueError(f"norm must be L1 or L2, got {norm}")
    if not relative:
        return d.mean()
    shards = mesh.batch_shards()
    if shards > 1:  # both means over the global batch
        sums = mesh.all_reduce_sum(torch.stack([d.sum(), energy.sum()]))
        n = d.numel() * shards
        return (sums[0] / n) / (sums[1] / n + 1e-12)
    return d.mean() / (energy.mean() + 1e-12)


def hinge_gan(score_real: torch.Tensor, score_fake: torch.Tensor):
    """(critic loss, generator loss) of the hinge GAN."""
    loss_dis = torch.mean(torch.relu(1 - score_real) + torch.relu(1 + score_fake))
    return loss_dis, -torch.mean(score_fake)


def ls_gan(score_real: torch.Tensor, score_fake: torch.Tensor):
    """(critic loss, generator loss) of the least-squares GAN."""
    loss_dis = torch.mean((score_real - 1) ** 2 + score_fake ** 2)
    return loss_dis, torch.mean((score_fake - 1) ** 2)


def nonsaturating_gan(score_real: torch.Tensor, score_fake: torch.Tensor):
    """(critic loss, generator loss) of the non-saturating GAN."""
    score_real = torch.clamp(torch.sigmoid(score_real), 1e-7, 1 - 1e-7)
    score_fake = torch.clamp(torch.sigmoid(score_fake), 1e-7, 1 - 1e-7)
    loss_dis = -torch.mean(torch.log(score_real) + torch.log(1 - score_fake))
    return loss_dis, -torch.mean(torch.log(score_fake))


GAN_LOSSES = {"hinge": hinge_gan, "ls": ls_gan, "nonsaturating": nonsaturating_gan}


def _as_tensor(v) -> torch.Tensor:
    """A float32 0-d tensor of a Python number (JAX's weak-typed float32)."""
    return v if torch.is_tensor(v) else torch.tensor(float(v), dtype=torch.float32)


def get_beta_kl(step, warmup, min_beta, max_beta) -> torch.Tensor:
    """Log-space beta-KL warmup from `min_beta` to `max_beta` over `warmup`
    steps, `max_beta` after (reference rave/core.py:129-135)."""
    step, min_beta, max_beta = _as_tensor(step), _as_tensor(min_beta), _as_tensor(max_beta)
    t = torch.clamp(step / warmup, 0.0, 1.0)
    beta = torch.exp(t * (torch.log(max_beta) - torch.log(min_beta)) + torch.log(min_beta))
    return torch.where(step > warmup, max_beta, beta)


def get_beta_kl_cyclic(step, cycle_size, min_beta, max_beta) -> torch.Tensor:
    return get_beta_kl(torch.remainder(_as_tensor(step), cycle_size), cycle_size // 2,
                       min_beta, max_beta)


def get_beta_kl_cyclic_annealed(step, cycle_size, warmup, min_beta, max_beta) -> torch.Tensor:
    return get_beta_kl_cyclic(step, cycle_size, get_beta_kl(step, warmup, min_beta, max_beta),
                              max_beta)
