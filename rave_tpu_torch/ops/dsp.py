"""Loss primitives of the training step: `mean_difference` and the GAN losses.

PyTorch port of rave_tpu/ops/dsp.py:59-110 (reference rave/core.py:151-170,
236-252). Every function reduces to a mean over all elements, so it is
indifferent to layout: the port's channels-first and folded critic feature
maps give the same values as the JAX package's channels-last ones.
"""
from __future__ import annotations

import torch


def mean_difference(target: torch.Tensor, value: torch.Tensor, norm: str = "L1",
                    relative: bool = False) -> torch.Tensor:
    """Mean L1/L2 difference, optionally relative to the target's energy."""
    diff = target - value
    if norm == "L1":
        d = diff.abs().mean()
        return d / (target.abs().mean() + 1e-12) if relative else d
    if norm == "L2":
        d = (diff * diff).mean()
        return d / ((target * target).mean() + 1e-12) if relative else d
    raise ValueError(f"norm must be L1 or L2, got {norm}")


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
