"""Train state: the model, the critic, their two Adams, the step and the EMA.

PyTorch port of rave_tpu/train/state.py and the EMA of
rave_tpu/train/steps.py:231-236. The JAX package's generator transform is
optax's `scale_by_adam(b1, b2)` with the learning rate applied by the step
from the *global* step counter (discriminator steps included); its critic
transform is `optax.adam(dis_lr)`. `torch.optim.Adam` computes the same
update, lr * m_hat / (sqrt(v_hat) + 1e-8), so the generator's Adam has its
`lr` set before every step. Both start from zero moments.

What a step reads of the schedules lives on the device, as the JAX step
computes it inside its compiled program: `Schedule` holds the generator's
learning rate and the regularization weight beta as 0-d tensors that the
step's host work fills in place before each step, and the generator's Adam
takes its `lr` from there. On a card both Adams are `capturable`: their
step counts stay on the device and the update reads nothing back, so a
CUDA graph can hold the whole step (train/graphs.py). On the CPU they are
not (torch refuses `capturable` for CPU parameters).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from rave_tpu_torch.config import RaveConfig
from rave_tpu_torch.factory import build_discriminator, build_rave


@dataclass
class Schedule:
    """The schedules' values at the global step a step runs at, as 0-d
    float32 tensors on the state's device: the generator's learning rate and
    the regularization's weight beta. Written in place (`fill`), so a
    captured step reads each step's values from the same addresses."""

    gen_lr: torch.Tensor
    beta: torch.Tensor

    @classmethod
    def on(cls, device) -> "Schedule":
        return cls(*(torch.zeros((), dtype=torch.float32, device=device) for _ in range(2)))

    def fill(self, gen_lr: float, beta: float) -> None:
        self.gen_lr.fill_(gen_lr)
        self.beta.fill_(beta)


@dataclass
class TrainState:
    step: int
    model: nn.Module
    discriminator: nn.Module
    gen_opt: torch.optim.Adam
    dis_opt: torch.optim.Adam
    ema: Optional[Dict[str, torch.Tensor]] = None  # generator params, by name
    schedule: Optional[Schedule] = None  # create_train_state makes it on the model's device


def make_optimizers(cfg: RaveConfig, model: nn.Module, discriminator: nn.Module):
    """(generator Adam, critic Adam); the generator's lr is set per step.
    `capturable` on a card (the parameters' device), not on the CPU."""
    t = cfg.train
    betas = (t.adam_b1, t.adam_b2)
    capturable = next(model.parameters()).device.type == "cuda"
    gen = torch.optim.Adam(model.parameters(), lr=t.gen_lr, betas=betas, eps=1e-8,
                           capturable=capturable)
    dis = torch.optim.Adam(discriminator.parameters(), lr=t.dis_lr, betas=betas, eps=1e-8,
                           capturable=capturable)
    for opt in (gen, dis):  # the eager steps on a card run them uncaptured by design
        opt._warned_capturable_if_run_uncaptured = True
    return gen, dis


@torch.no_grad()
def update_ema(ema: Dict[str, torch.Tensor], model: nn.Module, decay: float) -> None:
    """ema <- ema * decay + params * (1 - decay), in that order of terms."""
    for name, p in model.named_parameters():
        ema[name].mul_(decay).add_(p, alpha=1 - decay)


def create_train_state(cfg: RaveConfig, n_channels: int = 1, seed: int = 0,
                       device: str | torch.device = "cuda") -> TrainState:
    """Seeded model (`seed`) and critic (`seed + 1`) on `device`, fresh
    optimizers, step 0, an EMA copy when `train.ema` is set, and the
    schedule's tensors."""
    model = build_rave(cfg, n_channels=n_channels, seed=seed, device=device)
    critic = build_discriminator(cfg, n_channels=n_channels, seed=seed + 1, device=device)
    gen_opt, dis_opt = make_optimizers(cfg, model, critic)
    ema = None
    if cfg.train.ema is not None:
        ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    return TrainState(0, model, critic, gen_opt, dis_opt, ema,
                      Schedule.on(next(model.parameters()).device))
