"""Per-step random streams, the port's `jax.random.fold_in`.

The JAX package derives each step's randomness as `fold_in(key(seed), step)`,
so that a resumed run draws what an unbroken run would. The port does the
same with a `torch.Generator` seeded from `fold_in(seed, step)`: the seed
depends on (seed, step) alone, never on what was drawn before.
"""
from __future__ import annotations

import numpy as np
import torch


def fold_in(seed: int, step: int) -> int:
    """A 63-bit generator seed that depends on (seed, step) only."""
    hi, lo = np.random.SeedSequence([int(seed), int(step)]).generate_state(2, np.uint32)
    return (int(hi) & 0x7FFFFFFF) << 32 | int(lo)


def step_generator(seed: int, step: int, device: str | torch.device) -> torch.Generator:
    """A generator on `device` seeded from `fold_in(seed, step)`."""
    return torch.Generator(device=device).manual_seed(fold_in(seed, step))
