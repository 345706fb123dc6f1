"""Random streams: per-step generator seeds, and normal and uniform draws from a seed tensor.

The JAX package derives each step's randomness as `fold_in(key(seed), step)`,
so that a resumed run draws what an unbroken run would. The port does the
same with a `torch.Generator` seeded from `fold_in(seed, step)`: the seed
depends on (seed, step) alone, never on what was drawn before.

An exported artifact draws its sampling noise from a uint32 seed that is an
input of its step programs (rave_tpu/export/export.py:277-300). A
`torch.Generator` cannot be the input of a `torch.export` program, so
`normal_from_seed` is counter-based: each draw is an integer hash of
(seed, salt, index), computed with int64 tensor ops on 32-bit values (every
product splits its constant in 16-bit halves, so nothing overflows), then
Box-Muller in float64, rounded to float32. It is a function of its inputs
alone, the same on the CPU and the card up to the rounding of the float64
transform, and traces into an exported program as ordinary ops, so the
eager artifact and its `.pt2` programs draw the same numbers.
`uniform_from_seed` draws the noise synth's uniforms the same way, one
counter per draw, exact in float32 (24 bits over 2^24). `hash32` takes
a Python int, a numpy integer array or an int64 tensor alike.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

MASK32 = 0xFFFFFFFF


def fold_in(seed: int, step: int) -> int:
    """A 63-bit generator seed that depends on (seed, step) only."""
    hi, lo = np.random.SeedSequence([int(seed), int(step)]).generate_state(2, np.uint32)
    return (int(hi) & 0x7FFFFFFF) << 32 | int(lo)


def step_generator(seed: int, step: int, device: str | torch.device) -> torch.Generator:
    """A generator on `device` seeded from `fold_in(seed, step)`."""
    return torch.Generator(device=device).manual_seed(fold_in(seed, step))


def _mul32(x, c: int):
    """(x * c) mod 2^32 for 0 <= x < 2^32, exact in int64: c in 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def hash32(x):
    """lowbias32 (C. Wellons' integer hash) of 32-bit values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def uniform_bits(seed, salt: int, counter):
    """32 hashed bits per counter value, keyed by (seed, salt)."""
    key = hash32((seed & MASK32) ^ hash32(salt & MASK32))
    return hash32(hash32((counter + key) & MASK32) ^ key)


def _seed_tensor(seed, device) -> torch.Tensor:
    """`seed` as an int64 tensor. An int under a CUDA graph's capture would
    be recorded as a constant, every replay drawing the same numbers: the
    served steps (nn/graphs.py) pass their seed as a tensor, and this refuses."""
    if torch.is_tensor(seed):
        return seed
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("a seed drawn from under a CUDA graph's capture must be a tensor "
                           "(an int would be captured as a constant)")
    return torch.tensor(int(seed), dtype=torch.int64, device=device)


def normal_from_seed(seed: torch.Tensor | int, shape: Sequence[int], salt: int,
                     device: str | torch.device | None = None) -> torch.Tensor:
    """Standard normal float32 draws of `shape` from a uint32 `seed` (an int64
    tensor, or an int) and a constant `salt`: draw i uses the counters 2i and
    2i + 1 (Box-Muller)."""
    seed = _seed_tensor(seed, device)
    n = math.prod(shape)
    bits = uniform_bits(seed, salt, torch.arange(2 * n, dtype=torch.int64, device=seed.device))
    bits = (bits >> 8).double().reshape(n, 2)
    u1 = (bits[:, 0] + 0.5) / 2.0**24  # in (0, 1)
    u2 = bits[:, 1] / 2.0**24
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(2.0 * math.pi * u2)
    return z.float().reshape(tuple(shape))


def uniform_from_seed(seed: torch.Tensor | int, shape: Sequence[int], salt: int,
                      device: str | torch.device | None = None) -> torch.Tensor:
    """Uniform float32 draws in [0, 1) of `shape` from a uint32 `seed` (an int64
    tensor, or an int) and a constant `salt`: draw i uses the counter i."""
    seed = _seed_tensor(seed, device)
    n = math.prod(shape)
    bits = uniform_bits(seed, salt, torch.arange(n, dtype=torch.int64, device=seed.device))
    return ((bits >> 8).float() / 2.0**24).reshape(tuple(shape))
