"""Training schedules as functions of the global step counter.

PyTorch port of rave_tpu/train/schedules.py (reference Lightning callbacks,
rave/model.py:45-113). The step counter is a host integer here, so these
return Python floats and bools; the JAX package evaluates the same formulas
in float32 inside its compiled step.
"""
from __future__ import annotations

import math
from typing import Callable, Optional


def beta_factor(step: int, initial: float, target: float, warmup_len: int,
                log_warmup: bool = True) -> float:
    """KL-weight ramp over `step + 1` (reference BetaWarmupCallback)."""
    t = min(max((step + 1) / max(warmup_len, 1), 0.0), 1.0)
    if log_warmup and initial > 0:
        beta = math.exp((1 - t) * math.log(initial) + t * math.log(target))
    else:
        beta = t * (target - initial) + initial
    return target if step + 1 >= warmup_len else beta


def warmed_up(step: int, phase_1_duration: int) -> bool:
    """The adversarial phase has begun (reference WarmupCallback)."""
    return step >= phase_1_duration


def quantize_enabled(step: int, warmup_quantize: Optional[int]) -> bool:
    """RVQ gate (reference QuantizeCallback): None never, -1 from the start."""
    return warmup_quantize is not None and step >= warmup_quantize


def gen_lr_schedule(base_lr: float, end_factor: float, warmup: int) -> Callable[[int], float]:
    """LinearLR 1.0 -> end_factor over phase 1, on the global step."""

    def sched(step: int) -> float:
        t = min(max(step / max(warmup, 1), 0.0), 1.0)
        return base_lr * (1.0 + t * (end_factor - 1.0))

    return sched
