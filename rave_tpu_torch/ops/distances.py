"""The reconstruction distance of v2: AudioDistanceV1.

PyTorch port of rave_tpu/ops/distances.py:19-41 (reference
rave/core.py:322-344). The other distances are ROADMAP A11.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from rave_tpu_torch.ops.dsp import mean_difference
from rave_tpu_torch.ops.stft import MultiScaleSTFT


@dataclass(frozen=True)
class AudioDistanceV1:
    """Relative-L2 linear plus L1 log spectral distance, summed over scales."""

    multiscale_stft: MultiScaleSTFT
    log_epsilon: float = 1e-7

    def __call__(self, x: torch.Tensor, y: torch.Tensor) -> dict:
        distance = 0.0
        for a, b in zip(self.multiscale_stft(x), self.multiscale_stft(y)):
            lin = mean_difference(a, b, norm="L2", relative=True)
            log = mean_difference(torch.log(a + self.log_epsilon),
                                  torch.log(b + self.log_epsilon), norm="L1")
            distance = distance + lin + log
        return {"spectral_distance": distance}
