"""The latent prior (port of rave_tpu/prior): `core` (quantizer, shift), `model`, `train`."""
from rave_tpu_torch.prior.core import DiagonalShift, QuantizedNormal
from rave_tpu_torch.prior.model import Prior

__all__ = ["Prior", "QuantizedNormal", "DiagonalShift"]
