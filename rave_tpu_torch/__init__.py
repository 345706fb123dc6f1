"""rave_tpu_torch — the PyTorch/CUDA port of rave_tpu.

The port works in PyTorch's channels-first layout: waveforms are
`[B, n_channels, T]` and latents `[B, D, T_lat]`. The JAX package
(`rave_tpu`, channels-last) is the numerical reference it is tested
against; this package imports nothing of it, and never jax or flax.

  - rave_tpu_torch.config  : the v2 / causal model configuration
  - rave_tpu_torch.ops     : PQMF filter design and analysis/synthesis;
                             the fused dilated residual unit kernel
  - rave_tpu_torch.nn      : dual-mode (offline / streaming) convolutions
                             with static delay algebra
  - rave_tpu_torch.models  : v2 encoder/generator blocks, PQMF modules, RAVE
  - rave_tpu_torch.factory : build_rave for the v2 serving path
  - rave_tpu_torch.utils   : weight bridge from rave_tpu parameter trees
"""
